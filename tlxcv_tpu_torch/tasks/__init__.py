from .image_classification import ImageClassification
from .object_detection import ObjectDetection

__all__ = ["ImageClassification", "ObjectDetection"]
