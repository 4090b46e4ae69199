from .image_classification import ImageClassification
from .image_segmentation import ImageSegmentation
from .object_detection import ObjectDetection

__all__ = ["ImageClassification", "ImageSegmentation", "ObjectDetection"]
