from .distillation import DistilledClassification, teacher_labels
from .facial_landmark_detection import NME, FacialLandmarkDetection
from .human_pose_estimation import (PCK, GenerateTarget, HumanPoseEstimation,
                                    generate_heatmap_target, get_max_preds)
from .image_classification import ImageClassification
from .image_segmentation import ImageSegmentation
from .object_detection import ObjectDetection
from .ocr import OpticalCharacterRecognition, character_error_rate
from .video_classification import VideoClassification
from . import face_recognition

__all__ = ["DistilledClassification", "teacher_labels", "NME",
           "FacialLandmarkDetection", "PCK", "GenerateTarget",
           "HumanPoseEstimation", "generate_heatmap_target", "get_max_preds",
           "ImageClassification", "ImageSegmentation", "ObjectDetection",
           "OpticalCharacterRecognition", "character_error_rate",
           "VideoClassification", "face_recognition"]
