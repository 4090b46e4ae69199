from .facial_landmark_detection import NME, FacialLandmarkDetection
from .human_pose_estimation import (PCK, GenerateTarget, HumanPoseEstimation,
                                    generate_heatmap_target, get_max_preds)
from .image_classification import ImageClassification
from .image_segmentation import ImageSegmentation
from .object_detection import ObjectDetection
from . import face_recognition

__all__ = ["NME", "FacialLandmarkDetection", "PCK", "GenerateTarget",
           "HumanPoseEstimation", "generate_heatmap_target", "get_max_preds",
           "ImageClassification", "ImageSegmentation", "ObjectDetection",
           "face_recognition"]
