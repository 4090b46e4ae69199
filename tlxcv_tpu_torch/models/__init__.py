from .classification import *  # noqa: F401,F403
from .classification import __all__ as _classification
from . import face_recognition
from .face_recognition import ArcFace, RetinaFace
from .facial_landmark_detection import PFLD
from .human_pose_estimation import PoseHighResolutionNet
from .ocr import TrOCR
from .video_classification import InceptionI3d

__all__ = [*_classification, "ArcFace", "RetinaFace", "face_recognition",
           "PFLD", "PoseHighResolutionNet", "TrOCR", "InceptionI3d"]
