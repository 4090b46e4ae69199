from .classification import *  # noqa: F401,F403
from .classification import __all__ as _classification
from .facial_landmark_detection import PFLD
from .human_pose_estimation import PoseHighResolutionNet

__all__ = [*_classification, "PFLD", "PoseHighResolutionNet"]
