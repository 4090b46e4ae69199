from .arcface import ArcFace, ArcHead, NormHead
from .retinaface import RetinaFace, hard_negatives, multi_box_loss

__all__ = ["ArcFace", "ArcHead", "NormHead", "RetinaFace", "hard_negatives",
           "multi_box_loss"]
