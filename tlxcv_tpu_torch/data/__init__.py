from . import det_transforms, landmark_transforms, transforms
from .casiawebface import CasiaWebFace
from .charades import Charades
from .cifar import Cifar10
from .circles import Circles
from .coco import CocoDetection, CocoHumanPoseEstimation, CocoIndex
from .face300w import Face300W
from .loader import DataLoader, default_collate, device_prefetch
from .shapes_det import ShapesDetection, pad_targets
from .synth90k import Synth90k
from .vision import Dataset, StandardTransform, VisionDataset
from .wider import Wider

__all__ = ["transforms", "det_transforms", "landmark_transforms",
           "CasiaWebFace", "Charades", "Cifar10", "Circles",
           "ShapesDetection", "pad_targets", "CocoDetection",
           "CocoHumanPoseEstimation", "CocoIndex", "Face300W", "DataLoader",
           "device_prefetch", "default_collate", "Synth90k", "Dataset",
           "StandardTransform", "VisionDataset", "Wider"]
