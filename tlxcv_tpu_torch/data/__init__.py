from . import transforms
from .loader import DataLoader, default_collate, device_prefetch
from .shapes_det import ShapesDetection, pad_targets
from .vision import Dataset, StandardTransform, VisionDataset

__all__ = ["transforms", "DataLoader", "default_collate", "device_prefetch",
           "ShapesDetection", "pad_targets", "Dataset", "StandardTransform",
           "VisionDataset"]
