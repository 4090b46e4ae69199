from . import transforms
from .charades import Charades
from .loader import DataLoader, default_collate, device_prefetch
from .shapes_det import ShapesDetection, pad_targets
from .synth90k import Synth90k
from .vision import Dataset, StandardTransform, VisionDataset

__all__ = ["transforms", "Charades", "DataLoader", "default_collate",
           "device_prefetch", "ShapesDetection", "pad_targets", "Synth90k",
           "Dataset", "StandardTransform", "VisionDataset"]
