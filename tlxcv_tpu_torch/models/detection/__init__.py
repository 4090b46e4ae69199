from .mask_rcnn import FPN, MaskHead, MaskRCNN, RPNHead, TwoFCHead
from .yolov3 import YOLOv3, YOLOv3FPN, YOLOv3Head

__all__ = ["FPN", "MaskHead", "MaskRCNN", "RPNHead", "TwoFCHead", "YOLOv3",
           "YOLOv3FPN", "YOLOv3Head"]
