from .detr import Detr, detr_resnet50
from .mask_rcnn import FPN, MaskHead, MaskRCNN, RPNHead, TwoFCHead
from .ppyoloe import (PPYOLOE, CSPResNet, CustomCSPPAN, PPYOLOEHead,
                      ppyoloe)
from .ssd import SSD, SSDHead
from .yolov3 import YOLOv3, YOLOv3FPN, YOLOv3Head

__all__ = ["CSPResNet", "CustomCSPPAN", "Detr", "FPN", "MaskHead",
           "MaskRCNN", "PPYOLOE", "PPYOLOEHead", "RPNHead", "SSD", "SSDHead",
           "TwoFCHead", "YOLOv3", "YOLOv3FPN", "YOLOv3Head", "detr_resnet50",
           "ppyoloe"]
