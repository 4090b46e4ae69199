from .deform import DeformConv2d
from .detr import Detr, detr_resnet50
from .fcos import FCOS, FCOSHead, FPNP3P7, fcos_dcn_r50, fcos_r50
from .mask_rcnn import FPN, MaskHead, MaskRCNN, RPNHead, TwoFCHead
from .ppyoloe import (PPYOLOE, CSPResNet, CustomCSPPAN, PPYOLOEHead,
                      ppyoloe)
from .ssd import SSD, SSDHead
from .yolov3 import YOLOv3, YOLOv3FPN, YOLOv3Head

__all__ = ["CSPResNet", "CustomCSPPAN", "DeformConv2d", "Detr", "FCOS",
           "FCOSHead", "FPN", "FPNP3P7", "MaskHead",
           "MaskRCNN", "PPYOLOE", "PPYOLOEHead", "RPNHead", "SSD", "SSDHead",
           "TwoFCHead", "YOLOv3", "YOLOv3FPN", "YOLOv3Head", "detr_resnet50",
           "fcos_dcn_r50", "fcos_r50", "ppyoloe"]
