from .cascade_rcnn import CascadeRCNN, cascade_rcnn_r50, faster_rcnn
from .centernet import CenterNet, centernet_r50
from .deform import DeformConv2d
from .detr import Detr, detr_resnet50
from .fcos import FCOS, FCOSHead, FPNP3P7, fcos_dcn_r50, fcos_r50
from .gfl import GFL, GFLHead, gfl_r50
from .mask_rcnn import FPN, MaskHead, MaskRCNN, RPNHead, TwoFCHead
from .picodet import PicoDet, picodet_lcnet
from .ppyoloe import (PPYOLOE, CSPResNet, CustomCSPPAN, PPYOLOEHead,
                      ppyoloe)
from .retinanet import RetinaNet, RetinaNetHead, retinanet_r50
from .solov2 import SOLOv2, solov2_r50
from .ssd import SSD, SSDHead
from .tood import TOOD, TOODHead, tood_r50
from .ttfnet import TTFNet, ttfnet_darknet53
from .yolov3 import YOLOv3, YOLOv3FPN, YOLOv3Head
from .yolox import SIZES as YOLOX_SIZES
from .yolox import YOLOX, yolox

__all__ = ["CSPResNet", "CascadeRCNN", "CenterNet", "CustomCSPPAN",
           "DeformConv2d", "Detr", "FCOS", "FCOSHead", "FPN", "FPNP3P7",
           "GFL", "GFLHead", "MaskHead", "MaskRCNN", "PPYOLOE",
           "PPYOLOEHead", "PicoDet", "RPNHead", "RetinaNet", "RetinaNetHead",
           "SOLOv2", "SSD", "SSDHead", "TOOD", "TOODHead", "TTFNet",
           "TwoFCHead", "YOLOX", "YOLOX_SIZES", "YOLOv3", "YOLOv3FPN",
           "YOLOv3Head", "cascade_rcnn_r50", "centernet_r50",
           "detr_resnet50", "faster_rcnn", "fcos_dcn_r50", "fcos_r50",
           "gfl_r50", "picodet_lcnet", "ppyoloe", "retinanet_r50",
           "solov2_r50", "tood_r50", "ttfnet_darknet53", "yolox"]
