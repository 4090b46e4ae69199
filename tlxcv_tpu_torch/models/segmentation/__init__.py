from .bisenet import BiSeNetV2
from .deeplab import DeepLabV3, DeepLabV3P, deeplabv3, deeplabv3p
from .encnet import ENCNet
from .enet import ENet
from .fast_scnn import FastSCNN
from .fastfcn import FastFCN, fastfcn
from .hrnet_seg import FCN, HRNetW48Contrast, hrnet_seg_w18, hrnet_seg_w48
from .unet import Unet, unet

# the model factories, which the registry (``config.create_model``) lists:
# every lowercase factory the JAX package's segmentation module exports
MODELS = ["deeplabv3", "deeplabv3p", "fastfcn", "hrnet_seg_w18",
          "hrnet_seg_w48", "unet"]

__all__ = ["BiSeNetV2", "DeepLabV3", "DeepLabV3P", "ENCNet", "ENet",
           "FastSCNN", "FastFCN", "FCN", "HRNetW48Contrast", "Unet", *MODELS]
