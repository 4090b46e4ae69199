from .cd import (BIT, CDNet, DSAMNet, DSIFN, FCCDN, FCEarlyFusion, SNUNet,
                 STANet)
from .layers import (CBAM, ChannelAttention, Conv1x1, Conv3x3, Conv7x7,
                     ConvTransposed3x3, MaxPool2x2, SpatialAttention)
from .seg import DeepLabV3P, FarSeg, RSUNet

__all__ = ["BIT", "CDNet", "DSAMNet", "DSIFN", "FCCDN", "FCEarlyFusion",
           "SNUNet", "STANet", "DeepLabV3P", "FarSeg", "RSUNet", "CBAM",
           "ChannelAttention", "Conv1x1", "Conv3x3", "Conv7x7",
           "ConvTransposed3x3", "MaxPool2x2", "SpatialAttention"]
