from .cd import BIT
from .layers import (CBAM, ChannelAttention, Conv1x1, Conv3x3, Conv7x7,
                     ConvTransposed3x3, MaxPool2x2, SpatialAttention)

__all__ = ["BIT", "CBAM", "ChannelAttention", "Conv1x1", "Conv3x3",
           "Conv7x7", "ConvTransposed3x3", "MaxPool2x2", "SpatialAttention"]
