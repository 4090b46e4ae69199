from .attention import (Attention, MultiHeadAttention,
                        scaled_dot_product_attention, use_int8_attention)
from .layers import (Activation, AdaptiveAvgPool2d, AvgPool2d, AvgPool3d,
                     BatchNorm, BatchNorm2d, Conv2d, Conv3d, ConvTranspose2d,
                     Dropout, DropPath, Embedding, GlobalAvgPool2d, GroupNorm,
                     Identity, LayerNorm, Linear, MaxPool2d, MaxPool3d, PReLU,
                     Sequential, get_activation, leaky_relu, relu)

__all__ = ["Attention", "MultiHeadAttention", "scaled_dot_product_attention",
           "use_int8_attention",
           "Activation", "AdaptiveAvgPool2d", "AvgPool2d", "AvgPool3d",
           "BatchNorm", "BatchNorm2d", "Conv2d", "Conv3d", "ConvTranspose2d",
           "Dropout", "DropPath", "Embedding", "GlobalAvgPool2d", "GroupNorm",
           "Identity", "LayerNorm", "Linear", "MaxPool2d", "MaxPool3d",
           "PReLU", "Sequential", "get_activation", "leaky_relu", "relu"]
