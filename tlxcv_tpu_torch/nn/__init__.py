from .attention import (Attention, MultiHeadAttention,
                        scaled_dot_product_attention)
from .layers import (Conv2d, Dropout, DropPath, Identity, LayerNorm, Linear,
                     get_activation)

__all__ = ["Attention", "MultiHeadAttention", "scaled_dot_product_attention",
           "Conv2d", "Dropout", "DropPath", "Identity", "LayerNorm", "Linear",
           "get_activation"]
