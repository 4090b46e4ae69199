from .transform import (BPETokenizer, CharTokenizer, TrOCRTransform,
                        bytes_to_unicode, get_pairs, resize_linear)
from .trocr import TrOCR, TrOCRDecoder, ViTEncoder

__all__ = ["BPETokenizer", "CharTokenizer", "TrOCRTransform",
           "bytes_to_unicode", "get_pairs", "resize_linear", "TrOCR",
           "TrOCRDecoder", "ViTEncoder"]
