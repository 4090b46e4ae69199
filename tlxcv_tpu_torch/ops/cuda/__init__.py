"""Hand-written Hopper kernels, each beside its plain torch version."""
from .attention import flash_attention, flash_attention_plain
from .matmul import int8_matmul, int8_matmul_nt, int8_matmul_plain

__all__ = ["flash_attention", "flash_attention_plain", "int8_matmul",
           "int8_matmul_nt", "int8_matmul_plain"]
