"""Hand-written Hopper kernels, each beside its plain torch version."""
from .attention import flash_attention, flash_attention_plain
from .gather import gather_rows, gather_rows_bs, gather_rows_plain
from .matmul import (bf16_matmul, bf16_matmul_plain, int8_matmul,
                     int8_matmul_nt, int8_matmul_plain, int8_matmul_requant,
                     int8_matmul_requant_plain, requantize)
from .upsample import upsample_add_fused, upsample_add_plain

__all__ = ["bf16_matmul", "bf16_matmul_plain", "flash_attention",
           "flash_attention_plain", "gather_rows", "gather_rows_bs",
           "gather_rows_plain", "int8_matmul", "int8_matmul_nt",
           "int8_matmul_plain", "int8_matmul_requant",
           "int8_matmul_requant_plain", "requantize", "upsample_add_fused",
           "upsample_add_plain"]
