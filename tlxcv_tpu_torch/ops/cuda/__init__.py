"""Hand-written Hopper kernels, each beside its plain torch version."""
from .attention import flash_attention, flash_attention_plain

__all__ = ["flash_attention", "flash_attention_plain"]
