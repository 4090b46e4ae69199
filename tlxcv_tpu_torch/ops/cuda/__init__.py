"""Hand-written Hopper kernels, each beside its plain torch version."""
from .attention import flash_attention, flash_attention_plain
from .gather import gather_rows, gather_rows_bs, gather_rows_plain
from .matmul import (bf16_matmul, bf16_matmul_plain, int8_matmul,
                     int8_matmul_nt, int8_matmul_plain, int8_matmul_requant,
                     int8_matmul_requant_plain, requantize)
from .upsample import (sep_resize, upsample2x_fused, upsample2x_vjp,
                       upsample_add_fused, upsample_add_plain)

__all__ = ["launch_counters", "launch_counts", "reset_launches",
           "bf16_matmul", "bf16_matmul_plain", "flash_attention",
           "flash_attention_plain", "gather_rows", "gather_rows_bs",
           "gather_rows_plain", "int8_matmul", "int8_matmul_nt",
           "int8_matmul_plain", "int8_matmul_requant",
           "int8_matmul_requant_plain", "requantize", "upsample_add_fused",
           "upsample_add_plain"]


def launch_counters():
    """Every kernel wrapper that counts its launches, by kernel name."""
    from .attention import flash_attention_backward

    return {"flash_attention": flash_attention,
            "flash_attention_backward": flash_attention_backward,
            "int8_matmul": int8_matmul, "bf16_matmul": bf16_matmul,
            "gather_rows": gather_rows,
            "upsample_add_fused": upsample_add_fused,
            "sep_resize": sep_resize, "upsample2x_fused": upsample2x_fused,
            "upsample2x_vjp": upsample2x_vjp}


def reset_launches():
    for fn in launch_counters().values():
        fn.launches = 0
        if hasattr(fn, "f32_launches"):
            fn.f32_launches = 0


def launch_counts(f32=True):
    """Launches since the last reset, by kernel name; with ``f32``, the
    flash kernels' f32 (split-TF32) launches also under ``<name>_f32``."""
    out = {}
    for name, fn in launch_counters().items():
        out[name] = int(fn.launches)
        if f32 and hasattr(fn, "f32_launches"):
            out[f"{name}_f32"] = int(fn.f32_launches)
    return out
