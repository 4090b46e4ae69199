"""Image resizes, NHWC (counterpart of ``tlxcv_tpu/ops/image.py``):
``interpolate`` in nearest and bilinear, and ``upsample_add``, the FPN
top-down pattern ``interpolate(x, size=skip.hw) + skip``.

``upsample_add`` hands every call that meets the fused kernel's contract
(an upsample, ``align_corners=False``, nearest or bilinear, f32 or bf16 in
one dtype) to ``ops.cuda.upsample.upsample_add_fused``: the hand-written
kernel for CUDA tensors, its plain version for CPU ones.  Any other call
takes the plain composition, as the reference's default path does.
``max_pool2d_with_argmax``, ``max_unpool2d``, ``unfold`` and ``pad2d``
come with the segmentation slices.
"""
from __future__ import annotations

import torch

from .cuda.upsample import apply_taps, resize_taps, upsample_add_fused

__all__ = ["interpolate", "resize", "upsample_add"]

_F32_BF16 = (torch.float32, torch.bfloat16)


def _out_size(in_hw, size, scale_factor):
    if size is not None:
        return tuple(int(s) for s in (
            size if isinstance(size, (tuple, list)) else (size, size)))
    if isinstance(scale_factor, (tuple, list)):
        sh, sw = scale_factor
    else:
        sh = sw = scale_factor
    return int(in_hw[0] * sh), int(in_hw[1] * sw)


def _nearest_index(in_size, out_size, device):
    """torch's legacy nearest rule, floor(i * in / out), in integers."""
    idx = (torch.arange(out_size, device=device) * in_size) // out_size
    return idx.clamp(0, in_size - 1)


def _linear_weights(in_size, out_size, align_corners, device):
    i = torch.arange(out_size, dtype=torch.float32, device=device)
    if align_corners and out_size > 1:
        src = i * (in_size - 1) / (out_size - 1)
    else:
        src = (i + 0.5) * in_size / out_size - 0.5
    src = src.clamp(0.0, in_size - 1)
    i0 = torch.floor(src).long()
    i1 = (i0 + 1).clamp_max(in_size - 1)
    return i0, i1, src - i0.float()


def _resize_axis_linear(x, out_size, axis, align_corners):
    """The reference's gather route: f32 weights, arithmetic in x's
    dtype."""
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    i0, i1, w1 = _linear_weights(in_size, out_size, align_corners, x.device)
    shape = [1] * x.ndim
    shape[axis] = out_size
    w1 = w1.reshape(shape).to(x.dtype)
    return x.index_select(axis, i0) * (1 - w1) \
        + x.index_select(axis, i1) * w1


def interpolate(x, size=None, scale_factor=None, mode="bilinear",
                align_corners=False):
    """NHWC resize with torch's ``F.interpolate`` coordinates, as the
    reference computes it on its default path:

    - nearest: ``src = floor(i * in / out)`` in integers;
    - bilinear, half-pixel, an integer upscale of an f32 or bf16 tensor:
      the reference's static-matrix route, each separable pass in f32 and
      rounded to x's dtype (``upsample2x_matmul`` / ``upsample_matmul``);
    - bilinear otherwise, either ``align_corners``: the gather route, f32
      weights applied in x's dtype.
    """
    h, w = x.shape[1:3]
    oh, ow = _out_size((h, w), size, scale_factor)
    if mode == "nearest":
        x = x.index_select(1, _nearest_index(h, oh, x.device))
        return x.index_select(2, _nearest_index(w, ow, x.device))
    if mode not in ("bilinear", "linear"):
        raise NotImplementedError(f"interpolate mode {mode!r} is not "
                                  f"ported (nearest and bilinear are)")
    if (not align_corners and x.ndim == 4 and oh > h and ow > w
            and oh % h == 0 and ow % w == 0 and x.dtype in _F32_BF16):
        y = apply_taps(x, 1, resize_taps(oh, h, "bilinear", x.device))
        y = apply_taps(y.to(x.dtype), 2,
                       resize_taps(ow, w, "bilinear", x.device))
        return y.to(x.dtype)
    x = _resize_axis_linear(x, oh, 1, align_corners)
    return _resize_axis_linear(x, ow, 2, align_corners)


resize = interpolate


def upsample_add(x, skip, mode="bilinear", align_corners=False):
    """``interpolate(x, size=skip.shape[1:3], mode=mode) + skip``.  A call
    within the fused kernel's contract goes to ``upsample_add_fused``
    (f32 accumulation, one rounding); any other takes the composition."""
    oh, ow = skip.shape[1:3]
    if (not align_corners and x.ndim == 4 and skip.ndim == 4
            and mode in ("bilinear", "nearest")
            and oh >= x.shape[1] and ow >= x.shape[2]
            and x.dtype in _F32_BF16 and x.dtype == skip.dtype):
        return upsample_add_fused(x, skip, mode=mode)
    return interpolate(x, size=(oh, ow), mode=mode,
                       align_corners=align_corners) + skip
