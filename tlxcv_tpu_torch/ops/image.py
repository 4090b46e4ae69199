"""Image resizes, NHWC (counterpart of ``tlxcv_tpu/ops/image.py``):
``interpolate`` in nearest and bilinear, and ``upsample_add``, the FPN
top-down pattern ``interpolate(x, size=skip.hw) + skip``.

``upsample_add`` hands every call that meets the fused kernel's contract
(an upsample, ``align_corners=False``, nearest or bilinear, f32 or bf16 in
one dtype) to ``ops.cuda.upsample.upsample_add_fused``, on the CPU too: an
autograd Function whose forward is the hand-written kernel for CUDA
tensors (its plain version for CPU ones) and whose backward is the
transposed resize kernel (its plain version).  Any other call takes the
plain composition, as the reference's default path does.

``interpolate(mode="bicubic")`` is the reference's ``jax.image.resize(...,
"cubic")``: Keys' kernel with a = -0.5, antialiased when downscaling, which
is not ``F.interpolate``'s bicubic (a = -0.75, no antialias);
``resize_linear`` is its ``"bilinear"``, likewise antialiased.
``max_pool2d_with_argmax`` and ``max_unpool2d`` are ENet's pair; ``unfold``
is RedNet's im2col; ``pad2d`` comes with the slice that needs it.
"""
from __future__ import annotations

import torch

from .cuda.upsample import apply_taps, resize_taps, upsample_add_fused

__all__ = ["interpolate", "resize", "resize_linear", "upsample_add",
           "max_pool2d_with_argmax", "max_unpool2d", "unfold"]

_F32_BF16 = (torch.float32, torch.bfloat16)


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


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


def _keys_cubic(t):
    """Keys' cubic convolution kernel, a = -0.5, of |distance| ``t``."""
    out = ((1.5 * t - 2.5) * t) * t + 1.0
    out = torch.where(t >= 1.0, ((-0.5 * t + 2.5) * t - 4.0) * t + 2.0, out)
    return torch.where(t >= 2.0, 0.0, out)


def _triangle(t):
    """The linear kernel, max(0, 1 - |t|)."""
    return torch.clamp_min(1.0 - t.abs(), 0.0)


def _resize_matrix(in_size, out_size, kernel, device):
    """[in, out] f32 weights of ``jax.image.resize`` along one axis:
    half-pixel centres, the kernel widened by in/out when downscaling
    (antialias), each column normalised to sum 1, zero where the sample
    falls outside the input."""
    inv_scale = torch.tensor(1.0 / (out_size / in_size), dtype=torch.float32)
    kernel_scale = torch.clamp_min(inv_scale, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float32) + 0.5) \
        * inv_scale - 0.5
    dist = (sample[None, :] - torch.arange(in_size, dtype=torch.float32)[
        :, None]).abs() / kernel_scale
    weights = kernel(dist)
    total = weights.sum(0, keepdim=True)
    weights = torch.where(
        total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
        weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0).to(device)


def _separable(x, sizes, kernel):
    """``jax.image.resize`` with ``kernel`` over the axes of ``sizes``
    ({axis: out}; an axis of unchanged size is left as it is): a product
    per resized axis, the weights rounded to x's dtype, the products in
    f32 (f64 for f64), one rounding."""
    acc = torch.promote_types(x.dtype, torch.float32)
    y = x.to(acc)
    for axis, n in sizes.items():
        if y.shape[axis] != n:
            m = _resize_matrix(y.shape[axis], n, kernel,
                               x.device).to(x.dtype).to(acc)
            y = torch.tensordot(y, m, dims=([axis], [0])).movedim(-1, axis)
    return y.to(x.dtype)


def _bicubic(x, oh, ow):
    """The reference's ``jax.image.resize(x, ..., "cubic")``."""
    return _separable(x, {1: oh, 2: ow}, _keys_cubic)


def resize_linear(x, hw, axes=(1, 2)):
    """``jax.image.resize(x, ..., "bilinear")`` to ``hw`` over ``axes``
    (NHWC's H and W by default): the triangle kernel, antialiased when it
    shrinks (widened by in/out, as ``F.interpolate(..., antialias=True)``
    is not at every factor), half-pixel centres."""
    return _separable(x, dict(zip(axes, hw)), _triangle)


def interpolate(x, size=None, scale_factor=None, mode="bilinear",
                align_corners=False, fast_path=True):
    """NHWC resize with torch's ``F.interpolate`` coordinates, as the
    reference computes it on its default path:

    - nearest: ``src = floor(i * in / out)`` in integers;
    - bilinear, half-pixel, an integer upscale of an f32 or bf16 tensor:
      the reference's static-matrix route, each separable pass in f32 and
      rounded to x's dtype (``upsample2x_matmul`` / ``upsample_matmul``);
      ``fast_path=False`` takes the gather route instead, as the
      reference's keyword does;
    - bilinear otherwise, either ``align_corners``: the gather route, f32
      weights applied in x's dtype (an axis of unchanged size is returned
      as it is);
    - bicubic: ``jax.image.resize``'s cubic (``_bicubic``), half-pixel
      centres whatever ``align_corners``, as the reference's.
    """
    h, w = x.shape[1:3]
    oh, ow = _out_size((h, w), size, scale_factor)
    if mode == "nearest":
        x = x.index_select(1, _nearest_index(h, oh, x.device))
        return x.index_select(2, _nearest_index(w, ow, x.device))
    if mode == "bicubic":
        return _bicubic(x, oh, ow)
    if mode not in ("bilinear", "linear"):
        raise ValueError(f"unknown interpolate mode {mode!r}")
    if (fast_path and not align_corners and x.ndim == 4 and oh > h
            and ow > w and oh % h == 0 and ow % w == 0
            and x.dtype in _F32_BF16):
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


def max_pool2d_with_argmax(x, kernel_size, stride=None, padding=0):
    """Window max of NHWC ``x`` and, per (n, c), the flat ``H*W`` index of
    the element it took (int32), as the reference's reduce_window over
    (value, index) pairs: an element replaces the running one only when
    strictly greater, so ties go to the first in the window's row-major
    order, which is ``torch.argmax``'s documented "first maximal value".
    Padding holds the dtype's least finite value and never wins a window
    that holds a real element above it."""
    kh, kw = _pair(kernel_size)
    sh, sw = (kh, kw) if stride is None else _pair(stride)
    ph, pw = _pair(padding)
    n, h, w, c = x.shape
    ho = (h + 2 * ph - kh) // sh + 1
    wo = (w + 2 * pw - kw) // sw + 1
    least = (torch.finfo(x.dtype).min if x.is_floating_point()
             else torch.iinfo(x.dtype).min)
    xp = torch.nn.functional.pad(x, (0, 0, pw, pw, ph, ph), value=least)
    windows = torch.stack(
        [xp[:, i:i + (ho - 1) * sh + 1:sh, j:j + (wo - 1) * sw + 1:sw]
         for i in range(kh) for j in range(kw)], -1)  # [N, Ho, Wo, C, k]
    pick = windows.argmax(-1)
    values = windows.gather(-1, pick[..., None])[..., 0]
    di = torch.div(pick, kw, rounding_mode="floor")
    rows = torch.arange(ho, device=x.device)[:, None, None] * sh - ph + di
    cols = torch.arange(wo, device=x.device)[None, :, None] * sw - pw \
        + pick - di * kw
    return values, (rows * w + cols).to(torch.int32)


def max_unpool2d(x, indices, output_hw):
    """Scatter NHWC pooled values to their flat ``H*W`` indices, per (n,
    c), into zeros of ``output_hw``, as the reference's ``.at[].set(...,
    mode="drop")``: a negative index counts from the end, one outside
    ``[-H*W, H*W)`` is dropped."""
    n, h, w, c = x.shape
    oh, ow = output_hw
    size = oh * ow
    idx = indices.reshape(n, h * w, c).long()
    idx = torch.where(idx < 0, idx + size, idx)
    idx = torch.where((idx >= 0) & (idx < size), idx, size)
    out = x.new_zeros(n, size + 1, c)  # the last row takes the drops
    out.scatter_(1, idx, x.reshape(n, h * w, c))
    return out[:, :size].reshape(n, oh, ow, c)



def unfold(x, kernel_size, stride=1, padding=0, dilation=1):
    """im2col of NHWC ``x``: ``[N, L, C*kh*kw]`` patches and the output's
    ``(oh, ow)``.  Within a patch the values are channel-major, (c, i, j),
    as the reference's ``lax.conv_general_dilated_patches`` (and torch's
    ``F.unfold``) order them; Involution (RedNet) reshapes by that order."""
    k, s, p, d = (_pair(v) for v in (kernel_size, stride, padding, dilation))
    n, h, w, _ = x.shape
    oh = (h + 2 * p[0] - d[0] * (k[0] - 1) - 1) // s[0] + 1
    ow = (w + 2 * p[1] - d[1] * (k[1] - 1) - 1) // s[1] + 1
    cols = torch.nn.functional.unfold(x.permute(0, 3, 1, 2), k, d, p, s)
    return cols.transpose(1, 2), (oh, ow)
