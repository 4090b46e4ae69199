"""Fused resize + add: the Hopper kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``tlxcv_tpu/ops/pallas/upsample.py``
(``upsample_add_fused`` :242, kernel ``_make_sep_kernel(with_skip=True)``
:117 via ``_apply_sep_matrices_add`` :183), forward only: its VJP waits
for the training slice.  The kernel is ``csrc/upsample_add.cu``; its
source note says what bounds it on the H100 and how its design meets that.
The TPU's VMEM gate ``upsample_add_fits`` has no counterpart: the kernel
takes any size, and its wrapper checks what it needs.

``upsample_add_fused(x, skip, mode)`` computes ``resize(x, skip.hw) +
skip`` for NHWC x ``[N, H, W, C]`` and skip ``[N, OH, OW, C]`` (OH >= H,
OW >= W), nearest or half-pixel bilinear, with the taps of the
reference's ``_resize_matrix``; f32 or bf16, summed in f32 and rounded
once to the output dtype.  It takes the plain version for CPU tensors;
for CUDA tensors it launches the kernel or raises, never falling back.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

__all__ = ["upsample_add_fused", "upsample_add_plain", "resize_matrix",
           "resize_taps", "apply_taps"]

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MODES = {"nearest": 0, "bilinear": 1}


def resize_matrix(n_out, n_in, mode="bilinear"):
    """[n_out, n_in] separable interpolation matrix, float32 (the
    reference's ``ops/pallas/upsample.py:_resize_matrix``).  bilinear:
    half-pixel centres (align_corners=False), source in float64, both taps
    clamped to the edge, the far tap's weight 0 for a source below 0.
    nearest: ``src = (i * n_in) // n_out`` in integers (torch's legacy
    rule)."""
    a = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    if mode == "nearest":
        idx = np.clip((rows * n_in) // n_out, 0, n_in - 1)
        a[rows, idx] = 1.0
        return a
    src = (rows + 0.5) * n_in / n_out - 0.5
    i0 = np.clip(np.floor(src).astype(int), 0, n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    w1 = np.clip(src - np.floor(src), 0, 1)
    w1 = np.where(src < 0, 0.0, w1)
    a[rows, i0] += 1 - w1
    a[rows, i1] += w1
    return a


@functools.lru_cache(maxsize=64)
def resize_taps(n_out, n_in, mode, device):
    """Each row of :func:`resize_matrix` as its two taps ``(i0, i1, a0,
    a1)``, tensors on ``device``; ``a1 = 0`` where both taps fall on one
    source.  Cached, since they are constants of the shapes."""
    a = resize_matrix(n_out, n_in, mode)
    rows = np.arange(n_out)
    if mode == "nearest":
        i0 = i1 = np.clip((rows * n_in) // n_out, 0, n_in - 1)
    else:
        src = (rows + 0.5) * n_in / n_out - 0.5
        i0 = np.clip(np.floor(src).astype(int), 0, n_in - 1)
        i1 = np.minimum(i0 + 1, n_in - 1)
    a1 = np.where(i1 != i0, a[rows, i1], 0.0).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(t)).to(device)
                 for t in (i0.astype(np.int64), i1.astype(np.int64),
                           a[rows, i0], a1))


def apply_taps(x, axis, taps):
    """One separable pass along ``axis``, in f32: ``x[i0]·a0 + x[i1]·a1``."""
    i0, i1, a0, a1 = taps
    shape = [1] * x.ndim
    shape[axis] = -1
    x = x.float()
    return (x.index_select(axis, i0) * a0.reshape(shape)
            + x.index_select(axis, i1) * a1.reshape(shape))


def _check(x, skip, mode):
    if mode not in _MODES:
        raise ValueError(f"mode must be nearest or bilinear, got {mode!r}")
    if x.ndim != 4 or skip.ndim != 4:
        raise ValueError(f"x and skip must be NHWC, got {tuple(x.shape)} "
                         f"and {tuple(skip.shape)}")
    (n, h, w, c), (sn, oh, ow, sc) = x.shape, skip.shape
    if (sn, sc) != (n, c) or oh < h or ow < w:
        raise ValueError(f"skip {tuple(skip.shape)} must upsample x "
                         f"{tuple(x.shape)}: same N and C, OH >= H, OW >= W")
    if x.dtype not in _KERNEL_DTYPES or skip.dtype != x.dtype:
        raise ValueError(f"x and skip must share f32 or bf16, got "
                         f"{x.dtype} and {skip.dtype}")
    if x.device != skip.device:
        raise ValueError(f"x on {x.device}, skip on {skip.device}")


def upsample_add_plain(x, skip, mode="bilinear"):
    """The kernel's arithmetic in plain torch: rows then columns in f32
    through the ``_resize_matrix`` taps (nearest: a plain index), plus
    skip in f32, rounded once to the dtype."""
    _check(x, skip, mode)
    (h, w), (oh, ow) = x.shape[1:3], skip.shape[1:3]
    if mode == "nearest":
        i, j = (resize_taps(o, n, mode, x.device)[0]
                for o, n in ((oh, h), (ow, w)))
        up = x.float().index_select(1, i).index_select(2, j)
    else:
        up = apply_taps(x, 1, resize_taps(oh, h, mode, x.device))
        up = apply_taps(up, 2, resize_taps(ow, w, mode, x.device))
    return (up + skip.float()).to(x.dtype)


def _vector_width(x, skip, out):
    """Channels per thread: the widest of 16, 8, 4 bytes (or a single
    element) that divides C and every pointer and stride, with the
    channels contiguous."""
    if x.stride(3) != 1 or skip.stride(3) != 1:
        return 1
    elt = x.element_size()
    for vec in (16 // elt, 8 // elt, 4 // elt):
        if vec <= 1:
            continue
        if all(t.data_ptr() % (vec * elt) == 0
               and all(s % vec == 0 for s in t.stride()[:3])
               for t in (x, skip, out)) and x.shape[3] % vec == 0:
            return vec
    return 1


def _kernel_fn():
    fn = _build.library("upsample_add").tlx_upsample_add
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, i, i, p, p, i, i, i, p]
        fn.restype = i
    return fn


def _error_string(rc):
    fn = _build.library("upsample_add").tlx_upsample_error_string
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
    return fn(rc).decode()


def upsample_add_fused(x, skip, mode="bilinear"):
    """``resize(x, skip.shape[1:3]) + skip``: x [N, H, W, C], skip [N, OH,
    OW, C] with OH >= H and OW >= W, any strides; f32 or bf16, one dtype.
    Returns a contiguous [N, OH, OW, C] tensor of that dtype."""
    _check(x, skip, mode)
    if x.device.type == "cpu":
        return upsample_add_plain(x, skip, mode)
    if x.device.type != "cuda":
        raise ValueError(f"upsample_add_fused runs on CUDA or CPU tensors, "
                         f"got {x.device}")
    out = torch.empty(skip.shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    n, h, w, c = x.shape
    oh, ow = skip.shape[1:3]
    if max(x.shape + skip.shape) >= 2 ** 31:
        raise ValueError(f"dims of {tuple(x.shape)} / {tuple(skip.shape)} "
                         f"exceed the kernel's 32-bit sizes")
    strides = [(ctypes.c_longlong * 4)(*t.stride()) for t in (x, skip)]
    with torch.cuda.device(x.device):
        rc = _kernel_fn()(x.data_ptr(), skip.data_ptr(), out.data_ptr(),
                          n, h, w, c, oh, ow, strides[0], strides[1],
                          _MODES[mode], _KERNEL_DTYPES[x.dtype],
                          _vector_width(x, skip, out),
                          torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"upsample_add kernel launch failed: "
                           f"{_error_string(rc)} ({rc})")
    upsample_add_fused.launches += 1
    return out


upsample_add_fused.launches = 0  # kernel launches since the last reset
