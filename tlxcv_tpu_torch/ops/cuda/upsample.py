"""Separable resizes: the Hopper kernels' wrappers, their plain versions and
their gradients.

Two kernels replace the Pallas TPU kernels of
``tlxcv_tpu/ops/pallas/upsample.py``:

- ``csrc/upsample_add.cu``: ``upsample_add_fused`` :242, kernel
  ``_make_sep_kernel(with_skip=True)`` :117 via ``_apply_sep_matrices_add``
  :183 (the forward of the fused resize + add).
- ``csrc/sep_resize.cu``: ``_apply_sep_matrices`` :158 (pallas_call :164),
  the body of ``upsample_add_fused``'s backward (``_fused_up_add_bwd``
  :228) and of ``upsample2x_fused`` and its VJP (:275-299); through it the
  port also computes ``upsample2x_bilinear`` (:372, pallas_call :376), the
  same function.

Each source note says what bounds its kernel on the H100 and how its design
meets that.  The TPU's VMEM gates (``upsample_add_fits``,
``upsample2x_fits``) have no counterpart: the kernels take any size, and
their wrappers check what they need.

``upsample_add_fused(x, skip, mode)`` computes ``resize(x, skip.hw) +
skip`` for NHWC x ``[N, H, W, C]`` and skip ``[N, OH, OW, C]`` (OH >= H,
OW >= W), nearest or half-pixel bilinear, with the taps of the reference's
``_resize_matrix``; f32 or bf16, summed in f32 and rounded once to the
output dtype.  It is differentiable: ``d_skip = g`` and ``dx =
sep_resize(g, Ahᵀ, Awᵀ)``, as ``_fused_up_add_bwd``.  Every function here
takes the plain versions for CPU tensors; for CUDA tensors it launches the
kernels or raises, never falling back.
"""
from __future__ import annotations

import ctypes
import functools
import typing as tp

import numpy as np
import torch

from . import _build

__all__ = ["upsample_add_fused", "upsample_add_plain", "sep_resize",
           "sep_resize_plain", "sep_taps", "upsample2x_fused",
           "upsample2x_bilinear", "resize_matrix", "resize_taps",
           "apply_taps"]

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


class SepTaps(tp.NamedTuple):
    """The non-zeros of one separable matrix [rows, n_in], row by row."""
    ptr: torch.Tensor        # int32 [rows + 1]: CSR row pointer (kernel)
    src: torch.Tensor        # int32 [nnz]: source index of each tap
    weight: torch.Tensor     # f32 [nnz]
    pad_src: torch.Tensor    # int64 [rows, T]: the taps padded to T
    pad_weight: torch.Tensor  # f32 [rows, T]   (plain version)
    count: torch.Tensor      # int64 [rows]: taps of each row
    n_in: int


@functools.lru_cache(maxsize=64)
def sep_taps(n_out, n_in, mode, transposed, device):
    """``resize_matrix(n_out, n_in, mode)`` (``transposed``: its transpose,
    [n_in, n_out], the matrix of the gradient) as :class:`SepTaps` on
    ``device``, each row's taps in ascending source order.  A transposed
    row has as many taps as outputs read that source: 2 for nearest 2×, up
    to 4 for bilinear 2×, a varying number for 38 → 75.  Cached, since
    they are constants of the shapes."""
    a = resize_matrix(n_out, n_in, mode)
    if transposed:
        a = np.ascontiguousarray(a.T)
    rows, cols = np.nonzero(a)              # row-major: sources ascending
    count = np.bincount(rows, minlength=a.shape[0])
    ptr = np.concatenate([[0], np.cumsum(count)])
    t = max(int(count.max()), 1)
    pad_src = np.zeros((a.shape[0], t), np.int64)
    pad_w = np.zeros((a.shape[0], t), np.float32)
    slot = np.arange(len(rows)) - ptr[rows]
    pad_src[rows, slot] = cols
    pad_w[rows, slot] = a[rows, cols]

    def dev(arr, dtype):
        return torch.from_numpy(np.ascontiguousarray(arr, dtype)).to(device)

    return SepTaps(dev(ptr, np.int32), dev(cols, np.int32),
                   dev(a[rows, cols], np.float32), dev(pad_src, np.int64),
                   dev(pad_w, np.float32), dev(count, np.int64), a.shape[1])


def _apply_sep_axis(x, axis, taps):
    """``Σ_t x[src_t] · w_t`` along ``axis`` in f32, taps in CSR order,
    the sum started at 0: the kernel's order, one IEEE multiply and add per
    tap (rows past their own count keep their sum)."""
    shape = [1] * x.ndim
    shape[axis] = -1
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for t in range(taps.pad_src.shape[1]):
        term = (x.index_select(axis, taps.pad_src[:, t])
                * taps.pad_weight[:, t].reshape(shape))
        acc = torch.where((taps.count > t).reshape(shape), acc + term, acc)
    return acc


def sep_resize_plain(x, taps_h, taps_w):
    """The kernel's arithmetic in plain torch: rows (``taps_h``) then
    columns (``taps_w``) in f32, rounded once to x's dtype."""
    _check_sep(x, taps_h, taps_w)
    y = _apply_sep_axis(x.float(), 1, taps_h)
    return _apply_sep_axis(y, 2, taps_w).to(x.dtype)


def _check_sep(x, taps_h, taps_w):
    if x.ndim != 4:
        raise ValueError(f"x must be NHWC, got {tuple(x.shape)}")
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"x must be f32 or bf16, got {x.dtype}")
    if (taps_h.n_in, taps_w.n_in) != tuple(x.shape[1:3]):
        raise ValueError(f"taps read {taps_h.n_in}x{taps_w.n_in} pixels, x "
                         f"has {tuple(x.shape[1:3])}")
    for t in (taps_h, taps_w):
        if t.ptr.device != x.device:
            raise ValueError(f"taps on {t.ptr.device}, x on {x.device}")


def _vector_width(*ts):
    """Channels per thread: the widest of 16, 8, 4 bytes (or a single
    element) that divides C and every pointer and stride, with the
    channels contiguous."""
    if any(t.stride(3) != 1 for t in ts):
        return 1
    elt = ts[0].element_size()
    for vec in (16 // elt, 8 // elt, 4 // elt):
        if vec <= 1:
            continue
        if all(t.data_ptr() % (vec * elt) == 0
               and all(s % vec == 0 for s in t.stride()[:3])
               for t in ts) and ts[0].shape[3] % vec == 0:
            return vec
    return 1


def _lib_fn(lib, name, argtypes):
    fn = getattr(_build.library(lib), name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def _raise_on(rc, lib, what):
    if rc != 0:
        fn = getattr(_build.library(lib), f"tlx_{what}_error_string")
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{lib} kernel launch failed: "
                           f"{fn(rc).decode()} ({rc})")


def _cuda_only(name, x):
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    if max(x.shape) >= 2 ** 31:
        raise ValueError(f"dims of {tuple(x.shape)} exceed the kernel's "
                         f"32-bit sizes")


_P, _I = ctypes.c_void_p, ctypes.c_int


def sep_resize(x, taps_h, taps_w):
    """``out[n, i, j, c] = Σ Σ A[i, h] · B[j, w] · x[n, h, w, c]`` for the
    sparse matrices ``taps_h`` (A, from :func:`sep_taps`) and ``taps_w``
    (B): x [N, IH, IW, C] f32 or bf16 with any strides (a stride-0
    gradient included) -> a contiguous [N, OH, OW, C] tensor of x's dtype.
    Not differentiable itself: it is the body of the gradients below."""
    _check_sep(x, taps_h, taps_w)
    if x.device.type == "cpu":
        return sep_resize_plain(x, taps_h, taps_w)
    _cuda_only("sep_resize", x)
    n, _, _, c = x.shape
    oh, ow = taps_h.ptr.numel() - 1, taps_w.ptr.numel() - 1
    out = torch.empty((n, oh, ow, c), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 4)(*x.stride())
    fn = _lib_fn("sep_resize", "tlx_sep_resize",
                 [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                  _P])
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), out.data_ptr(), n, c, oh, ow, strides,
                taps_h.ptr.data_ptr(), taps_h.src.data_ptr(),
                taps_h.weight.data_ptr(), taps_w.ptr.data_ptr(),
                taps_w.src.data_ptr(), taps_w.weight.data_ptr(),
                _KERNEL_DTYPES[x.dtype], _vector_width(x, out),
                torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "sep_resize", "sep_resize")
    sep_resize.launches += 1
    return out


sep_resize.launches = 0  # kernel launches since the last reset


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


def _upsample_add_kernel(x, skip, mode):
    _cuda_only("upsample_add_fused", x)
    out = torch.empty(skip.shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    n, h, w, c = x.shape
    oh, ow = skip.shape[1:3]
    _cuda_only("upsample_add_fused", skip)
    strides = [(ctypes.c_longlong * 4)(*t.stride()) for t in (x, skip)]
    fn = _lib_fn("upsample_add", "tlx_upsample_add",
                 [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _I, _I, _I, _P])
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), skip.data_ptr(), out.data_ptr(), n, h, w, c,
                oh, ow, strides[0], strides[1], _MODES[mode],
                _KERNEL_DTYPES[x.dtype], _vector_width(x, skip, out),
                torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "upsample_add", "upsample")
    upsample_add_fused.launches += 1
    return out


class _UpsampleAdd(torch.autograd.Function):
    """``_fused_up_add`` with its VJP: the forward kernel (or its plain
    version on the CPU); backward ``dx = sep_resize(g, Ahᵀ, Awᵀ)``,
    ``d_skip = g``."""

    @staticmethod
    def forward(ctx, x, skip, mode):
        ctx.mode, ctx.in_hw = mode, tuple(x.shape[1:3])
        if x.device.type == "cpu":
            return upsample_add_plain(x, skip, mode)
        return _upsample_add_kernel(x, skip, mode)

    @staticmethod
    def backward(ctx, g):
        (ih, iw), (oh, ow) = ctx.in_hw, g.shape[1:3]
        dx = None
        if ctx.needs_input_grad[0]:
            dx = sep_resize(g, sep_taps(oh, ih, ctx.mode, True, g.device),
                            sep_taps(ow, iw, ctx.mode, True, g.device))
        return dx, g, None


def upsample_add_fused(x, skip, mode="bilinear"):
    """``resize(x, skip.shape[1:3]) + skip``: x [N, H, W, C], skip [N, OH,
    OW, C] with OH >= H and OW >= W, any strides; f32 or bf16, one dtype.
    Returns a contiguous [N, OH, OW, C] tensor of that dtype;
    differentiable in x and skip."""
    _check(x, skip, mode)
    return _UpsampleAdd.apply(x, skip, mode)


upsample_add_fused.launches = 0  # forward kernel launches since the last reset


class _Upsample2x(torch.autograd.Function):
    """``_fused_2x`` with its VJP: ``sep_resize`` with the 2× bilinear
    matrices forward and with their transposes backward."""

    @staticmethod
    def forward(ctx, x):
        h, w = x.shape[1:3]
        return sep_resize(x, sep_taps(2 * h, h, "bilinear", False, x.device),
                          sep_taps(2 * w, w, "bilinear", False, x.device))

    @staticmethod
    def backward(ctx, g):
        h, w = g.shape[1] // 2, g.shape[2] // 2
        return sep_resize(g, sep_taps(2 * h, h, "bilinear", True, g.device),
                          sep_taps(2 * w, w, "bilinear", True, g.device))


def upsample2x_fused(x):
    """2× half-pixel bilinear upsample, x [N, H, W, C] -> [N, 2H, 2W, C],
    f32 or bf16, differentiable (the reference's ``upsample2x_fused``)."""
    if x.ndim != 4:
        raise ValueError(f"x must be NHWC, got {tuple(x.shape)}")
    return _Upsample2x.apply(x)


# The reference's shift-and-interleave kernel computes the same function.
upsample2x_bilinear = upsample2x_fused
