"""Separable resizes: the Hopper kernels' wrappers, their plain versions and
their gradients.

Three kernel sources replace the Pallas TPU kernels of
``tlxcv_tpu/ops/pallas/upsample.py``:

- ``csrc/upsample_add.cu``: ``upsample_add_fused`` :242, kernel
  ``_make_sep_kernel(with_skip=True)`` :117 via ``_apply_sep_matrices_add``
  :183 (the forward of the fused resize + add).
- ``csrc/sep_resize.cu``: ``_apply_sep_matrices`` :158 (pallas_call :164)
  as the body of ``upsample_add_fused``'s backward (``_fused_up_add_bwd``
  :228), a generic separable resize by sparse matrices.
- ``csrc/upsample2x.cu``: the same ``_apply_sep_matrices`` as the body of
  ``upsample2x_fused`` (:303) and its VJP (``_fused_2x_bwd`` :288), and
  ``upsample2x_bilinear`` (:372, pallas_call :376), the same function: a
  forward and a VJP kernel that work the 2× taps out from the output index
  and reuse each vertical sum, bitwise equal to ``sep_resize_plain`` on the
  2× taps.

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
kernels or raises, never falling back.  The forward entries are operators
of ``library`` (``tlxcv::upsample_add``, ``tlxcv::upsample2x``), which
``torch.export`` records.

Rounding contract: every result here, forward and gradient, sums its taps
(and the skip) in f32 and rounds once to the output dtype.  In bf16 that is
a documented divergence from the reference, which has no single bf16
answer: its Pallas kernels round between their two passes and before the
add (weights cast to bf16), its ``upsample2x_bilinear`` rounds each bf16
op, and its default XLA route rounds elsewhere again.  The port stays
within 2^-5 of the largest magnitude of each route
(``tests/test_torch_train_ops.py``, ``*_is_a_documented_divergence``); the
nearest forward is bitwise equal to both.
"""
from __future__ import annotations

import ctypes
import functools
import typing as tp

import numpy as np
import torch

from . import _build
from .library import check_device, define, needs_grad

__all__ = ["upsample_add_fused", "upsample_add_plain", "sep_resize",
           "sep_resize_plain", "sep_taps", "upsample2x_fused",
           "upsample2x_bilinear", "upsample2x_plain", "upsample2x_vjp",
           "upsample2x_vjp_plain", "resize_matrix", "resize_taps",
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
    # made outside inference mode: a first call under inference_mode would
    # cache inference tensors, which a later training forward cannot save
    with torch.inference_mode(False):
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

    def dev(arr, dtype):  # outside inference mode, as resize_taps
        with torch.inference_mode(False):
            return torch.from_numpy(np.ascontiguousarray(arr, dtype)).to(
                device)

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


upsample_add_op = define(
    "upsample_add(Tensor x, Tensor skip, str mode) -> Tensor",
    upsample_add_plain, _upsample_add_kernel,
    lambda x, skip, mode: x.new_empty(skip.shape))


class _UpsampleAdd(torch.autograd.Function):
    """``_fused_up_add`` with its VJP: the forward operator (the kernel, or
    its plain version on the CPU); backward ``dx = sep_resize(g, Ahᵀ,
    Awᵀ)``, ``d_skip = g``."""

    @staticmethod
    def forward(ctx, x, skip, mode):
        ctx.mode, ctx.in_hw = mode, tuple(x.shape[1:3])
        return upsample_add_op(x, skip, mode)

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
    Returns a contiguous [N, OH, OW, C] tensor of that dtype, summed in f32
    and rounded once; differentiable in x and skip (the x-gradient also
    summed in f32 and rounded once)."""
    _check(x, skip, mode)
    check_device("upsample_add_fused", x)
    if needs_grad(x, skip):
        return _UpsampleAdd.apply(x, skip, mode)
    return upsample_add_op(x, skip, mode)


upsample_add_fused.launches = 0  # forward kernel launches since the last reset


def _rule_2x(n):
    """The 2× taps that ``csrc/upsample2x.cu`` works out from the output
    index, as the dense [2n, n] matrix: output row 2k reads x[k-1]·0.25 +
    x[k]·0.75 (row 0: x[0]·1), row 2k+1 x[k]·0.75 + x[k+1]·0.25 (row 2n-1:
    x[n-1]·1); the VJP reads its transpose."""
    a = np.zeros((2 * n, n), np.float32)
    k = np.arange(n)
    a[2 * k, k] = 0.75
    a[2 * k[1:], k[:-1]] = 0.25
    a[2 * k + 1, k] = 0.75
    a[2 * k[:-1] + 1, k[:-1] + 1] = 0.25
    a[0, 0] = a[2 * n - 1, n - 1] = 1.0
    return a


@functools.lru_cache(maxsize=64)
def _check_2x_taps(n):
    """The kernels' taps for size n are the non-zeros of
    ``resize_matrix(2n, n)``, which the plain version reads; checked once
    per size."""
    if not np.array_equal(_rule_2x(n), resize_matrix(2 * n, n, "bilinear")):
        raise RuntimeError(f"the 2x kernels' taps differ from "
                           f"resize_matrix({2 * n}, {n})")


def _check_2x(t, vjp):
    if t.ndim != 4:
        raise ValueError(f"{'g' if vjp else 'x'} must be NHWC, got "
                         f"{tuple(t.shape)}")
    if t.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the 2x upsample takes f32 or bf16, got {t.dtype}")
    if vjp and (t.shape[1] % 2 or t.shape[2] % 2):
        raise ValueError(f"g must be [N, 2H, 2W, C], got {tuple(t.shape)}")


def upsample2x_plain(x):
    """The 2× kernel's arithmetic in plain torch: :func:`sep_resize_plain`
    on the 2× bilinear taps, x [N, H, W, C] -> [N, 2H, 2W, C]."""
    _check_2x(x, False)
    h, w = x.shape[1:3]
    return sep_resize_plain(x, sep_taps(2 * h, h, "bilinear", False,
                                        x.device),
                            sep_taps(2 * w, w, "bilinear", False, x.device))


def upsample2x_vjp_plain(g):
    """The 2× VJP kernel's arithmetic in plain torch: the transposed taps,
    g [N, 2H, 2W, C] -> dx [N, H, W, C]."""
    _check_2x(g, True)
    h, w = g.shape[1] // 2, g.shape[2] // 2
    return sep_resize_plain(g, sep_taps(2 * h, h, "bilinear", True,
                                        g.device),
                            sep_taps(2 * w, w, "bilinear", True, g.device))


def _upsample2x_kernel(t, vjp):
    """Launches ``csrc/upsample2x.cu``'s forward (x -> [N, 2H, 2W, C]) or
    VJP (g -> dx [N, H, W, C]) kernel on t's strides."""
    name = "upsample2x_vjp" if vjp else "upsample2x_fused"
    _cuda_only(name, t)
    n, th, tw, c = t.shape
    h, w = (th // 2, tw // 2) if vjp else (th, tw)
    out = torch.empty((n, h, w, c) if vjp else (n, 2 * h, 2 * w, c),
                      dtype=t.dtype, device=t.device)
    if out.numel() == 0:
        return out
    span = sum((s - 1) * st for s, st in zip(t.shape[1:], t.stride()[1:]))
    if max(span, 4 * h * w * c) >= 2 ** 31:
        raise ValueError(f"{name}: one image of {tuple(t.shape)} (strides "
                         f"{t.stride()}) exceeds the kernel's 32-bit offsets")
    _check_2x_taps(h)
    _check_2x_taps(w)
    strides = (ctypes.c_longlong * 4)(*t.stride())
    fn = _lib_fn("upsample2x", "tlx_" + ("upsample2x_vjp" if vjp
                                         else "upsample2x"),
                 [_P, _P, _I, _I, _I, _I, _P, _I, _I, _P])
    with torch.cuda.device(t.device):
        rc = fn(t.data_ptr(), out.data_ptr(), n, h, w, c, strides,
                _KERNEL_DTYPES[t.dtype], _vector_width(t, out),
                torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "upsample2x", "upsample2x")
    if vjp:
        upsample2x_vjp.launches += 1
    else:
        upsample2x_fused.launches += 1
    return out


def upsample2x_vjp(g):
    """The 2× upsample's VJP, g [N, 2H, 2W, C] -> dx [N, H, W, C], f32 or
    bf16 with any strides (a stride-0 gradient included), summed in f32
    and rounded once: the kernel on a CUDA tensor, the plain version on a
    CPU one.  Not differentiable itself."""
    _check_2x(g, True)
    if g.device.type == "cpu":
        return upsample2x_vjp_plain(g)
    return _upsample2x_kernel(g, vjp=True)


upsample2x_vjp.launches = 0  # kernel launches since the last reset


upsample2x_op = define(
    "upsample2x(Tensor x) -> Tensor", upsample2x_plain,
    lambda x: _upsample2x_kernel(x, vjp=False),
    lambda x: x.new_empty(x.shape[0], 2 * x.shape[1], 2 * x.shape[2],
                          x.shape[3]))


class _Upsample2x(torch.autograd.Function):
    """``_fused_2x`` with its VJP: the 2× kernels of
    ``csrc/upsample2x.cu`` (their plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, x):
        return upsample2x_op(x)

    @staticmethod
    def backward(ctx, g):
        return upsample2x_vjp(g)


def upsample2x_fused(x):
    """2× half-pixel bilinear upsample, x [N, H, W, C] -> [N, 2H, 2W, C],
    f32 or bf16 with any strides, summed in f32 and rounded once,
    differentiable (the reference's ``upsample2x_fused``)."""
    _check_2x(x, False)
    check_device("upsample2x_fused", x)
    if needs_grad(x):
        return _Upsample2x.apply(x)
    return upsample2x_op(x)


upsample2x_fused.launches = 0  # forward kernel launches since the last reset

# The reference's shift-and-interleave kernel computes the same function;
# in bf16 it rounds each op, where the port rounds once (see the module's
# rounding contract).
upsample2x_bilinear = upsample2x_fused
