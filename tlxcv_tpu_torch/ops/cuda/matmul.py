"""The GEMM kernels: int8 and bf16, each Hopper kernel's wrapper beside its
plain version.

``int8_matmul`` replaces the Pallas TPU kernel
``tlxcv_tpu/ops/pallas/matmul.py`` (``int8_matmul`` :57); its kernel is
``csrc/int8_matmul.cu``.  ``bf16_matmul`` replaces the bf16 twin that the
demo's GEMM probe defines, ``demo/image_classification/
probe_int8_pallas.py`` (``bf16_matmul`` :86); its kernel is
``csrc/bf16_matmul.cu``.  Each source note says what bounds the kernel on
the H100 and how its design meets that.  The TPU block sizes and
``interpret`` of the references have no counterpart.

``int8_matmul(a, b)`` keeps the reference contract, ``[M, K] int8 @ [K, N]
int8 -> [M, N] int32``, exact.  The int8 Conv2d and Linear call
``int8_matmul_nt`` instead, with the weight packed once as ``[N, Kp]``
(K-contiguous, ``Kp`` a multiple of ``K_ALIGN``), so no call transposes it.

``bf16_matmul(a, b)`` keeps its reference's contract, ``[M, K] bf16 @ [K,
N] bf16 -> [M, N] bf16``: the products summed in f32 and rounded to bf16
once, at the end.

All of them take the plain version for tensors on the CPU.  For CUDA
tensors they launch the kernel or raise; they never fall back.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["bf16_matmul", "bf16_matmul_plain", "int8_matmul", "int8_matmul_nt",
           "int8_matmul_plain", "K_ALIGN", "padded_k", "pad_k"]

K_ALIGN = 16  # the kernel's K granularity: one 16-byte cp.async chunk


def padded_k(k: int) -> int:
    return -(-k // K_ALIGN) * K_ALIGN


def pad_k(t):
    """Zero columns appended to a [rows, K] int8 matrix up to a multiple of
    ``K_ALIGN``; exact, since a zero adds nothing to the integer sum."""
    extra = padded_k(t.shape[-1]) - t.shape[-1]
    return F.pad(t, (0, extra)) if extra else t


def _check_operands(a, b, b_k_dim):
    """int8, 2D, and K of ``a`` equal to dim ``b_k_dim`` of ``b``."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_matmul needs int8 operands, got "
                        f"{a.dtype}/{b.dtype}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[b_k_dim]:
        raise ValueError(f"inner dims mismatch: {tuple(a.shape)} and "
                         f"{tuple(b.shape)} (K on dim {b_k_dim})")


def int8_matmul_plain(a, b):
    """[M, K] int8 @ [K, N] int8 -> [M, N] int32.  On the CPU in int32.  On
    the card in float64, which is exact while K * 128**2 < 2**53 (CUDA has
    no int32 matrix product), then cast to int32."""
    _check_operands(a, b, 0)
    if a.device.type == "cpu":
        return a.int() @ b.int()
    return (a.double() @ b.double()).to(torch.int32)


def int8_matmul(a, b):
    """``a``: [M, K] int8, ``b``: [K, N] int8 -> [M, N] int32 (exact).  On
    the card, ``b`` is transposed and both operands zero-padded along K
    for the kernel."""
    _check_operands(a, b, 0)
    if a.device.type == "cpu":
        return int8_matmul_plain(a, b)
    return int8_matmul_nt(pad_k(a.contiguous()), pad_k(b.t().contiguous()))


def _check_device(name, a, b):
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"{name} runs on CUDA or CPU tensors on one device, "
                         f"got {a.device} and {b.device}")


def _launch(wrapper, symbol, errors, tensors, m, ints, tile_n):
    """Launch the C entry ``symbol`` of ``wrapper``'s kernel library on the
    current stream: the tensors' addresses (the output last), ``m`` as a
    long long, the ``ints`` (N first), the stream.  The grid is
    ``ceil(m / 128) x ceil(N / tile_n)`` blocks.  Raises with the library's
    error string ``errors`` if the launch failed; counts a launch on
    ``wrapper`` otherwise."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the kernel takes 16-byte aligned operands")
    if -(-m // 128) >= 2 ** 31 or -(-ints[0] // tile_n) > 65535:
        raise ValueError(f"shape {m} x {ints[0]} exceeds the kernel's grid")
    lib = _build.library(wrapper.__name__)
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = ([p] * len(tensors) + [ctypes.c_longlong]
                       + [ctypes.c_int] * len(ints) + [p])
        fn.restype = ctypes.c_int
    with torch.cuda.device(tensors[0].device):
        rc = fn(*(t.data_ptr() for t in tensors), m, *ints,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        err = getattr(lib, errors)
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: "
                           f"{err(rc).decode()} ({rc})")
    wrapper.launches += 1


def int8_matmul_nt(a, w):
    """``a``: [M, K] int8, ``w``: [N, K] int8 (the right operand
    transposed, as the int8 layers pack their weight) -> [M, N] int32,
    exact.  On the card K must be a multiple of ``K_ALIGN``."""
    _check_operands(a, w, 1)
    if a.device.type == "cpu":
        return int8_matmul_plain(a, w.t())
    _check_device("int8_matmul", a, w)
    m, n, k = a.shape[0], w.shape[0], a.shape[1]
    if k % K_ALIGN:
        raise ValueError(f"the kernel takes K a multiple of {K_ALIGN}, got "
                         f"{k}; pad with pad_k")
    if not (a.is_contiguous() and w.is_contiguous()):
        raise ValueError("the kernel takes contiguous operands")
    out = torch.empty(m, n, dtype=torch.int32, device=a.device)
    if m == 0 or n == 0 or k == 0:
        return out.zero_()
    _launch(int8_matmul, "tlx_int8_matmul_nt", "tlx_int8_error_string",
            (a, w, out), m, (n, k), tile_n=64)
    return out


int8_matmul.launches = 0  # kernel launches since the last reset


# ------------------------------------------------------------------ bf16
BF16_ALIGN = 8  # the bf16 kernel's K and row granule: one 16-byte chunk


def _check_bf16_operands(a, b):
    """bf16, 2D, and K of ``a`` equal to the rows of ``b``."""
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"bf16_matmul needs bf16 operands, got "
                        f"{a.dtype}/{b.dtype}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dims mismatch: {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")


def bf16_matmul_plain(a, b):
    """[M, K] bf16 @ [K, N] bf16 -> [M, N] bf16: the product in f32, rounded
    to bf16 once.  On the card the f32 product must run in full f32, as
    PyTorch's default (``torch.backends.cuda.matmul.allow_tf32`` False)
    has it."""
    _check_bf16_operands(a, b)
    return (a.float() @ b.float()).to(torch.bfloat16)


def _pad_to(t, rows, cols):
    """Zero rows and columns appended up to ``rows`` x ``cols``; exact,
    since a zero adds nothing to the sum."""
    extra_r, extra_c = rows - t.shape[0], cols - t.shape[1]
    return F.pad(t, (0, extra_c, 0, extra_r)) if extra_r or extra_c else t


def bf16_matmul(a, b):
    """``a``: [M, K] bf16, ``b``: [K, N] bf16 -> [M, N] bf16, summed in f32
    and rounded once.  On the card K, and the rows of ``b``, are
    zero-padded to a multiple of ``BF16_ALIGN`` for the kernel when they
    are not one already; ``b`` is read as it lies, never transposed."""
    _check_bf16_operands(a, b)
    if a.device.type == "cpu":
        return bf16_matmul_plain(a, b)
    _check_device("bf16_matmul", a, b)
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty(m, n, dtype=torch.bfloat16, device=a.device)
    if m == 0 or n == 0 or k == 0:
        return out.zero_()
    kp = -(-k // BF16_ALIGN) * BF16_ALIGN
    ldb = -(-n // BF16_ALIGN) * BF16_ALIGN
    a = _pad_to(a.contiguous(), m, kp)
    b = _pad_to(b.contiguous(), kp, ldb)
    if m >= 2 ** 31:
        raise ValueError(f"the kernel takes M < 2**31 rows, got {m}")
    _launch(bf16_matmul, "tlx_bf16_matmul", "tlx_bf16_error_string",
            (a, b, out), m, (n, kp, ldb), tile_n=256)
    return out


bf16_matmul.launches = 0  # kernel launches since the last reset
