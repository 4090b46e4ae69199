"""int8 GEMM: the Hopper kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``tlxcv_tpu/ops/pallas/matmul.py``
(``int8_matmul`` :57).  The kernel is ``csrc/int8_matmul.cu``; its source
note says what bounds it on the H100 and how its design meets that.  The
TPU block sizes and ``interpret`` of the reference have no counterpart.

``int8_matmul(a, b)`` keeps the reference contract, ``[M, K] int8 @ [K, N]
int8 -> [M, N] int32``, exact.  The int8 Conv2d and Linear call
``int8_matmul_nt`` instead, with the weight packed once as ``[N, Kp]``
(K-contiguous, ``Kp`` a multiple of ``K_ALIGN``), so no call transposes it.

Both take the plain version for tensors on the CPU.  For CUDA tensors they
launch the kernel or raise; they never fall back.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["int8_matmul", "int8_matmul_nt", "int8_matmul_plain", "K_ALIGN",
           "padded_k", "pad_k"]

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


def _check_kernel_inputs(a, w):
    if a.device.type != "cuda" or w.device != a.device:
        raise ValueError(f"int8_matmul runs on CUDA or CPU tensors on one "
                         f"device, got {a.device} and {w.device}")
    m, k = a.shape
    if k % K_ALIGN:
        raise ValueError(f"the kernel takes K a multiple of {K_ALIGN}, got "
                         f"{k}; pad with pad_k")
    if not (a.is_contiguous() and w.is_contiguous()):
        raise ValueError("the kernel takes contiguous operands")
    if a.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("the kernel takes 16-byte aligned operands")
    if -(-m // 128) >= 2 ** 31 or -(-w.shape[0] // 64) > 65535:
        raise ValueError(f"shape {m} x {w.shape[0]} exceeds the kernel's "
                         f"grid")


def _kernel_fn():
    fn = _build.library("int8_matmul").tlx_int8_matmul_nt
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, ctypes.c_longlong, i, i, p]
        fn.restype = i
    return fn


def _error_string(rc):
    fn = _build.library("int8_matmul").tlx_int8_error_string
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
    return fn(rc).decode()


def int8_matmul_nt(a, w):
    """``a``: [M, K] int8, ``w``: [N, K] int8 (the right operand
    transposed, as the int8 layers pack their weight) -> [M, N] int32,
    exact.  On the card K must be a multiple of ``K_ALIGN``."""
    _check_operands(a, w, 1)
    if a.device.type == "cpu":
        return int8_matmul_plain(a, w.t())
    _check_kernel_inputs(a, w)
    m, n = a.shape[0], w.shape[0]
    out = torch.empty(m, n, dtype=torch.int32, device=a.device)
    if m == 0 or n == 0 or a.shape[1] == 0:
        return out.zero_()
    with torch.cuda.device(a.device):
        rc = _kernel_fn()(a.data_ptr(), w.data_ptr(), out.data_ptr(), m, n,
                          a.shape[1], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: "
                           f"{_error_string(rc)} ({rc})")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0  # kernel launches since the last reset
