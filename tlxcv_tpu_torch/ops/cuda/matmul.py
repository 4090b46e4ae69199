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
int8 -> [M, N] int32``, exact.  ``int8_matmul_nt`` takes the weight packed
once as ``[N, Kp]`` (K-contiguous, ``Kp`` a multiple of ``K_ALIGN``), as
the int8 Conv2d and Linear keep it, so no call transposes it.
``int8_matmul_requant`` is the same product followed by the reference's
int8 epilogue (``tlxcv_tpu/nn/layers.py:251-260``: scale, bias, ReLU,
requantize to int8 or cast), which the kernel runs in its output stage so
that no int32 tensor is written; the int8 layers take it on the card.
``requantize`` is that epilogue alone, in PyTorch, the arithmetic of the
plain versions and of the layers on the CPU.

``bf16_matmul(a, b)`` keeps its reference's contract, ``[M, K] bf16 @ [K,
N] bf16 -> [M, N] bf16``: the products summed in f32 and rounded to bf16
once, at the end.

All of them take the plain version for tensors on the CPU.  For CUDA
tensors they launch the kernel or raise; they never fall back.  Each entry
is an operator of ``library`` (``tlxcv::int8_matmul_nt``,
``tlxcv::int8_matmul_requant``, ``tlxcv::bf16_matmul``), which
``torch.export`` records; on the CPU, ``int8_matmul_requant`` calls its
plain version directly where autograd records the epilogue's tensors.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .library import check_device, define, needs_grad

__all__ = ["bf16_matmul", "bf16_matmul_plain", "int8_matmul", "int8_matmul_nt",
           "int8_matmul_plain", "int8_matmul_requant",
           "int8_matmul_requant_plain", "requantize", "K_ALIGN", "padded_k",
           "pad_k"]

K_ALIGN = 16  # the kernel's K granularity: TMA's 16-byte row stride


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
    """[M, K] int8 @ [K, N] int8 -> [M, N] int32, in float64 on either
    device, then cast to int32: exact while K * 128**2 < 2**53, and a BLAS
    product where CUDA has no int32 matrix product and the CPU's is
    unblocked (an order of magnitude slower)."""
    _check_operands(a, b, 0)
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


def _launch(wrapper, symbol, errors, pointers, m, ints, aligned):
    """Launch the C entry ``symbol`` of ``wrapper``'s kernel library on the
    current stream: the ``pointers`` (tensors, or None for null), ``m`` as
    a long long, the ``ints``, the stream.  The ``aligned`` tensors must be
    16-byte aligned (TMA and 16-byte stores); each wrapper checks its own
    kernel's shape limits first.  Raises with the library's error string
    ``errors`` if the launch failed; counts a launch on ``wrapper``
    otherwise."""
    if any(t.data_ptr() % 16 for t in aligned):
        raise ValueError("the kernel takes 16-byte aligned operands")
    lib = _build.library(wrapper.__name__)
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = ([p] * len(pointers) + [ctypes.c_longlong]
                       + [ctypes.c_int] * len(ints) + [p])
        fn.restype = ctypes.c_int
    with torch.cuda.device(aligned[0].device):
        rc = fn(*(None if t is None else t.data_ptr() for t in pointers), m,
                *ints, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        err = getattr(lib, errors)
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{wrapper.__name__} kernel launch failed: "
                           f"{err(rc).decode()} ({rc})")
    wrapper.launches += 1


def _check_int8_kernel(a, w):
    """What the int8 kernel takes beyond the contract: one device, K a
    multiple of ``K_ALIGN``, contiguous operands, M below 2**31 (TMA's
    32-bit coordinates).  Returns (M, N, K)."""
    _check_device("int8_matmul", a, w)
    m, n, k = a.shape[0], w.shape[0], a.shape[1]
    if k % K_ALIGN:
        raise ValueError(f"the kernel takes K a multiple of {K_ALIGN}, got "
                         f"{k}; pad with pad_k")
    if not (a.is_contiguous() and w.is_contiguous()):
        raise ValueError("the kernel takes contiguous operands")
    if m >= 2 ** 31:
        raise ValueError(f"the kernel takes M < 2**31 rows, got {m}")
    return m, n, k


def int8_matmul_nt(a, w):
    """``a``: [M, K] int8, ``w``: [N, K] int8 (the right operand
    transposed, as the int8 layers pack their weight) -> [M, N] int32,
    exact.  On the card K must be a multiple of ``K_ALIGN``."""
    _check_operands(a, w, 1)
    check_device("int8_matmul", a)
    return int8_matmul_nt_op(a, w)


def _int8_nt_cuda(a, w):
    m, n, k = _check_int8_kernel(a, w)
    out = torch.empty(m, n, dtype=torch.int32, device=a.device)
    if m == 0 or n == 0 or k == 0:
        return out.zero_()
    _launch(int8_matmul, "tlx_int8_matmul_nt", "tlx_int8_error_string",
            (a, w, out), m, (n, k), aligned=(a, w, out))
    return out


int8_matmul_nt_op = define(
    "int8_matmul_nt(Tensor a, Tensor w) -> Tensor",
    lambda a, w: int8_matmul_plain(a, w.t()), _int8_nt_cuda,
    lambda a, w: a.new_empty(a.shape[0], w.shape[0], dtype=torch.int32))


# ------------------------------------------------- int8 with its epilogue
_OUT_KIND = {torch.int8: 1, torch.bfloat16: 2, torch.float32: 3}


def requantize(acc, scale, bias=None, relu=False, out_scale=None,
               out_dtype=torch.float32):
    """The reference's int8 epilogue on int32 sums ``acc`` [M, N], in its
    op order, each op a separate f32 pass: ``acc * scale`` (``scale`` [N]
    is ``s_in * w_scale``), ``+ bias``, ReLU if ``relu``; with
    ``out_scale``, requantize to int8 (round half to even, as jnp.round,
    clamp to +-127), else cast to ``out_dtype``."""
    y = acc.float() * scale
    if bias is not None:
        y = y + bias
    if relu:
        y = torch.clamp_min(y, 0.0)
    if out_scale is not None:
        return torch.round(y / out_scale).clamp(-127, 127).to(torch.int8)
    return y.to(out_dtype)


def _check_requant(a, w, scale, bias, out_scale, out_dtype):
    """The epilogue's operands: f32 ``scale`` [N], a float ``bias`` [N],
    one f32 ``out_scale``, a float ``out_dtype``, all on ``a``'s device."""
    n = w.shape[0]
    if scale.dtype != torch.float32 or tuple(scale.shape) != (n,):
        raise TypeError(f"scale must be f32 [{n}], got {scale.dtype} "
                        f"{tuple(scale.shape)}")
    if bias is not None and (not bias.is_floating_point()
                             or tuple(bias.shape) != (n,)):
        raise TypeError(f"bias must be a float [{n}], got {bias.dtype} "
                        f"{tuple(bias.shape)}")
    if out_scale is not None and (out_scale.dtype != torch.float32
                                  or out_scale.numel() != 1):
        raise TypeError(f"out_scale must be one f32, got {out_scale.dtype} "
                        f"{tuple(out_scale.shape)}")
    if out_scale is None and out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16 without "
                        f"out_scale, got {out_dtype}")
    for t in (scale, bias, out_scale):
        if t is not None and t.device != a.device:
            raise ValueError(f"the epilogue's tensors must lie on "
                             f"{a.device}, got {t.device}")


def _refuse_grad(*tensors):
    """The kernel has no backward: raise where autograd would record."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise RuntimeError("int8_matmul_requant has no backward: call it "
                           "under torch.no_grad() or torch.inference_mode()")


def int8_matmul_requant_plain(a, w, scale, bias=None, relu=False,
                              out_scale=None, out_dtype=torch.float32):
    """``int8_matmul_plain`` of ``a`` and ``w.t()``, then ``requantize``."""
    _check_operands(a, w, 1)
    _check_requant(a, w, scale, bias, out_scale, out_dtype)
    return requantize(int8_matmul_plain(a, w.t()), scale, bias, relu,
                      out_scale, out_dtype)


def int8_matmul_requant(a, w, scale, bias=None, relu=False, out_scale=None,
                        out_dtype=torch.float32):
    """``a``: [M, Kp] int8, ``w``: [N, Kp] int8 -> ``requantize`` of their
    int32 product: [M, N] int8 with ``out_scale``, else ``out_dtype`` (f32
    or bf16).  On the CPU the plain version, differentiable in ``scale``
    and ``bias``.  On the card one kernel launch, counted on
    ``int8_matmul.launches``, bitwise equal to the plain version; K must
    be a positive multiple of ``K_ALIGN``, and it raises where autograd
    would record (the kernel has no backward)."""
    _check_operands(a, w, 1)
    _check_requant(a, w, scale, bias, out_scale, out_dtype)
    check_device("int8_matmul_requant", a)
    if a.device.type == "cpu" and needs_grad(scale, bias, out_scale):
        return int8_matmul_requant_plain(a, w, scale, bias, relu, out_scale,
                                         out_dtype)
    if a.device.type != "cpu":
        _refuse_grad(scale, bias, out_scale)
    return int8_matmul_requant_op(a, w, scale, bias, bool(relu), out_scale,
                                  out_dtype)


def _requant_cuda(a, w, scale, bias, relu, out_scale, out_dtype):
    m, n, k = _check_int8_kernel(a, w)
    if k == 0:
        raise ValueError("the fused kernel takes K > 0")
    out_dtype = torch.int8 if out_scale is not None else out_dtype
    out = torch.empty(m, n, dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    scale = scale.contiguous()
    bias = None if bias is None else bias.float().contiguous()
    out_scale = None if out_scale is None else out_scale.reshape(())
    _launch(int8_matmul, "tlx_int8_matmul_requant", "tlx_int8_error_string",
            (a, w, out, scale, bias, out_scale), m,
            (n, k, int(bool(relu)), _OUT_KIND[out_dtype]),
            aligned=(a, w, out))
    return out


def _requant_fake(a, w, scale, bias, relu, out_scale, out_dtype):
    return a.new_empty(a.shape[0], w.shape[0], dtype=(
        torch.int8 if out_scale is not None else out_dtype))


int8_matmul_requant_op = define(
    "int8_matmul_requant(Tensor a, Tensor w, Tensor scale, Tensor? bias, "
    "bool relu, Tensor? out_scale, ScalarType out_dtype) -> Tensor",
    int8_matmul_requant_plain, _requant_cuda, _requant_fake)


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
    check_device("bf16_matmul", a)
    return bf16_matmul_op(a, b)


def _bf16_cuda(a, b):
    _check_device("bf16_matmul", a, b)
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty(m, n, dtype=torch.bfloat16, device=a.device)
    if m == 0 or n == 0 or k == 0:
        return out.zero_()
    kp = -(-k // BF16_ALIGN) * BF16_ALIGN
    ldb = -(-n // BF16_ALIGN) * BF16_ALIGN
    a = _pad_to(a.contiguous(), m, kp)
    b = _pad_to(b.contiguous(), kp, ldb)
    if m >= 2 ** 31 or -(-n // 256) > 65535:  # TMA coordinates, grid.y
        raise ValueError(f"shape {m} x {n} exceeds the kernel's grid")
    _launch(bf16_matmul, "tlx_bf16_matmul", "tlx_bf16_error_string",
            (a, b, out), m, (n, kp, ldb), aligned=(a, b, out))
    return out


bf16_matmul_op = define(
    "bf16_matmul(Tensor a, Tensor b) -> Tensor", bf16_matmul_plain,
    _bf16_cuda, lambda a, b: a.new_empty(a.shape[0], b.shape[1]))


bf16_matmul.launches = 0  # kernel launches since the last reset
