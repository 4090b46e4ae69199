"""Flash attention: the Hopper kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``tlxcv_tpu/ops/pallas/attention.py``
(``flash_attention`` :108).  The kernel is ``csrc/flash_attention.cu``; its
source note says what bounds it on the H100 and how its design meets that.
The TPU layout devices of the reference (``block_q``/``block_k``, ``nb``,
``pad_d``, ``interpret``) have no counterpart: block sizes are the kernel's
own choice.

``flash_attention`` takes the plain version for a tensor on the CPU, which
autograd differentiates.  For a CUDA tensor it launches the kernel or
raises; it never falls back.  Its forward is the operator
``tlxcv::flash_attention`` (``library``; ``tlxcv::flash_attention_lse``
when it also writes the log-sum-exp), which ``torch.export`` records: a
call that needs no gradient reaches the operator directly, on either
device, and one that does goes through the ``autograd.Function``.  The
kernel reads q, k, v through their strides: a ``[B, H, S, D]`` view into
a packed qkv projection needs no copy.
On the card the call is a ``torch.autograd.Function``: its forward is the
kernel, which also writes each row's log-sum-exp when an input requires
grad, and its backward is ``csrc/flash_attention_bwd.cu`` (dq, dk and dv
from that statistic, deterministic).  Both run on the tensor cores in bf16
and in f32; f32 products are split TF32 (``csrc/flash_attention.cuh``),
which keeps f32 accuracy and never reads
``torch.backends.cuda.matmul.allow_tf32``.  The TPU kernel has no VJP; the JAX
package trains on its einsum path, whose gradient this is.
``flash_attention_backward_plain`` is the backward's arithmetic in plain
torch, for the tests and ``chip_smoke.py``.

The kernel takes head dims 32, 64, 96 and 128.  On the card the wrapper
zero-pads any other D up to 128 to the next of them (``padded_head_dim``)
through ``F.pad``, so autograd slices the gradients back, and slices the
output: zero columns add nothing to q.kᵀ and give zero output columns,
and the scale stays D**-0.5 of the real D.  D > 128 raises.  The padding
lives here, not in the kernel: a bf16 row of D = 4 is 8 bytes, below the
16-byte global strides a TMA tensor map needs, and below ``wgmma``'s depth
of 16 bf16 values.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import _build
from .library import check_device, define, needs_grad

__all__ = ["flash_attention", "flash_attention_backward",
           "flash_attention_op", "flash_attention_lse_op",
           "flash_attention_plain", "flash_attention_backward_plain",
           "padded_head_dim", "NEG"]

# Clamp for additive bias entries (the reference's _NEG): an all -inf tile
# would otherwise give exp(-inf - -inf) = NaN in the online softmax.
NEG = -0.7 * torch.finfo(torch.float32).max
HEAD_DIMS = (32, 64, 96, 128)  # ViT-S/16 has 96
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_shapes(q, k, v, bias):
    """q [BH, Sq, D] or [B, H, Sq, D]; k and v [.., Sk, D] with q's leading
    dims and D; bias [1|BH, Sq, Sk]."""
    if (q.ndim not in (3, 4) or k.shape != v.shape or k.ndim != q.ndim
            or k.shape[:-2] != q.shape[:-2] or k.shape[-1] != q.shape[-1]):
        raise ValueError(f"q must be [BH, Sq, D] or [B, H, Sq, D] and k, v "
                         f"one shape [.., Sk, D] with q's leading dims and "
                         f"D, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    sq, sk = q.shape[-2], k.shape[-2]
    bh = math.prod(q.shape[:-2])
    if bias is not None:
        if bias.ndim != 3 or bias.shape[0] not in (1, bh):
            raise ValueError(f"bias leading dim {bias.shape[0]} must be 1 or "
                             f"BH={bh} (per-head bias must be pre-broadcast)")
        if tuple(bias.shape[1:]) != (sq, sk):
            raise ValueError(f"bias must be [1|BH, {sq}, {sk}], got "
                             f"{tuple(bias.shape)}")


def padded_head_dim(d):
    """The kernel's head dim for a call at head dim ``d``: the least of
    ``HEAD_DIMS`` that holds it; raises past 128."""
    for dp in HEAD_DIMS:
        if d <= dp:
            return dp
    raise ValueError(f"the kernel takes head dims up to {HEAD_DIMS[-1]} "
                     f"(padding smaller ones to {HEAD_DIMS}), got {d}")


def _acc_dtype(t):
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def flash_attention_plain(q, k, v, bias=None, scale=None,
                          return_lse=False):
    """The kernel's arithmetic in plain torch: f32 scores, bias added and
    clamped at ``NEG``, f32 softmax statistics, P cast to v's dtype before
    P.V, normalised at the end, output in q's dtype (float64 inputs, which
    the kernel does not take, stay float64 throughout: a reference).
    ``return_lse`` also returns each row's log-sum-exp ``m + log(l)`` [BH,
    Sq], in natural units, as the kernel writes it for the backward."""
    _check_shapes(q, k, v, bias)
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else float(scale)
    acc = _acc_dtype(q)
    q3, k3, v3 = (t.reshape(-1, t.shape[-2], d).to(acc) for t in (q, k, v))
    logits = torch.einsum("bqd,bkd->bqk", q3, k3) * scale
    if bias is not None:
        logits = torch.clamp_min(logits + bias.to(acc), NEG)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).to(acc), v3)
    out = (out / l).to(q.dtype).reshape(q.shape)
    if return_lse:
        return out, (m + torch.log(l))[..., 0]
    return out


def flash_attention_backward_plain(q, k, v, bias, scale, out, lse, dout):
    """dq, dk, dv of ``flash_attention`` from its output ``out``, its
    log-sum-exp ``lse`` [BH, Sq] and the output's gradient ``dout``: the
    backward kernel's formulas in plain torch.  P = exp(x - lse) in f32
    (1/Sk on a row the bias masks entirely, whose lse is the clamp ``NEG``:
    the forward averages v there); delta = rowsum(dout * out); dv = Pᵀ·dout
    with P rounded to v's dtype, as the forward rounds it before P·V;
    dS = P (dout·vᵀ - delta), zero where the clamp took the score; dq =
    scale dS·k, dk = scale dSᵀ·q.  Each in its input's dtype and shape."""
    _check_shapes(q, k, v, bias)
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else float(scale)
    acc = _acc_dtype(q)
    q3, k3, v3 = (t.reshape(-1, t.shape[-2], d).to(acc) for t in (q, k, v))
    o3, g3 = (t.reshape(q3.shape).to(acc) for t in (out, dout))
    raw = torch.einsum("bqd,bkd->bqk", q3, k3) * scale
    lse3 = lse.reshape(q3.shape[0], -1, 1).to(acc)
    if bias is None:
        p = torch.exp(raw - lse3)
    else:
        raw = raw + bias.to(acc)
        p = torch.exp(torch.clamp_min(raw, NEG) - lse3)
        p = torch.where(lse3 == NEG, 1.0 / k3.shape[1], p)
    delta = (g3 * o3).sum(-1, keepdim=True)
    dv = torch.einsum("bqk,bqd->bkd", p.to(v.dtype).to(acc), g3)
    ds = p * (torch.einsum("bqd,bkd->bqk", g3, v3) - delta)
    if bias is not None:
        ds = torch.where(raw >= NEG, ds, 0.0)
    dq = torch.einsum("bqk,bkd->bqd", ds, k3) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, q3) * scale
    return (dq.to(q.dtype).reshape(q.shape), dk.to(k.dtype).reshape(k.shape),
            dv.to(v.dtype).reshape(v.shape))


def _check_kernel_inputs(q, k, v, bias):
    """What the kernel takes; written for a short host path, since it runs
    before every launch."""
    dev, dtype = q.device, q.dtype
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, "
                         f"got {dev}")
    if k.device != dev or v.device != dev or (
            bias is not None and bias.device != dev):
        raise ValueError("q, k, v and bias must be on one device")
    if dtype not in _KERNEL_DTYPES or k.dtype != dtype or v.dtype != dtype:
        raise ValueError(f"the kernel takes f32 or bf16 q, k, v of one "
                         f"dtype, got {dtype}, {k.dtype}, {v.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dim {HEAD_DIMS}, "
                         f"got {q.shape[-1]}")
    if bias is not None:
        if bias.dtype != torch.float32:
            raise ValueError(f"bias must be float32, got {bias.dtype}")
        if not bias.is_contiguous():
            raise ValueError("bias must be contiguous")
        if bias.data_ptr() % 16:
            raise ValueError("q, k, v and bias must be 16-byte aligned")
    per_16_bytes = 16 // q.element_size()
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("q, k, v and bias must be 16-byte aligned")
        *outer, last = t.stride()
        if last != 1 or any(st % per_16_bytes for st in outer):
            raise ValueError("q, k, v need a contiguous head dim and other "
                             "strides of whole 16-byte units")
    bh, sq = math.prod(q.shape[:-2]), q.shape[-2]
    if bh >= 2 ** 31 or -(-sq // 64) > 65535 or k.shape[-2] >= 2 ** 31:
        raise ValueError(f"shape {tuple(q.shape)} exceeds the kernel's grid")


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (library, C entry, argument types) of the forward and the backward
_FORWARD = ("flash_attention", "tlx_flash_attention_fwd",
            [_P] * 6 + [_I] * 5 + [_P, _I, _F, _I, _P])
_BACKWARD = ("flash_attention_bwd", "tlx_flash_attention_bwd",
             [_P] * 11 + [_I] * 5 + [_P, _I, _F, _I, _P])


def _kernel_fn(entry=_FORWARD):
    lib, name, argtypes = entry
    fn = getattr(_build.library(lib), name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = argtypes, _I
    return fn


def _error_string(rc, lib="flash_attention"):
    fn = _build.library(lib).tlx_cuda_error_string
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
    return fn(rc).decode()


def _bhs_strides(t):
    """(batch, head, row) element strides; a 3D tensor is one batch."""
    return (0, *t.stride()[:2]) if t.ndim == 3 else t.stride()[:3]


def _heads_view(t, q):
    """A forward output or its gradient as q's [.., Sq, D] layout: a 4D
    call's is stored [B, Sq, H, D]."""
    return t if q.ndim == 3 else t.transpose(1, 2)


def _launch_kernel(q, k, v, bias, scale, with_lse=False):
    """One kernel launch: [BH, Sq, D] contiguous, or [B, Sq, H, D] (the
    token-major store of a 4D call), in q's dtype; with ``with_lse`` also
    the rows' log-sum-exp [BH, Sq] f32 (else None)."""
    if q.device.index != torch.cuda.current_device():
        with torch.cuda.device(q.device):
            return _launch_kernel(q, k, v, bias, scale, with_lse)
    sq, d = q.shape[-2:]
    batch, heads = (1, q.shape[0]) if q.ndim == 3 else q.shape[:2]
    fn = _kernel_fn()
    if q.ndim == 3:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
    else:
        out = q.new_empty(batch, sq, heads, d)
    lse = (q.new_empty(batch * heads, sq, dtype=torch.float32)
           if with_lse else None)
    strides = (ctypes.c_longlong * 12)(
        *_bhs_strides(q), *_bhs_strides(k), *_bhs_strides(v),
        *_bhs_strides(_heads_view(out, q)))
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            batch, heads, sq, k.shape[-2], d, strides,
            int(bias is not None and bias.shape[0] == batch * heads),
            scale, _KERNEL_DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"{_error_string(rc)} ({rc})")
    flash_attention.launches += 1
    flash_attention.f32_launches += q.dtype == torch.float32
    return out, lse


def flash_attention_backward(q, k, v, bias, scale, out, lse, grad):
    """dq, dk, dv of a card forward: the backward kernels (dq, which also
    writes delta = rowsum(grad * out), then dk and dv; f32 on split TF32
    products) on the forward's inputs, its output ``out`` (as the forward
    stored it), its log-sum-exp ``lse`` and the output's gradient
    ``grad``; contiguous in q's, k's and v's shapes and dtype.  Counts one
    launch in ``flash_attention_backward.launches``."""
    if q.device.index != torch.cuda.current_device():
        with torch.cuda.device(q.device):
            return flash_attention_backward(q, k, v, bias, scale, out, lse,
                                            grad)
    per_16_bytes = 16 // q.element_size()
    if (grad.dtype != q.dtype or grad.stride(-1) != 1 or grad.data_ptr() % 16
            or any(st % per_16_bytes for st in grad.stride()[:-1])):
        # e.g. the expanded gradient of a sum: the kernels read it by TMA
        # and 16-byte loads
        grad = grad.to(q.dtype).contiguous()
    sq, d = q.shape[-2:]
    batch, heads = (1, q.shape[0]) if q.ndim == 3 else q.shape[:2]
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                  for t in (q, k, v))
    delta = torch.empty_like(lse)
    strides = (ctypes.c_longlong * 15)(
        *_bhs_strides(q), *_bhs_strides(k), *_bhs_strides(v),
        *_bhs_strides(_heads_view(out, q)),
        *_bhs_strides(_heads_view(grad, q)))
    rc = _kernel_fn(_BACKWARD)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        grad.data_ptr(), None if bias is None else bias.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), batch, heads, sq, k.shape[-2], d, strides,
        int(bias is not None and bias.shape[0] == batch * heads), scale,
        _KERNEL_DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention backward launch failed: "
                           f"{_error_string(rc, 'flash_attention_bwd')} "
                           f"({rc})")
    flash_attention_backward.launches += 1
    flash_attention_backward.f32_launches += q.dtype == torch.float32
    return dq, dk, dv


def _kernel_layout(q):
    """The shape of the kernel's output: [BH, Sq, D], or [B, Sq, H, D] for
    a 4D call (the token-major store)."""
    return q.shape if q.ndim == 3 else (q.shape[0], q.shape[2], q.shape[1],
                                        q.shape[3])


def _plain_in_kernel_layout(q, k, v, bias, scale, with_lse):
    out, lse = flash_attention_plain(q, k, v, bias, scale, return_lse=True)
    out = out if q.ndim == 3 else out.transpose(1, 2).contiguous()
    return (out, lse.float()) if with_lse else out


def _fake(q, k, v, bias, scale):
    return q.new_empty(_kernel_layout(q))


def _fake_lse(q, k, v, bias, scale):
    return (q.new_empty(_kernel_layout(q)),
            q.new_empty(math.prod(q.shape[:-2]), q.shape[-2],
                        dtype=torch.float32))


def _cuda(q, k, v, bias, scale):
    _check_kernel_inputs(q, k, v, bias)
    return _launch_kernel(q, k, v, bias, scale)[0]


def _cuda_lse(q, k, v, bias, scale):
    _check_kernel_inputs(q, k, v, bias)
    return _launch_kernel(q, k, v, bias, scale, with_lse=True)


# The forward as operators (``library``): the output in the kernel's layout;
# the second also returns the rows' log-sum-exp [BH, Sq] f32 for the
# backward.  On the card q, k, v must be what the kernel takes (head dim
# 32, 64, 96 or 128: ``flash_attention`` pads before the call).
_SCHEMA = "(Tensor q, Tensor k, Tensor v, Tensor? bias, float scale)"
flash_attention_op = define(
    "flash_attention" + _SCHEMA + " -> Tensor",
    lambda *a: _plain_in_kernel_layout(*a, with_lse=False), _cuda, _fake)
flash_attention_lse_op = define(
    "flash_attention_lse" + _SCHEMA + " -> (Tensor, Tensor)",
    lambda *a: _plain_in_kernel_layout(*a, with_lse=True), _cuda_lse,
    _fake_lse)


class _FlashAttention(torch.autograd.Function):
    """The kernel as an autograd node: forward launches it (writing the
    rows' log-sum-exp when ``train``), backward launches the backward
    kernels on the saved q, k, v, output and log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, train):
        if not train:
            return flash_attention_op(q, k, v, bias, scale)
        out, lse = flash_attention_lse_op(q, k, v, bias, scale)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, bias, out, lse = ctx.saved_tensors
        return (*flash_attention_backward(q, k, v, bias, ctx.scale, out, lse,
                                          grad), None, None, None)


def flash_attention(q, k, v, bias=None, scale=None):
    """softmax(q kᵀ·scale + bias)·v.  q: [BH, Sq, D] or [B, H, Sq, D]; k,
    v: [BH, Sk, D] or [B, H, Sk, D] with q's leading dims and D (any key
    length: DETR's cross-attention has 100 queries over H·W keys; on the
    card D <= 128, padded to the kernel's next head dim where it is not
    one of them); any strides over a contiguous head dim; bias: optional
    additive [1|BH, Sq, Sk] (BH = B·H), a constant (on the card a bias
    that requires grad raises: the backward gives it none); scale
    defaults to D**-0.5.  Returns q's shape in q's dtype: [BH, Sq, D]
    contiguous, or [B, H, Sq, D] stored token-major (a view of [B, Sq, H,
    D]); at a padded head dim the first D columns of the padded output.
    On the card the result has a ``grad_fn`` whose backward is the
    backward kernel."""
    _check_shapes(q, k, v, bias)
    check_device("flash_attention", q)
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else float(scale)
    if q.device.type == "cpu":
        if needs_grad(q, k, v, bias):  # autograd through the plain version
            return flash_attention_plain(q, k, v, bias, scale)
        out = flash_attention_op(q, k, v, bias, scale)
        return out if q.ndim == 3 else out.transpose(1, 2)
    dp = padded_head_dim(d)
    if dp != d:  # zero columns: q.kᵀ and the kept columns of P.v unchanged
        q, k, v = (F.pad(t, (0, dp - d)) for t in (q, k, v))
    if needs_grad(q, k, v):
        if bias is not None and bias.requires_grad:
            raise ValueError("flash_attention on the card takes a constant "
                             "bias: its backward gives the bias no gradient")
        out = _FlashAttention.apply(q, k, v, bias, scale, True)
    else:
        out = flash_attention_op(q, k, v, bias, scale)
    out = out if q.ndim == 3 else out.transpose(1, 2)
    return out if dp == d else out[..., :d]


flash_attention.launches = 0  # kernel launches since the last reset
flash_attention_backward.launches = 0  # backward calls (2 kernels each)
# of those, the launches on f32 inputs (the split-TF32 route)
flash_attention.f32_launches = 0
flash_attention_backward.f32_launches = 0
