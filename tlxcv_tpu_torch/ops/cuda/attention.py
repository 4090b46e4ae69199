"""Flash attention: the Hopper kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``tlxcv_tpu/ops/pallas/attention.py``
(``flash_attention`` :108).  The kernel is ``csrc/flash_attention.cu``; its
source note says what bounds it on the H100 and how its design meets that.
The TPU layout devices of the reference (``block_q``/``block_k``, ``nb``,
``pad_d``, ``interpret``) have no counterpart: block sizes are the kernel's
own choice.

``flash_attention`` takes the plain version for a tensor on the CPU, which
autograd differentiates.  For a CUDA tensor it launches the kernel or
raises; it never falls back.  The kernel reads q, k, v through their
strides: a ``[B, H, S, D]`` view into a packed qkv projection needs no copy.
On the card the call is a ``torch.autograd.Function`` whose forward is the
kernel: its output carries a ``grad_fn``, and a backward through it raises
``NotImplementedError`` until the backward kernel lands (ROADMAP queue 2
item 2), so no gradient silently comes back as zeros.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_plain", "NEG"]

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


def flash_attention_plain(q, k, v, bias=None, scale=None):
    """The kernel's arithmetic in plain torch: f32 scores, bias added and
    clamped at ``NEG``, f32 softmax statistics, P cast to v's dtype before
    P.V, normalised at the end, output in q's dtype."""
    _check_shapes(q, k, v, bias)
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else float(scale)
    q3, k3, v3 = (t.reshape(-1, t.shape[-2], d).float() for t in (q, k, v))
    logits = torch.einsum("bqd,bkd->bqk", q3, k3) * scale
    if bias is not None:
        logits = torch.clamp_min(logits + bias.float(), NEG)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    out = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), v3)
    return (out / p.sum(-1, keepdim=True)).to(q.dtype).reshape(q.shape)


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


def _kernel_fn():
    fn = _build.library("flash_attention").tlx_flash_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, p, i, ctypes.c_float,
                       i, p]
        fn.restype = i
    return fn


def _error_string(rc):
    fn = _build.library("flash_attention").tlx_cuda_error_string
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
    return fn(rc).decode()


def _bhs_strides(t):
    """(batch, head, row) element strides; a 3D tensor is one batch."""
    return (0, *t.stride()[:2]) if t.ndim == 3 else t.stride()[:3]


def _launch_kernel(q, k, v, bias, scale):
    """One kernel launch: [BH, Sq, D] contiguous, or [B, Sq, H, D] (the
    token-major store of a 4D call), in q's dtype."""
    if q.device.index != torch.cuda.current_device():
        with torch.cuda.device(q.device):
            return _launch_kernel(q, k, v, bias, scale)
    sq, d = q.shape[-2:]
    batch, heads = (1, q.shape[0]) if q.ndim == 3 else q.shape[:2]
    fn = _kernel_fn()
    if q.ndim == 3:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
    else:
        out = q.new_empty(batch, sq, heads, d)
    view = out if q.ndim == 3 else out.transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *_bhs_strides(q), *_bhs_strides(k), *_bhs_strides(v),
        *_bhs_strides(view))
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            batch, heads, sq, k.shape[-2], d, strides,
            int(bias is not None and bias.shape[0] == batch * heads),
            scale, _KERNEL_DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"{_error_string(rc)} ({rc})")
    flash_attention.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """The kernel as an autograd node: forward launches it; backward has
    no kernel yet and raises rather than hand back zeros."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        return _launch_kernel(q, k, v, bias, scale)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "flash_attention on the card has no backward kernel yet "
            "(ROADMAP queue 2 item 2); gradients through attention are "
            "taken on the CPU only")


def flash_attention(q, k, v, bias=None, scale=None):
    """softmax(q kᵀ·scale + bias)·v.  q: [BH, Sq, D] or [B, H, Sq, D]; k,
    v: [BH, Sk, D] or [B, H, Sk, D] with q's leading dims and D (any key
    length: DETR's cross-attention has 100 queries over H·W keys); any
    strides over a contiguous head dim; bias: optional additive [1|BH, Sq,
    Sk] (BH = B·H); scale defaults to D**-0.5.  Returns q's shape in q's
    dtype: [BH, Sq, D] contiguous, or [B, H, Sq, D] stored token-major (a
    view of [B, Sq, H, D]).  On the card the result has a ``grad_fn``
    whose backward raises ``NotImplementedError``."""
    _check_shapes(q, k, v, bias)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, bias, scale)
    _check_kernel_inputs(q, k, v, bias)
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    out = _FlashAttention.apply(q, k, v, bias, scale)
    return out if q.ndim == 3 else out.transpose(1, 2)


flash_attention.launches = 0  # kernel launches since the last reset
