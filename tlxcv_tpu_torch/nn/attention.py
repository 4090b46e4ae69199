"""Multi-head attention (counterpart of ``tlxcv_tpu/nn/attention.py``).

``scaled_dot_product_attention`` is the single kernel boundary: every float
call goes through ``ops.cuda.attention.flash_attention``, which launches the
hand-written kernel for a CUDA tensor and takes its plain version only for
a CPU tensor.  There is no switch that leaves the plain version on the card.

The one switch is the reference's opt-in dynamic-int8 attention
(``use_int8_attention`` globally, ``use_int8=True`` per call), which
computes a different function: q, k and v quantized per head, the
probabilities per row, both products int8 x int8 -> int32, the softmax in
f32.  It is serving-only and raises where autograd would record.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..core import init as I
from ..device import full_f32, resolve_device
from ..ops.cuda.attention import flash_attention
from .layers import Dropout, Linear

__all__ = ["scaled_dot_product_attention", "MultiHeadAttention", "Attention",
           "use_int8_attention", "int8_products", "int8_products_plain",
           "INT8_EXACT_K", "INT8_INT32_K"]

_INT8_DEFAULT = False

# An int8 x int8 product summed over K stays an integer below 2**24, so
# exact in f32 whatever the order of the sums, while K * 127**2 < 2**24.
INT8_EXACT_K = (2 ** 24 - 1) // 127 ** 2  # 1040
# ... and an int32 sum of them holds while K * 127**2 < 2**31.
INT8_INT32_K = (2 ** 31 - 1) // 127 ** 2  # 133,144


def use_int8_attention(enabled: bool = True):
    """Make ``use_int8=None`` calls take the int8 path (the reference's
    ``use_int8_attention``)."""
    global _INT8_DEFAULT
    _INT8_DEFAULT = bool(enabled)


def int8_products_plain(a, b):
    """[..., M, K] int8 @ [..., K, N] int8 -> [..., M, N] int32 on the CPU,
    as the reference's ``preferred_element_type=jnp.int32`` einsums: the
    reference that ``int8_products`` is held to."""
    return torch.matmul(a.int(), b.int())


def int8_products(a, b):
    """[..., M, K] int8 @ [..., K, N] int8 -> the int32 sums, cast to f32
    once, as the reference's ``preferred_element_type=jnp.int32`` einsums
    followed by ``.astype(jnp.float32)``.

    Each product is the f32 product of the codes, exact for K <=
    ``INT8_EXACT_K`` (every partial sum is an integer below 2**24).  A
    longer K is cut into chunks of at most ``INT8_EXACT_K``; each chunk's
    exact f32 product becomes int32, the partials are summed in int32, and
    the total is cast to f32 once (which rounds above 2**24, as the
    reference's cast does).  int32 holds K * 127**2 only up to K =
    ``INT8_INT32_K``: a longer K raises.  On the card TF32 is turned off
    for the call, whatever the caller set, so that exactness rests on
    IEEE f32 alone (TF32 keeps 11 significant bits of each operand, which
    holds an int8 code, and gave the same sums on an H100; but that is the
    tensor cores' behaviour, not a contract).  (PyTorch has no batched
    int8 product on CUDA, and ``torch._int_mm`` takes 2-D operands with N
    a multiple of 8, which S = 197 is not.)"""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_products needs int8 operands, got "
                        f"{a.dtype}/{b.dtype}")
    k = a.shape[-1]
    if b.shape[-2] != k:
        raise ValueError(f"inner dims mismatch: {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if k > INT8_INT32_K:
        raise ValueError(f"K = {k} > {INT8_INT32_K}: an int32 sum of K "
                         f"int8 products overflows past K = {INT8_INT32_K}")
    with full_f32():
        if k <= INT8_EXACT_K:
            return torch.matmul(a.float(), b.float())
        total = None
        for k0 in range(0, k, INT8_EXACT_K):
            part = torch.matmul(a[..., k0:k0 + INT8_EXACT_K].float(),
                                b[..., k0:k0 + INT8_EXACT_K, :].float())
            part = part.to(torch.int32)
            total = part if total is None else total.add_(part)
        return total.float()


def _quant_dyn(t, eps=1e-6):
    """Symmetric per-head int8: abs-max over the trailing (seq, dim) axes.
    Returns (int8 codes, f32 scale broadcastable against them)."""
    tf = t.float()
    s = torch.clamp_min(tf.abs().amax(dim=(-2, -1), keepdim=True), eps) / 127.0
    q = torch.round(tf / s).clamp(-127, 127)
    return q.to(torch.int8), s


def _int8_sdpa(q, k, v, mask, scale):
    """The reference's ``_int8_sdpa`` in its order of operations: the
    int32 scores times ``qs * ks * scale``, the mask, the f32 softmax, the
    probabilities quantized per row (max / 127, no clip), the int32 P.V
    times ``ps * vs``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("int8 attention is serving-only and has no "
                           "gradient: call it under torch.no_grad() or "
                           "torch.inference_mode()")
    qi, qs = _quant_dyn(q)
    ki, ks = _quant_dyn(k)
    attn = int8_products(qi, ki.transpose(-1, -2)) * (qs * ks * scale)
    if mask is not None:
        attn = attn + mask
    p = torch.softmax(attn, dim=-1)
    # per-row scale: rows sum to 1 but the max can be ~1/S under uniform
    # attention, where a fixed 1/127 scale would lose most of the mantissa
    ps = torch.clamp_min(p.amax(dim=-1, keepdim=True), 1e-6) / 127.0
    pi = torch.round(p / ps).to(torch.int8)
    vi, vs = _quant_dyn(v)
    out = int8_products(pi, vi) * (ps * vs)
    return out.to(v.dtype)


def scaled_dot_product_attention(q, k, v, mask=None, scale=None,
                                 use_int8=None):
    """q: [..., heads, q_len, head_dim]; k, v: [..., heads, k_len,
    head_dim] (k_len may differ from q_len, as in DETR's cross-attention).
    mask: additive (-inf for disallowed), broadcastable to [..., heads,
    q_len, k_len].  ``use_int8`` (``None``: the ``use_int8_attention``
    default) takes the int8 path."""
    lead = q.shape[:-2]
    s, d = q.shape[-2:]
    scale = d ** -0.5 if scale is None else scale
    if _INT8_DEFAULT if use_int8 is None else use_int8:
        return _int8_sdpa(q, k, v, mask, scale)
    out_dtype = v.dtype
    if not q.dtype == k.dtype == v.dtype:
        # the reference's einsums promote mixed inputs (TrOCR's bf16
        # queries over an f32 memory under the Trainer's bf16 policy): the
        # kernel takes them in the promoted dtype
        dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype),
                                 v.dtype)
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
    bh = math.prod(lead)
    if q.ndim == 4:  # [B, H, S, D] views go to the kernel as they are
        qf, kf, vf = q, k, v
    else:
        qf, kf, vf = (t.reshape(bh, t.shape[-2], d) for t in (q, k, v))
    bias = None
    if mask is not None:
        kv = k.shape[-2]
        if mask.ndim <= 2 or all(n == 1 for n in mask.shape[:-2]):
            # batch/head-invariant mask: one [1, Sq, Sk] bias, not BH copies
            shape = (1, s, kv) if mask.ndim <= 2 else (*mask.shape[:-2], s, kv)
            bias = torch.broadcast_to(mask, shape).reshape(1, s, kv)
        else:
            bias = torch.broadcast_to(mask, (*lead, s, kv)).reshape(bh, s, kv)
        bias = bias.float().contiguous()
    out = flash_attention(qf, kf, vf, bias=bias, scale=scale)
    return out.reshape(*lead, s, d).to(out_dtype)


class MultiHeadAttention(nn.Module):
    """Packed-QKV MHA over [B, N, C] tokens (ViT style)."""

    def __init__(self, dim, num_heads=8, qkv_bias=False, qk_scale=None,
                 attn_drop=0.0, proj_drop=0.0, device=None, generator=None):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not a multiple of num_heads "
                             f"{num_heads}")
        device = resolve_device(device)
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.scale = qk_scale or self.head_dim ** -0.5
        self.qkv = Linear(dim, dim * 3, bias=qkv_bias, w_init=I.xavier_uniform,
                          device=device, generator=generator)
        self.attn_drop = Dropout(attn_drop)
        self.proj = Linear(dim, dim, w_init=I.xavier_uniform, device=device,
                           generator=generator)
        self.proj_drop = Dropout(proj_drop)

    def forward(self, x, mask=None):
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)  # [3, B, H, N, D]
        out = scaled_dot_product_attention(q, k, v, mask=mask,
                                           scale=self.scale)
        out = out.permute(0, 2, 1, 3).reshape(b, n, c)
        return self.proj_drop(self.proj(out))


Attention = MultiHeadAttention
