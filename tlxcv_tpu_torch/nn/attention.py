"""Multi-head attention (counterpart of ``tlxcv_tpu/nn/attention.py``).

``scaled_dot_product_attention`` is the single kernel boundary: every call
goes through ``ops.cuda.attention.flash_attention``, which launches the
hand-written kernel for a CUDA tensor and takes its plain version only for
a CPU tensor.  There is no switch that leaves the plain version on the card.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..core import init as I
from ..device import resolve_device
from ..ops.cuda.attention import flash_attention
from .layers import Dropout, Linear

__all__ = ["scaled_dot_product_attention", "MultiHeadAttention", "Attention"]


def scaled_dot_product_attention(q, k, v, mask=None, scale=None,
                                 use_int8=None):
    """q, k, v: [..., heads, seq, head_dim].  mask: additive (-inf for
    disallowed), broadcastable to [..., heads, q_len, k_len]."""
    if use_int8:
        raise NotImplementedError("int8 attention (the reference's "
                                  "_int8_sdpa) is not ported yet")
    lead = q.shape[:-2]
    s, d = q.shape[-2:]
    scale = d ** -0.5 if scale is None else scale
    bh = math.prod(lead)
    if q.ndim == 4:  # [B, H, S, D] views go to the kernel as they are
        qf, kf, vf = q, k, v
    else:
        qf, kf, vf = (t.reshape(bh, t.shape[-2], d) for t in (q, k, v))
    bias = None
    if mask is not None:
        kv = k.shape[-2]
        if mask.ndim <= 2 or all(n == 1 for n in mask.shape[:-2]):
            # batch/head-invariant mask: one [1, S, S] bias, not BH copies
            shape = (1, s, kv) if mask.ndim <= 2 else (*mask.shape[:-2], s, kv)
            bias = torch.broadcast_to(mask, shape).reshape(1, s, kv)
        else:
            bias = torch.broadcast_to(mask, (*lead, s, kv)).reshape(bh, s, kv)
        bias = bias.float().contiguous()
    out = flash_attention(qf, kf, vf, bias=bias, scale=scale)
    return out.reshape(*lead, s, d).to(v.dtype)


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
