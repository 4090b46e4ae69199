"""Swin Transformer (counterpart of
``tlxcv_tpu/models/classification/swin_transformer.py``), NHWC images.

Window partition and reverse are reshapes; the shifted windows' additive
mask and the relative-position index are tables built once per block
(non-persistent buffers, so they move with the module and are not
weights).  ``WindowAttention`` runs its own product and softmax with the
relative-position bias, as in the reference: plain PyTorch, no kernel of
this port.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...core import init as I
from ...device import resolve_device
from ...nn.layers import Conv2d, DropPath, Identity, LayerNorm, Linear
from .vision_transformer import Mlp

__all__ = ["SwinTransformer", "swin_tiny", "swin_small", "swin_base",
           "swin_large", "swin_transformer_base", "set_window_pack"]


def set_window_pack(model, pack: int):
    """Set the window-packing factor on every WindowAttention in ``model``
    (see ``WindowAttention``: a compute-layout knob, the parameters and the
    function unchanged).  At each stage ``pack`` must divide batch x
    windows, and a shifted block's window count too; a block that cannot
    meet that runs unpacked.  Each forward reads the factor afresh, so a
    change takes effect on the next call (the reference's jit-traced
    functions keep the factor they were traced with).  Returns the
    model."""
    for m in model.modules():
        if isinstance(m, WindowAttention):
            m.pack = pack
    return model


def window_partition(x, ws):
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(windows, ws, h, w):
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def _relative_position_index(ws):
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + ws - 1
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def _shift_attn_mask(h, w, ws, shift):
    """Additive mask [num_windows, ws*ws, ws*ws] for shifted windows."""
    img_mask = np.zeros((1, h, w, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    mw = np.reshape(
        img_mask.reshape(1, h // ws, ws, w // ws, ws, 1)
        .transpose(0, 1, 3, 2, 4, 5), (-1, ws * ws))
    attn = mw[:, None, :] - mw[:, :, None]
    return np.where(attn != 0, -100.0, 0.0).astype(np.float32)


def _block_diagonal(blocks, fill):
    """[..., p, n, n] -> [..., p*n, p*n]: the blocks on the diagonal,
    ``fill`` elsewhere."""
    *lead, p, n, _ = blocks.shape
    big = blocks.new_full((*lead, p * n, p * n), fill)
    for i in range(p):
        big[..., i * n:(i + 1) * n, i * n:(i + 1) * n] = blocks[..., i, :, :]
    return big


class WindowAttention(nn.Module):
    """Per-window multi-head self-attention with a relative-position bias.

    ``pack`` (default 1, set by ``set_window_pack``): run groups of ``pack``
    windows as one [pack*ws², pack*ws²] attention with a block-diagonal
    bias (-100 on the cross-window blocks, the additive-mask trick of the
    shifted windows).  The parameters are the same and the function too,
    up to exp(-100) of cross-window leakage; the reference used it to fill
    the TPU's 128-wide tiles with 49-token windows.
    """

    def __init__(self, dim, ws, num_heads, qkv_bias=True, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.scale = self.head_dim ** -0.5
        self.ws = ws
        self.pack = 1
        self.qkv = Linear(dim, dim * 3, bias=qkv_bias, **kw)
        self.proj = Linear(dim, dim, **kw)
        self.rel_bias = nn.Parameter(I.truncated_normal(
            ((2 * ws - 1) ** 2, num_heads), std=0.02, **kw))
        self.register_buffer("rel_index", torch.from_numpy(
            _relative_position_index(ws)).reshape(-1).to(device),
            persistent=False)

    def _bias(self, n, dtype, p):
        bias = self.rel_bias[self.rel_index].reshape(
            n, n, self.num_heads).permute(2, 0, 1)
        if p > 1:
            bias = _block_diagonal(bias[:, None].expand(-1, p, -1, -1),
                                   -100.0)
        return bias.to(dtype)

    def forward(self, x, mask=None, pack=None):
        """x: [nW*B, ws*ws, C]; mask: [nW/pack, pack*ws², pack*ws²]
        (packed by SwinBlock) or [nW, ws*ws, ws*ws] or None."""
        bn, n, c = x.shape
        p = self.pack if pack is None else pack
        if p > 1:
            x = x.reshape(bn // p, p * n, c)
            bn, n = bn // p, p * n
        qkv = self.qkv(x).reshape(bn, n, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        attn = (q * self.scale) @ k.transpose(-1, -2)
        attn = attn + self._bias(self.ws * self.ws, attn.dtype, p)[None]
        if mask is not None:
            if p > 1 and mask.shape[-1] * p == n:
                # the raw per-window mask (direct use of this module):
                # packed here, the per-window masks on the diagonal, zeros
                # elsewhere (the cross-window -100 rides the packed bias)
                nw0, n0 = mask.shape[0], mask.shape[-1]
                mask = _block_diagonal(mask.reshape(nw0 // p, p, n0, n0), 0.0)
            nw = mask.shape[0]
            attn = attn.reshape(bn // nw, nw, self.num_heads, n, n)
            attn = attn + mask[None, :, None].to(attn.dtype)
            attn = attn.reshape(bn, self.num_heads, n, n)
        attn = torch.softmax(attn, -1)
        out = (attn @ v).permute(0, 2, 1, 3).reshape(bn, n, c)
        if p > 1:
            out = out.reshape(bn * p, n // p, c)
        return self.proj(out)


class SwinBlock(nn.Module):
    def __init__(self, dim, input_hw, num_heads, ws=7, shift=0, mlp_ratio=4.0,
                 qkv_bias=True, drop_path=0.0, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        h, w = input_hw
        self.input_hw = input_hw
        if min(h, w) <= ws:
            ws, shift = min(h, w), 0
        self.ws, self.shift = ws, shift
        self.norm1 = LayerNorm(dim, device=device)
        self.attn = WindowAttention(dim, ws, num_heads, qkv_bias, **kw)
        self.norm2 = LayerNorm(dim, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), **kw)
        self.drop_path = DropPath(drop_path)
        mask = (torch.from_numpy(_shift_attn_mask(h, w, ws, shift)).to(device)
                if shift > 0 else None)
        self.register_buffer("attn_mask", mask, persistent=False)
        self._packed_masks = {}  # (pack, device) -> [nW/p, p*n, p*n]

    def _mask_for(self, p):
        """The shift mask packed ``p`` windows a group: the per-window
        masks on the diagonal blocks, zeros elsewhere (the cross-window
        -100 rides the packed relative-position bias)."""
        m = self.attn_mask
        if m is None or p == 1:
            return m
        key = (p, m.device)
        if key not in self._packed_masks:
            nw, n, _ = m.shape
            self._packed_masks[key] = _block_diagonal(
                m.reshape(nw // p, p, n, n), 0.0)
        return self._packed_masks[key]

    def forward(self, x):
        h, w = self.input_hw
        b, l, c = x.shape
        shortcut = x
        x = self.norm1(x).reshape(b, h, w, c)
        if self.shift > 0:
            x = torch.roll(x, (-self.shift, -self.shift), dims=(1, 2))
        windows = window_partition(x, self.ws)
        nw = (h // self.ws) * (w // self.ws)
        p = self.attn.pack
        if p > 1 and (windows.shape[0] % p != 0
                      or (self.attn_mask is not None and nw % p != 0)):
            p = 1  # shape-incompatible at this stage and batch: unpacked
        attn_windows = self.attn(windows, self._mask_for(p), pack=p)
        x = window_reverse(attn_windows, self.ws, h, w)
        if self.shift > 0:
            x = torch.roll(x, (self.shift, self.shift), dims=(1, 2))
        x = shortcut + self.drop_path(x.reshape(b, l, c))
        return x + self.drop_path(self.mlp(self.norm2(x)))


class PatchMerging(nn.Module):
    def __init__(self, input_hw, dim, device=None, generator=None):
        super().__init__()
        self.input_hw = input_hw
        self.norm = LayerNorm(4 * dim, device=device)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False, device=device,
                                generator=generator)

    def forward(self, x):
        h, w = self.input_hw
        b, l, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, (h // 2) * (w // 2), 4 * c)
        return self.reduction(self.norm(x))


class SwinTransformer(nn.Module):
    """``device=None`` builds on the CUDA card (and raises without one);
    initial weights come from ``generator``."""

    def __init__(self, img_size=224, patch_size=4, in_chans=3,
                 num_classes=1000, embed_dim=96, depths=(2, 2, 6, 2),
                 num_heads=(3, 6, 12, 24), window_size=7, mlp_ratio=4.0,
                 qkv_bias=True, drop_path_rate=0.1, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.patch_embed = Conv2d(in_chans, embed_dim, patch_size,
                                  stride=patch_size, **kw)
        self.patch_norm = LayerNorm(embed_dim, device=device)
        hw = (img_size // patch_size, img_size // patch_size)
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        stages, mergers = [], []
        dim = embed_dim
        di = 0
        for si, (depth, heads) in enumerate(zip(depths, num_heads)):
            blocks = []
            for bi in range(depth):
                blocks.append(SwinBlock(
                    dim, hw, heads, window_size,
                    shift=0 if bi % 2 == 0 else window_size // 2,
                    mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                    drop_path=dpr[di], **kw))
                di += 1
            stages.append(nn.ModuleList(blocks))
            if si < len(depths) - 1:
                mergers.append(PatchMerging(hw, dim, **kw))
                hw = (hw[0] // 2, hw[1] // 2)
                dim *= 2
        self.stages = nn.ModuleList(stages)
        self.mergers = nn.ModuleList(mergers)
        self.norm = LayerNorm(dim, device=device)
        self.head = (Linear(dim, num_classes, **kw) if num_classes > 0
                     else Identity())
        self.num_features = dim

    def forward_features(self, x):
        x = self.patch_embed(x)
        b, h, w, c = x.shape
        x = self.patch_norm(x.reshape(b, h * w, c))
        for si, blocks in enumerate(self.stages):
            for blk in blocks:
                x = blk(x)
            if si < len(self.mergers):
                x = self.mergers[si](x)
        return self.norm(x).mean(1)

    def forward(self, x):
        return self.head(self.forward_features(x))


def swin_tiny(pretrained=False, **kw):
    return SwinTransformer(embed_dim=96, depths=(2, 2, 6, 2),
                           num_heads=(3, 6, 12, 24), **kw)


def swin_small(pretrained=False, **kw):
    return SwinTransformer(embed_dim=96, depths=(2, 2, 18, 2),
                           num_heads=(3, 6, 12, 24), **kw)


def swin_base(pretrained=False, **kw):
    return SwinTransformer(embed_dim=128, depths=(2, 2, 18, 2),
                           num_heads=(4, 8, 16, 32), **kw)


def swin_large(pretrained=False, **kw):
    return SwinTransformer(embed_dim=192, depths=(2, 2, 18, 2),
                           num_heads=(6, 12, 24, 48), **kw)


swin_transformer_base = swin_base
