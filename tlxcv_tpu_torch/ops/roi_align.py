"""RoIAlign and mask paste (counterpart of ``tlxcv_tpu/ops/roi_align.py``),
torchvision ``aligned=True`` semantics: sample coordinates are shifted by
half a pixel, samples outside (-1, size) give zero, and a sample in (-1, 0)
is clamped to the edge row (torchvision's ``y <= 0 -> y = 0``).

``multilevel_roi_align`` is the reference's batched formulation
(``roi_align.py:86-141``): every FPN level is packed so that row (y, x)
holds the four bilinear corners of a sample, the levels are flattened into
one ``[N · ΣHW, 4C]`` table, and one ``gather_rows`` call over the whole
batch fetches every sample's row.  For a CUDA table that call is the
hand-written kernel; for a CPU one, its plain version.

With a bf16 feature table and the f32 bilinear weights the result is f32,
as in the reference, so the heads after it run in f32.

Gradients flow as in the reference: into the feature table through the
row gather's scatter-add, and into the boxes through the sampling
coordinates (nothing is detached; torchvision detaches the proposals, the
reference does not).  The clamps are ``torch.maximum``/``torch.minimum``
(``ops.boxes.clip``), which split the gradient 0.5/0.5 at a tie as JAX's
``maximum``, ``minimum`` and ``clip`` do (``clamp`` passes all of it).
"""
from __future__ import annotations

import functools

import torch

from .boxes import clip
from .cuda.gather import gather_rows

__all__ = ["roi_align", "multilevel_roi_align", "paste_masks"]


def _pack4(f):
    """[N, H, W, C] -> [N, H, W, 4C]: row (y, x) carries (y, x), (y, x+1),
    (y+1, x), (y+1, x+1), edge-replicated, which is exactly the clamped
    corner indexing of a bilinear sample at (y, x)."""
    sx = torch.cat([f[:, :, 1:], f[:, :, -1:]], dim=2)
    sy = torch.cat([f[:, 1:], f[:, -1:]], dim=1)
    sxy = torch.cat([sy[:, :, 1:], sy[:, :, -1:]], dim=2)
    return torch.cat([f, sx, sy, sxy], dim=-1)


@functools.lru_cache(maxsize=16)
def _level_tables(hws, strides, device):
    """(row offset, height, width) of each level in the flattened table,
    int32, and the strides, f32: constants on ``device``."""
    offs, acc = [], 0
    for h, w in hws:
        offs.append(acc)
        acc += h * w
    i32 = dict(dtype=torch.int32, device=device)
    return (torch.tensor(offs, **i32), torch.tensor([h for h, _ in hws], **i32),
            torch.tensor([w for _, w in hws], **i32),
            torch.tensor(strides, dtype=torch.float32, device=device))


def multilevel_roi_align(feats, boxes, output_size: int = 7,
                         sampling_ratio: int = 2, strides=(4, 8, 16, 32)):
    """FPN RoIAlign with each box on its canonical level.

    feats: list of [N, H_l, W_l, C] (P2..P5; more levels are ignored);
    boxes [N, R, 4] xyxy image pixels.  Returns [N, R, S, S, C], f32 for an
    f32 or bf16 table and f32 boxes."""
    n, _, _, c = feats[0].shape
    levels = feats[:len(strides)]
    hws = tuple(tuple(f.shape[1:3]) for f in levels)
    flat = torch.cat([_pack4(f).reshape(n, -1, 4 * c) for f in levels], 1)
    level_off, level_h, level_w, stride_arr = _level_tables(
        hws, tuple(strides), boxes.device)
    s, sr = output_size, sampling_ratio

    # canonical level: k0 + log2(sqrt(area) / 224), clamped to P2..P5
    area = (clip(boxes[..., 2] - boxes[..., 0], 1.0)
            * clip(boxes[..., 3] - boxes[..., 1], 1.0))
    k = torch.floor(4 + torch.log2(torch.sqrt(area) / 224.0 + 1e-9))
    k = (torch.clamp(k, 2, 5) - 2).long()                # [N, R] in 0..3

    scale = 1.0 / stride_arr[k]                          # [N, R]
    b = boxes * scale[..., None]
    x1, y1, x2, y2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    bin_h = clip(y2 - y1, 1.0) / s
    bin_w = clip(x2 - x1, 1.0) / s
    iy = (torch.arange(s * sr, dtype=torch.float32, device=boxes.device)
          + 0.5) / sr
    ys = y1[..., None] + bin_h[..., None] * iy - 0.5     # [N, R, S']
    xs = x1[..., None] + bin_w[..., None] * iy - 0.5
    hk = level_h[k].float()[..., None]                   # [N, R, 1]
    wk = level_w[k].float()[..., None]

    vy = ((ys > -1.0) & (ys < hk))[..., :, None]
    vx = ((xs > -1.0) & (xs < wk))[..., None, :]
    ys = torch.minimum(clip(ys, 0.0), hk - 1)           # edge clamp
    xs = torch.minimum(clip(xs, 0.0), wk - 1)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy1 = (ys - y0)[..., :, None, None]                  # [N, R, S', 1, 1]
    wx1 = (xs - x0)[..., None, :, None]                  # [N, R, 1, S', 1]
    valid = (vy & vx)[..., None]

    row0 = level_off[k][..., None] + y0.int() * level_w[k][..., None]
    idx = row0[..., :, None] + x0.int()[..., None, :]    # [N, R, S', S']
    total = flat.shape[1]
    gidx = idx + (torch.arange(n, dtype=torch.int32, device=idx.device)
                  * total)[:, None, None, None]
    v = gather_rows(flat.reshape(n * total, 4 * c), gidx.reshape(-1))
    v = v.reshape(*idx.shape, 4 * c)
    v00, v01, v10, v11 = v.split(c, dim=-1)
    out = (v00 * (1 - wy1) * (1 - wx1) + v01 * (1 - wy1) * wx1
           + v10 * wy1 * (1 - wx1) + v11 * wy1 * wx1)
    out = torch.where(valid, out, 0.0)
    r = out.shape[1]
    if sr > 1:
        out = out.reshape(n, r, s, sr, s, sr, c).mean(dim=(3, 5))
    return out


def _bilinear_gather(feat, ys, xs, batch_index=None):
    """feat [B, H, W, C]; ys, xs [B', ...] float coordinates -> [B', ...,
    C], row b of the coordinates sampling image ``batch_index[b]`` of feat
    (image b when not given).  Out-of-bounds samples give zero; coordinates
    are clamped before the weights, as torchvision's
    bilinear_interpolate."""
    _, h, w, _ = feat.shape
    valid = ((ys > -1.0) & (ys < h) & (xs > -1.0) & (xs < w))[..., None]
    ys = clip(ys, 0.0, h - 1.0)
    xs = clip(xs, 0.0, w - 1.0)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy1 = (ys - y0)[..., None]
    wx1 = (xs - x0)[..., None]
    y0i = y0.long()
    y1i = (y0i + 1).clamp(0, h - 1)
    x0i = x0.long()
    x1i = (x0i + 1).clamp(0, w - 1)
    if batch_index is None:
        batch_index = torch.arange(ys.shape[0], device=feat.device)
    bi = batch_index.reshape(-1, *(1,) * (ys.ndim - 1))
    v00, v01 = feat[bi, y0i, x0i], feat[bi, y0i, x1i]
    v10, v11 = feat[bi, y1i, x0i], feat[bi, y1i, x1i]
    out = (v00 * (1 - wy1) * (1 - wx1) + v01 * (1 - wy1) * wx1 +
           v10 * wy1 * (1 - wx1) + v11 * wy1 * wx1)
    return torch.where(valid, out, 0.0)


def roi_align(features, boxes, output_size: int = 7,
              spatial_scale: float = 1.0, sampling_ratio: int = 2,
              batch_index=None):
    """features [B, H, W, C]; boxes [N, R, 4] xyxy in image coordinates,
    row n of them on image ``batch_index[n]`` of features (image n when not
    given, N = B).  Returns [N, R, S, S, C] (S = output_size)."""
    s, sr = output_size, sampling_ratio
    b = boxes * spatial_scale
    x1, y1, x2, y2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    bin_h = clip(y2 - y1, 1.0) / s
    bin_w = clip(x2 - x1, 1.0) / s
    iy = (torch.arange(s * sr, dtype=torch.float32, device=boxes.device)
          + 0.5) / sr
    ys = y1[..., None] + bin_h[..., None] * iy           # [N, R, S']
    xs = x1[..., None] + bin_w[..., None] * iy
    n, r, m = ys.shape
    yy = ys[..., :, None].expand(n, r, m, m)
    xx = xs[..., None, :].expand(n, r, m, m)
    vals = _bilinear_gather(features, yy - 0.5, xx - 0.5, batch_index)
    c = vals.shape[-1]
    return vals.reshape(n, r, s, sr, s, sr, c).mean(dim=(3, 5))


def paste_masks(masks, boxes, image_hw):
    """Paste per-RoI masks into full-image masks: masks [R, M, M] (logits or
    probabilities), boxes [R, 4] xyxy pixels -> [R, H, W], each mask
    bilinearly resampled into its box, zero outside it."""
    h, w = image_hw
    m = masks.shape[-1]
    x1, y1, x2, y2 = boxes.unbind(-1)
    bw = clip(x2 - x1, 1.0)[:, None]
    bh = clip(y2 - y1, 1.0)[:, None]
    f32 = dict(dtype=torch.float32, device=masks.device)
    ys = (torch.arange(h, **f32) + 0.5 - y1[:, None]) / bh * m - 0.5  # [R, H]
    xs = (torch.arange(w, **f32) + 0.5 - x1[:, None]) / bw * m - 0.5  # [R, W]
    r = masks.shape[0]
    yy = ys[:, :, None].expand(r, h, w)
    xx = xs[:, None, :].expand(r, h, w)
    return _bilinear_gather(masks[..., None], yy, xx)[..., 0]
