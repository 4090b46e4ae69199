"""VAN, the Visual Attention Network (counterpart of
``tlxcv_tpu/models/classification/van.py``), NHWC.

The JAX model's attribute names (``stages.1.0.attn.lka.dwd``).  Large
kernel attention: a depthwise 5x5, a depthwise 7x7 at dilation 3, a 1x1,
and the input times their output.  The layer scales ``ls1`` and ``ls2``
start at 1e-2 and multiply in their own dtype, as in the reference (f32
scales lift a bf16 branch to f32).
"""
from __future__ import annotations

from torch import nn as tnn

from ... import nn
from ...core import init as I
from ...device import resolve_device

__all__ = ["VAN", "van_b0", "van_b1"]

gelu = nn.get_activation("gelu")


class LKA(tnn.Module):
    """Large-kernel attention: DW5, DW7 at dilation 3, PW."""

    def __init__(self, dim, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.dw = nn.Conv2d(dim, dim, 5, padding=2, groups=dim, **kw)
        self.dwd = nn.Conv2d(dim, dim, 7, padding=9, dilation=3, groups=dim,
                             **kw)
        self.pw = nn.Conv2d(dim, dim, 1, **kw)

    def forward(self, x):
        return x * self.pw(self.dwd(self.dw(x)))


class Attention(tnn.Module):
    def __init__(self, dim, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.proj1 = nn.Conv2d(dim, dim, 1, **kw)
        self.lka = LKA(dim, **kw)
        self.proj2 = nn.Conv2d(dim, dim, 1, **kw)

    def forward(self, x):
        return self.proj2(self.lka(gelu(self.proj1(x))))


class MLP(tnn.Module):
    def __init__(self, dim, ratio=4, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        hidden = dim * ratio
        self.fc1 = nn.Conv2d(dim, hidden, 1, **kw)
        self.dw = nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden, **kw)
        self.fc2 = nn.Conv2d(hidden, dim, 1, **kw)

    def forward(self, x):
        return self.fc2(gelu(self.dw(self.fc1(x))))


class Block(tnn.Module):
    def __init__(self, dim, mlp_ratio=4, ls_init=1e-2, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.norm1 = nn.BatchNorm(dim, device=device)
        self.attn = Attention(dim, **kw)
        self.norm2 = nn.BatchNorm(dim, device=device)
        self.mlp = MLP(dim, mlp_ratio, **kw)
        self.ls1 = tnn.Parameter(I.constant((dim,), ls_init, device=device))
        self.ls2 = tnn.Parameter(I.constant((dim,), ls_init, device=device))

    def forward(self, x):
        x = x + self.ls1 * self.attn(self.norm1(x))
        return x + self.ls2 * self.mlp(self.norm2(x))


class VAN(tnn.Module):
    def __init__(self, dims=(32, 64, 160, 256), depths=(3, 3, 5, 2),
                 num_classes=1000, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.patch_embeds = tnn.ModuleList()
        self.stages = tnn.ModuleList()
        self.norms = tnn.ModuleList()
        cin = 3
        for i, (dim, depth) in enumerate(zip(dims, depths)):
            k, s = (7, 4) if i == 0 else (3, 2)
            self.patch_embeds.append(nn.Sequential(
                nn.Conv2d(cin, dim, k, stride=s, padding=k // 2, **kw),
                nn.BatchNorm(dim, device=device)))
            self.stages.append(tnn.ModuleList([Block(dim, **kw)
                                               for _ in range(depth)]))
            self.norms.append(nn.LayerNorm(dim, device=device))
            cin = dim
        self.head = nn.Linear(dims[-1], num_classes, **kw)

    def forward(self, x):
        for embed, blocks, norm in zip(self.patch_embeds, self.stages,
                                       self.norms):
            x = embed(x)
            for blk in blocks:
                x = blk(x)
            x = norm(x)
        return self.head(x.mean((1, 2)))


def van_b0(pretrained=False, **kw):
    return VAN(dims=(32, 64, 160, 256), depths=(3, 3, 5, 2), **kw)


def van_b1(pretrained=False, **kw):
    return VAN(dims=(64, 128, 320, 512), depths=(2, 2, 4, 2), **kw)
