"""DPN-68/107 and DLA-34/102 (counterpart of
``tlxcv_tpu/models/classification/dpn_dla.py``), NHWC.

A dual-path block carries a residual path (the first ``num_1x1_c``
channels, added) and a dense path (the rest, concatenated).  DLA's trees
nest: a tree of level L holds two trees of level L - 1, or at level 1 two
blocks and a root that aggregates them with the children handed down.
"""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ...device import resolve_device

__all__ = ["DPN", "dpn68", "dpn107", "DLA", "dla34", "dla102"]


class BnActConv(tnn.Module):
    def __init__(self, cin, cout, k, stride=1, groups=1, device=None,
                 generator=None):
        super().__init__()
        self.bn = nn.BatchNorm(cin, device=device)
        self.conv = nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                              groups=groups, bias=False, device=device,
                              generator=generator)

    def forward(self, x):
        return self.conv(nn.relu(self.bn(x)))


class DualPathBlock(tnn.Module):
    """Residual + dense dual path; takes and returns ``(res, dense)``
    (the first block takes one tensor)."""

    def __init__(self, cin, num_1x1_a, num_3x3_b, num_1x1_c, inc, groups,
                 block_type="normal", device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.num_1x1_c = num_1x1_c
        self.inc = inc
        stride = 2 if block_type == "down" else 1
        self.has_proj = block_type in ("proj", "down")
        if self.has_proj:
            self.proj = BnActConv(cin, num_1x1_c + 2 * inc, 1, stride, **kw)
        self.a = BnActConv(cin, num_1x1_a, 1, **kw)
        self.b = BnActConv(num_1x1_a, num_3x3_b, 3, stride, groups, **kw)
        self.c = BnActConv(num_3x3_b, num_1x1_c + inc, 1, **kw)

    def forward(self, x):
        if isinstance(x, tuple):
            res, dense = x
            inp = torch.cat([res, dense], -1)
        else:
            inp = x
            res = dense = None
        c = self.num_1x1_c
        if self.has_proj:
            p = self.proj(inp)
            res, dense = p[..., :c], p[..., c:]
        out = self.c(self.b(self.a(inp)))
        return res + out[..., :c], torch.cat([dense, out[..., c:]], -1)


class DPN(tnn.Module):
    """``small=True``: DPN-68's 3x3 stem and widths; otherwise the large
    DPNs' 7x7 stem and widths (DPN-107: k_r 200, 50 groups)."""

    def __init__(self, num_classes=1000, small=True, k_r=128, groups=32,
                 inc_sec=(16, 32, 32, 64), k_sec=(3, 4, 12, 3), stem_ch=10,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        bw = (64, 128, 256, 512) if small else (256, 512, 1024, 2048)
        r_div = 64 if small else 256
        k = 3 if small else 7
        self.stem = nn.Sequential(
            nn.Conv2d(3, stem_ch, k, stride=2, padding=k // 2, bias=False,
                      **kw),
            nn.BatchNorm(stem_ch, device=device), nn.Activation("relu"),
            nn.MaxPool2d(3, 2, 1))
        blocks = []
        cin = stem_ch
        for si in range(4):
            r = k_r * bw[si] // r_div
            for bi in range(k_sec[si]):
                btype = ("proj" if si == 0 else "down") if bi == 0 \
                    else "normal"
                blocks.append(DualPathBlock(cin, r, r, bw[si], inc_sec[si],
                                            groups, btype, **kw))
                # res (bw) + dense (2 inc from the projection, one a block)
                cin = bw[si] + (bi + 3) * inc_sec[si]
        self.blocks = tnn.ModuleList(blocks)
        self.final_bn = nn.BatchNorm(cin, device=device)
        self.pool = nn.GlobalAvgPool2d()
        self.fc = nn.Linear(cin, num_classes, **kw)

    def forward(self, x):
        out = self.stem(x)
        for b in self.blocks:
            out = b(out)
        out = nn.relu(self.final_bn(torch.cat(out, -1)))
        return self.fc(self.pool(out))


def dpn68(pretrained=False, **kw):
    return DPN(**kw)


def dpn107(pretrained=False, **kw):
    return DPN(small=False, k_r=200, groups=50, inc_sec=(20, 64, 64, 128),
               k_sec=(4, 8, 20, 3), stem_ch=128, **kw)


class DLABasic(tnn.Module):
    def __init__(self, cin, cout, stride=1, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv1 = nn.Conv2d(cin, cout, 3, stride=stride, padding=1,
                               bias=False, **kw)
        self.bn1 = nn.BatchNorm(cout, device=device)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, bias=False, **kw)
        self.bn2 = nn.BatchNorm(cout, device=device)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        out = nn.relu(self.bn1(self.conv1(x)))
        return nn.relu(self.bn2(self.conv2(out)) + residual)


class DLARoot(tnn.Module):
    """1x1 conv over the concatenated children; DLA-102's roots add the
    first child."""

    def __init__(self, cin, cout, residual=False, device=None,
                 generator=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1, bias=False, device=device,
                              generator=generator)
        self.bn = nn.BatchNorm(cout, device=device)
        self.residual = residual

    def forward(self, children):
        x = self.bn(self.conv(torch.cat(children, -1)))
        if self.residual:
            x = x + children[0]
        return nn.relu(x)


class DLABottleneck(tnn.Module):
    """1-3-1 bottleneck (expansion 2) of the large DLAs."""

    def __init__(self, cin, cout, stride=1, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        mid = cout // 2
        self.conv1 = nn.Conv2d(cin, mid, 1, bias=False, **kw)
        self.bn1 = nn.BatchNorm(mid, device=device)
        self.conv2 = nn.Conv2d(mid, mid, 3, stride=stride, padding=1,
                               bias=False, **kw)
        self.bn2 = nn.BatchNorm(mid, device=device)
        self.conv3 = nn.Conv2d(mid, cout, 1, bias=False, **kw)
        self.bn3 = nn.BatchNorm(cout, device=device)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        out = nn.relu(self.bn1(self.conv1(x)))
        out = nn.relu(self.bn2(self.conv2(out)))
        return nn.relu(self.bn3(self.conv3(out)) + residual)


class DLATree(tnn.Module):
    def __init__(self, levels, cin, cout, stride=1, root_dim=0,
                 level_root=False, block=None, root_residual=False,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        block = block or DLABasic
        if root_dim == 0:
            root_dim = 2 * cout
        if level_root:
            root_dim += cin
        self.level_root = level_root
        self.levels = levels
        if levels == 1:
            self.tree1 = block(cin, cout, stride, **kw)
            self.tree2 = block(cout, cout, **kw)
            self.root = DLARoot(root_dim, cout, root_residual, **kw)
        else:
            self.tree1 = DLATree(levels - 1, cin, cout, stride, block=block,
                                 root_residual=root_residual, **kw)
            self.tree2 = DLATree(levels - 1, cout, cout,
                                 root_dim=root_dim + cout, block=block,
                                 root_residual=root_residual, **kw)
            self.root = None
        self.downsample = nn.MaxPool2d(stride, stride) if stride > 1 \
            else None
        self.project = None
        if cin != cout:
            self.project = nn.Sequential(
                nn.Conv2d(cin, cout, 1, bias=False, **kw),
                nn.BatchNorm(cout, device=device))

    def forward(self, x, children=None):
        children = [] if children is None else children
        bottom = self.downsample(x) if self.downsample else x
        residual = self.project(bottom) if self.project else bottom
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            x1 = self.tree1(x, residual)
            x2 = self.tree2(x1)
            return self.root([x2, x1] + children)
        x1 = self.tree1(x)
        children.append(x1)
        return self.tree2(x1, children)


class DLA(tnn.Module):
    def __init__(self, num_classes=1000, levels=(1, 1, 1, 2, 2, 1),
                 channels=(16, 32, 64, 128, 256, 512), block=None,
                 root_residual=False, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.base = nn.Sequential(
            nn.Conv2d(3, channels[0], 7, padding=3, bias=False, **kw),
            nn.BatchNorm(channels[0], device=device), nn.Activation("relu"))
        self.level0 = nn.Sequential(
            nn.Conv2d(channels[0], channels[0], 3, padding=1, bias=False,
                      **kw),
            nn.BatchNorm(channels[0], device=device), nn.Activation("relu"))
        self.level1 = nn.Sequential(
            nn.Conv2d(channels[0], channels[1], 3, stride=2, padding=1,
                      bias=False, **kw),
            nn.BatchNorm(channels[1], device=device), nn.Activation("relu"))
        kw.update(block=block, root_residual=root_residual)
        self.level2 = DLATree(levels[2], channels[1], channels[2], 2, **kw)
        self.level3 = DLATree(levels[3], channels[2], channels[3], 2,
                              level_root=True, **kw)
        self.level4 = DLATree(levels[4], channels[3], channels[4], 2,
                              level_root=True, **kw)
        self.level5 = DLATree(levels[5], channels[4], channels[5], 2,
                              level_root=True, **kw)
        self.pool = nn.GlobalAvgPool2d()
        self.fc = nn.Linear(channels[5], num_classes, device=device,
                            generator=generator)

    def forward(self, x):
        x = self.level1(self.level0(self.base(x)))
        x = self.level5(self.level4(self.level3(self.level2(x))))
        return self.fc(self.pool(x))


def dla34(pretrained=False, **kw):
    return DLA(**kw)


def dla102(pretrained=False, **kw):
    # bottleneck blocks and residual roots
    return DLA(levels=(1, 1, 1, 3, 4, 1),
               channels=(16, 32, 128, 256, 512, 1024),
               block=DLABottleneck, root_residual=True, **kw)
