"""HRNet family (counterpart of ``tlxcv_tpu/models/backbones/hrnet.py``):
one core for segmentation and pose, NHWC.

Multi-resolution parallel branches exchange features in repeated
``FuseLayers``; the fusion's upsampling and ``concat_features`` are
bilinear integer upscales through ``ops.image.interpolate`` (the
reference's static-matrix route; torch ops, no kernel of this port).
Every module takes an explicit ``device`` (``None``: the CUDA card) and a
``torch.Generator`` for its initial weights.
"""
from __future__ import annotations

import torch
from torch import nn

from ...device import resolve_device
from ...nn.layers import BatchNorm, Conv2d, Identity, Sequential, relu
from ...ops.image import interpolate
from ...ops.space_to_depth import (block_space_to_depth, conv_from_hwio,
                                   oihw_to_hwio, remap_conv3x3_s1,
                                   unblock_space_to_depth)

__all__ = ["HRNet", "hrnet_w18_small_v1", "hrnet_w18_small_v2", "hrnet_w18",
           "hrnet_w30", "hrnet_w32", "hrnet_w40", "hrnet_w44", "hrnet_w48",
           "hrnet_w60", "hrnet_w64", "FuseLayers", "SpaceToDepthBranch",
           "convert_hrnet_branches_to_s2d"]


class ConvBNReLU(nn.Module):
    def __init__(self, cin, cout, k, stride=1, act=True, device=None,
                 generator=None, conv=None):
        super().__init__()
        self.conv = conv if conv is not None else Conv2d(
            cin, cout, k, stride=stride, padding=k // 2, bias=False,
            device=device, generator=generator)
        self.bn = BatchNorm(cout, device=self.conv.weight.device)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return relu(x) if self.act else x


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, cout, stride=1, downsample=False, device=None,
                 generator=None, convs=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        if convs is not None:  # prebuilt (the space-to-depth twin's)
            self.conv1, self.conv2 = convs
        else:
            self.conv1 = ConvBNReLU(cin, cout, 3, stride, **kw)
            self.conv2 = ConvBNReLU(cout, cout, 3, act=False, **kw)
        self.downsample = (ConvBNReLU(cin, cout, 1, stride, act=False, **kw)
                           if downsample else None)

    def forward(self, x):
        identity = self.downsample(x) if self.downsample is not None else x
        out = self.conv2(self.conv1(x))
        return relu(out + identity)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride=1, downsample=False, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv1 = ConvBNReLU(cin, planes, 1, **kw)
        self.conv2 = ConvBNReLU(planes, planes, 3, stride, **kw)
        self.conv3 = ConvBNReLU(planes, planes * 4, 1, act=False, **kw)
        self.downsample = (ConvBNReLU(cin, planes * 4, 1, stride, act=False,
                                      **kw)
                           if downsample else None)

    def forward(self, x):
        identity = self.downsample(x) if self.downsample is not None else x
        out = self.conv3(self.conv2(self.conv1(x)))
        return relu(out + identity)


class Branch(nn.Module):
    def __init__(self, cin, cout, num_blocks, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        blocks = [BasicBlock(cin, cout, downsample=cin != cout, **kw)]
        for _ in range(num_blocks - 1):
            blocks.append(BasicBlock(cout, cout, **kw))
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x):
        for b in self.blocks:
            x = b(x)
        return x


def _blocked_cbr(cbr, ph, pw):
    """The (ph, pw)-blocked twin of a stride-1 3x3 ConvBNReLU: the kernel
    remapped by ``remap_conv3x3_s1`` (exact), the BatchNorm's affine and
    running statistics tiled over the ph*pw blocks (exact in eval)."""
    conv = cbr.conv
    if (tuple(conv.weight.shape[2:]) != (3, 3) or conv.stride != (1, 1)
            or conv.dilation != (1, 1) or conv.groups != 1
            or conv.padding != ((1, 1), (1, 1))):
        raise ValueError(
            f"branch convs must be undilated, ungrouped, stride-1 3x3 with "
            f"padding 1: kernel {tuple(conv.weight.shape[2:])}, stride "
            f"{conv.stride}, dilation {conv.dilation}, groups {conv.groups}, "
            f"padding {conv.padding}")
    if conv.weight.dtype == torch.int8:
        raise ValueError("apply space-to-depth BEFORE quantization")
    p = ph * pw
    cout, cin = conv.weight.shape[:2]
    wb = remap_conv3x3_s1(oihw_to_hwio(conv.weight), ph, pw)
    new = ConvBNReLU(p * cin, p * cout, 3, act=cbr.act,
                     conv=conv_from_hwio(wb, p * cin, p * cout, 3, 1, False,
                                         conv.weight.device))
    with torch.no_grad():
        for name in ("weight", "bias", "running_mean", "running_var"):
            src = getattr(cbr.bn, name)
            if src is not None:
                getattr(new.bn, name).copy_(src.repeat(p))
    new.bn.eps, new.bn.momentum = cbr.bn.eps, cbr.bn.momentum
    return new


class SpaceToDepthBranch(nn.Module):
    """Eval-exact blocked twin of a narrow-channel :class:`Branch`: its
    stride-1 BasicBlocks run in a (ph, pw) space-to-depth layout, the 3x3
    kernels remapped (exact), the BatchNorms channel-tiled (exact in eval),
    the residual add and ReLU unchanged.  Channels widen ph*pw times while
    the spatial extent shrinks as much.

    Serving-only: blocked batch statistics would be per blocked channel,
    so a forward in training mode raises.  H and W must be multiples of
    ph and pw.  Building it draws no random numbers.
    """

    def __init__(self, branch: Branch, ph: int, pw: int):
        super().__init__()
        self.ph, self.pw = ph, pw
        blocks = []
        for blk in branch.blocks:
            if blk.downsample is not None:
                raise ValueError("downsample blocks cannot be blocked")
            blocks.append(BasicBlock(0, 0, convs=(
                _blocked_cbr(blk.conv1, ph, pw),
                _blocked_cbr(blk.conv2, ph, pw))))
        self.blocks = nn.ModuleList(blocks)
        self.train(branch.training)  # the mode of the branch it replaces

    def forward(self, x):
        if self.training:
            raise RuntimeError(
                "SpaceToDepthBranch is a serving transform; blocked batch "
                "statistics differ: rebuild the model for training")
        b, h, w, c = x.shape
        if h % self.ph or w % self.pw:
            raise ValueError(f"H={h}, W={w} not divisible by "
                             f"({self.ph}, {self.pw})")
        z = block_space_to_depth(x, self.ph, self.pw)
        for blk in self.blocks:
            z = blk(z)
        return unblock_space_to_depth(z, self.ph, self.pw, c)


def convert_hrnet_branches_to_s2d(model, max_lanes=128):
    """Swap every narrow-channel HRNet :class:`Branch` for its exact
    :class:`SpaceToDepthBranch` twin (eval/serving only).

    Pack per branch of width c: (2, 2) if 4c <= max_lanes, else (2, 1) if
    2c <= max_lanes, else unchanged: W18's 18-channel branch runs 2x2
    blocked at 72 channels, the 36-channel branch 2x1 at 72, the 72- and
    144-channel branches stay.  Branches with a downsample block stay.
    Returns the number of branches converted.  Apply before
    ``ops.quant.quantize_for_serving``.
    """
    n = 0
    for m in model.modules():
        if not isinstance(m, HighResolutionModule):
            continue
        for i, br in enumerate(m.branches):
            if not isinstance(br, Branch):
                continue
            if any(b.downsample is not None for b in br.blocks):
                continue
            c = int(br.blocks[0].conv2.conv.weight.shape[0])
            if 4 * c <= max_lanes:
                ph, pw = 2, 2
            elif 2 * c <= max_lanes:
                ph, pw = 2, 1
            else:
                continue
            m.branches[i] = SpaceToDepthBranch(br, ph, pw)
            n += 1
    return n


class FuseLayers(nn.Module):
    """Full cross-resolution fusion: path ``"i_j"`` carries branch j to
    output branch i, a 1x1 conv then a bilinear upsample (j > i) or a chain
    of stride-2 3x3 convs (j < i)."""

    def __init__(self, channels, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        n = len(channels)
        self.n = n
        self.paths = nn.ModuleDict()
        for i in range(n):        # output branch
            for j in range(n):    # input branch
                if j > i:
                    self.paths[f"{i}_{j}"] = ConvBNReLU(
                        channels[j], channels[i], 1, act=False, **kw)
                elif j < i:
                    convs = []
                    cin = channels[j]
                    for k in range(i - j):
                        last = k == i - j - 1
                        cout = channels[i] if last else channels[j]
                        convs.append(ConvBNReLU(cin, cout, 3, 2,
                                                act=not last, **kw))
                        cin = cout
                    self.paths[f"{i}_{j}"] = Sequential(*convs)

    def forward(self, xs):
        outs = []
        for i in range(self.n):
            acc = xs[i]
            for j in range(self.n):
                if j == i:
                    continue
                p = self.paths[f"{i}_{j}"](xs[j])
                if j > i:
                    p = interpolate(p, size=xs[i].shape[1:3], mode="bilinear")
                acc = acc + p
            outs.append(relu(acc))
        return outs


class TransitionLayer(nn.Module):
    def __init__(self, in_channels, out_channels, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        convs = []
        for i, cout in enumerate(out_channels):
            if i < len(in_channels):
                convs.append(ConvBNReLU(in_channels[i], cout, 3, **kw)
                             if in_channels[i] != cout else Identity())
            else:
                convs.append(ConvBNReLU(in_channels[-1], cout, 3, 2, **kw))
        self.convs = nn.ModuleList(convs)

    def forward(self, xs):
        return [conv(xs[i] if i < len(xs) else xs[-1])
                for i, conv in enumerate(self.convs)]


class HighResolutionModule(nn.Module):
    def __init__(self, channels, num_blocks, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.branches = nn.ModuleList([Branch(c, c, b, **kw)
                                       for c, b in zip(channels, num_blocks)])
        self.fuse = FuseLayers(channels, **kw)

    def forward(self, xs):
        return self.fuse([b(x) for b, x in zip(self.branches, xs)])


class Stage(nn.Module):
    def __init__(self, channels, num_modules, num_blocks, device=None,
                 generator=None):
        super().__init__()
        self.modules_ = nn.ModuleList([
            HighResolutionModule(channels, num_blocks, device=device,
                                 generator=generator)
            for _ in range(num_modules)])

    def forward(self, xs):
        for m in self.modules_:
            xs = m(xs)
        return xs


class HRNet(nn.Module):
    """Returns the list of the 4 branch outputs; ``concat_features()``
    gives the segmentation-style upsampled concat."""

    def __init__(self,
                 stage1_num_modules=1, stage1_num_blocks=(4,),
                 stage1_num_channels=(64,),
                 stage2_num_modules=1, stage2_num_blocks=(4, 4),
                 stage2_num_channels=(18, 36),
                 stage3_num_modules=4, stage3_num_blocks=(4, 4, 4),
                 stage3_num_channels=(18, 36, 72),
                 stage4_num_modules=3, stage4_num_blocks=(4, 4, 4, 4),
                 stage4_num_channels=(18, 36, 72, 144), device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        self.conv1 = ConvBNReLU(3, 64, 3, 2, **kw)
        self.conv2 = ConvBNReLU(64, 64, 3, 2, **kw)
        c1 = stage1_num_channels[0]
        layer1 = [BottleneckBlock(64, c1, downsample=True, **kw)]
        for _ in range(stage1_num_blocks[0] - 1):
            layer1.append(BottleneckBlock(c1 * 4, c1, **kw))
        self.layer1 = nn.ModuleList(layer1)
        self.tr1 = TransitionLayer([c1 * 4], stage2_num_channels, **kw)
        self.st2 = Stage(stage2_num_channels, stage2_num_modules,
                         stage2_num_blocks, **kw)
        self.tr2 = TransitionLayer(stage2_num_channels, stage3_num_channels,
                                   **kw)
        self.st3 = Stage(stage3_num_channels, stage3_num_modules,
                         stage3_num_blocks, **kw)
        self.tr3 = TransitionLayer(stage3_num_channels, stage4_num_channels,
                                   **kw)
        self.st4 = Stage(stage4_num_channels, stage4_num_modules,
                         stage4_num_blocks, **kw)
        self.feat_channels = [sum(stage4_num_channels)]
        self.branch_channels = list(stage4_num_channels)

    def forward(self, x):
        x = self.conv2(self.conv1(x))
        for b in self.layer1:
            x = b(x)
        xs = self.tr1([x])
        xs = self.st2(xs)
        xs = self.tr2(xs)
        xs = self.st3(xs)
        xs = self.tr3(xs)
        return self.st4(xs)

    def concat_features(self, x):
        xs = self(x)
        size = xs[0].shape[1:3]
        ups = [xs[0]] + [interpolate(b, size=size, mode="bilinear")
                         for b in xs[1:]]
        return torch.cat(ups, dim=-1)


def _hrnet(w, small=None, **kw):
    if small == "v1":
        return HRNet(stage1_num_blocks=(1,), stage1_num_channels=(32,),
                     stage2_num_blocks=(2, 2), stage2_num_channels=(16, 32),
                     stage3_num_modules=1, stage3_num_blocks=(2, 2, 2),
                     stage3_num_channels=(16, 32, 64),
                     stage4_num_modules=1, stage4_num_blocks=(2, 2, 2, 2),
                     stage4_num_channels=(16, 32, 64, 128), **kw)
    if small == "v2":
        return HRNet(stage1_num_blocks=(2,),
                     stage2_num_blocks=(2, 2), stage2_num_channels=(18, 36),
                     stage3_num_modules=3, stage3_num_blocks=(2, 2, 2),
                     stage3_num_channels=(18, 36, 72),
                     stage4_num_modules=2, stage4_num_blocks=(2, 2, 2, 2),
                     stage4_num_channels=(18, 36, 72, 144), **kw)
    return HRNet(stage2_num_channels=(w, 2 * w),
                 stage3_num_channels=(w, 2 * w, 4 * w),
                 stage4_num_channels=(w, 2 * w, 4 * w, 8 * w), **kw)


def hrnet_w18_small_v1(**kw):
    return _hrnet(18, "v1", **kw)


def hrnet_w18_small_v2(**kw):
    return _hrnet(18, "v2", **kw)


def hrnet_w18(**kw):
    return _hrnet(18, **kw)


def hrnet_w30(**kw):
    return _hrnet(30, **kw)


def hrnet_w32(**kw):
    return _hrnet(32, **kw)


def hrnet_w40(**kw):
    return _hrnet(40, **kw)


def hrnet_w44(**kw):
    return _hrnet(44, **kw)


def hrnet_w48(**kw):
    return _hrnet(48, **kw)


def hrnet_w60(**kw):
    return _hrnet(60, **kw)


def hrnet_w64(**kw):
    return _hrnet(64, **kw)
