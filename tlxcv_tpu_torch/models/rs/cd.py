"""Remote-sensing change detection (counterpart of
``tlxcv_tpu/models/rs/cd.py``), NHWC: FC-EF, CDNet, SNUNet, BIT, DSIFN,
STANet, DSAMNet and FCCDN.  A change detector is called as ``model(t1,
t2)`` and returns change logits [B, H, W, classes] at the input's size
(FCCDN's and DSAMNet's at the input's size too; FCCDN's auxiliary
segmentation logits at half of it).

In training mode (``module.training``, where the reference reads
``is_training()``) DSIFN returns its five deep-supervision outputs,
DSAMNet ``[pred, ds2, ds3]`` and FCCDN ``[y, aux t1, aux t2]``; the others
return what they return in eval.

BIT's attention runs at head dim 4 (width 32 over 8 heads): 17 calls of
``ops.cuda.attention.flash_attention`` a forward, one in the token
encoder and one in each of the 8 decoder layers for each of the two
images.  On the card the wrapper pads the head dim to the kernel's 32.
STANet's BAM and PAM and FCCDN's non-local blocks compute their own
``softmax(q k^T) v``, as the reference does, and reach no kernel of ours;
no other model here does either: their resizes are ``ops.image.
interpolate``'s plain routes.
"""
from __future__ import annotations

import torch
from torch import nn as tnn

from ... import nn
from ...device import resolve_device
from ...nn.attention import MultiHeadAttention
from ...ops.image import interpolate
from ..classification.resnet import ResNet
from ..detection.detr import DetrAttention
from .layers import (CBAM, ChannelAttention, Conv1x1, Conv3x3, Conv7x7,
                     ConvTransposed3x3, MaxPool2x2, SpatialAttention)

__all__ = ["FCEarlyFusion", "CDNet", "SNUNet", "BIT", "DSIFN", "DSAMNet",
           "STANet", "FCCDN"]


def _up_to(x, size):
    """Bilinear resize to ``size`` with ``align_corners=True``."""
    return interpolate(x, size=size, mode="bilinear", align_corners=True)


def _up2(x):
    """Bilinear x2 with ``align_corners=True`` (SNUNet's Up)."""
    return interpolate(x, scale_factor=2, mode="bilinear",
                       align_corners=True)


# ------------------------------------------------------------------ FC-EF
class FCEarlyFusion(tnn.Module):
    """Early fusion: the two images stacked on the channel axis through a
    four-level UNet-like encoder and decoder."""

    def __init__(self, in_channels=3, num_classes=2, use_dropout=False,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        c1, c2, c3, c4 = 16, 32, 64, 128
        dp = 0.2 if use_dropout else 0.0

        def double(cin, cout):
            return nn.Sequential(
                Conv3x3(cin, cout, norm=True, act=True, **kw), nn.Dropout(dp),
                Conv3x3(cout, cout, norm=True, act=True, **kw),
                nn.Dropout(dp))

        chans = [in_channels * 2, c1, c2, c3, c4]
        self.enc = tnn.ModuleList([double(chans[i], chans[i + 1])
                                   for i in range(4)])
        self.pool = MaxPool2x2()
        skip = [c4, c3, c2, c1]
        ins = [c4, c4, c3, c2]
        self.up = tnn.ModuleList([
            ConvTransposed3x3(ins[i], skip[i], norm=True, act=True, **kw)
            for i in range(4)])
        self.dec = tnn.ModuleList([double(skip[i] * 2, skip[i])
                                   for i in range(4)])
        self.head = Conv3x3(c1, num_classes, **kw)

    def forward(self, t1, t2):
        x = torch.cat([t1, t2], -1)
        skips = []
        for enc in self.enc:
            x = enc(x)
            skips.append(x)
            x = self.pool(x)
        for up, dec, skip in zip(self.up, self.dec, reversed(skips)):
            x = up(x)
            if x.shape[1:3] != skip.shape[1:3]:
                x = interpolate(x, size=skip.shape[1:3], mode="nearest")
            x = dec(torch.cat([skip, x], -1))
        return self.head(x)


# ------------------------------------------------------------------ CDNet
class CDNet(tnn.Module):
    """Early fusion through 7x7 convs: four pooled stages, four transposed
    3x3 upsamplings."""

    def __init__(self, in_channels=3, num_classes=2, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        self.conv1 = Conv7x7(in_channels * 2, 64, norm=True, act=True, **kw)
        self.convs = tnn.ModuleList([
            Conv7x7(64, 64, norm=True, act=True, **kw) for _ in range(3)])
        self.pool = MaxPool2x2()
        self.ups = tnn.ModuleList([
            ConvTransposed3x3(64, 64, norm=True, act=True, **kw)
            for _ in range(4)])
        self.head = Conv7x7(64, num_classes, **kw)

    def forward(self, t1, t2):
        x = self.pool(self.conv1(torch.cat([t1, t2], -1)))
        for conv in self.convs:
            x = self.pool(conv(x))
        for up in self.ups:
            x = up(x)
        return self.head(x)


# ----------------------------------------------------------------- SNUNet
class ConvBlockNested(tnn.Module):
    """conv-BN-ReLU-conv-BN, plus the identity, then ReLU; the identity is
    conv1's output before its BatchNorm, as in the reference."""

    def __init__(self, cin, cout, mid, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv1 = nn.Conv2d(cin, mid, 3, padding=1, **kw)
        self.bn1 = nn.BatchNorm(mid, device=device)
        self.conv2 = nn.Conv2d(mid, cout, 3, padding=1, **kw)
        self.bn2 = nn.BatchNorm(cout, device=device)

    def forward(self, x):
        identity = x = self.conv1(x)
        x = self.bn2(self.conv2(nn.relu(self.bn1(x))))
        return nn.relu(x + identity)


class SNUNet(tnn.Module):
    """Siamese NestedUNet (UNet++) with the ECAM head: channel attention
    (ratio 4) of the sum of the four x0_j outputs, tiled four times along
    the channels and added to their concatenation, gated by channel
    attention (ratio 16) of that concatenation.  t2 alone goes down to
    x4_0, as in the reference."""

    def __init__(self, in_channels=3, num_classes=2, width=32, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        f = [width * 2 ** i for i in range(5)]

        def block(cin, cout):
            return ConvBlockNested(cin, cout, cout, **kw)

        self.conv0_0 = block(in_channels, f[0])
        self.conv1_0 = block(f[0], f[1])
        self.conv2_0 = block(f[1], f[2])
        self.conv3_0 = block(f[2], f[3])
        self.conv4_0 = block(f[3], f[4])
        self.pool = MaxPool2x2()
        self.conv0_1 = block(f[0] * 2 + f[1], f[0])
        self.conv1_1 = block(f[1] * 2 + f[2], f[1])
        self.conv2_1 = block(f[2] * 2 + f[3], f[2])
        self.conv3_1 = block(f[3] * 2 + f[4], f[3])
        self.conv0_2 = block(f[0] * 3 + f[1], f[0])
        self.conv1_2 = block(f[1] * 3 + f[2], f[1])
        self.conv2_2 = block(f[2] * 3 + f[3], f[2])
        self.conv0_3 = block(f[0] * 4 + f[1], f[0])
        self.conv1_3 = block(f[1] * 4 + f[2], f[1])
        self.conv0_4 = block(f[0] * 5 + f[1], f[0])
        self.ca_intra = ChannelAttention(f[0], ratio=4, **kw)
        self.ca_inter = ChannelAttention(f[0] * 4, ratio=16, **kw)
        self.conv_out = Conv1x1(f[0] * 4, num_classes, **kw)

    def _down(self, x, depth):
        outs = [self.conv0_0(x)]
        for conv in (self.conv1_0, self.conv2_0, self.conv3_0,
                     self.conv4_0)[:depth - 1]:
            outs.append(conv(self.pool(outs[-1])))
        return outs

    def forward(self, t1, t2):
        a = self._down(t1, 4)
        b = self._down(t2, 5)

        def cat(*xs):
            return torch.cat(xs, -1)

        x0_1 = self.conv0_1(cat(a[0], b[0], _up2(b[1])))
        x1_1 = self.conv1_1(cat(a[1], b[1], _up2(b[2])))
        x0_2 = self.conv0_2(cat(a[0], b[0], x0_1, _up2(x1_1)))
        x2_1 = self.conv2_1(cat(a[2], b[2], _up2(b[3])))
        x1_2 = self.conv1_2(cat(a[1], b[1], x1_1, _up2(x2_1)))
        x0_3 = self.conv0_3(cat(a[0], b[0], x0_1, x0_2, _up2(x1_2)))
        x3_1 = self.conv3_1(cat(a[3], b[3], _up2(b[4])))
        x2_2 = self.conv2_2(cat(a[2], b[2], x2_1, _up2(x3_1)))
        x1_3 = self.conv1_3(cat(a[1], b[1], x1_1, x1_2, _up2(x2_2)))
        x0_4 = self.conv0_4(cat(a[0], b[0], x0_1, x0_2, x0_3, _up2(x1_3)))
        out = cat(x0_1, x0_2, x0_3, x0_4)
        m_intra = self.ca_intra(x0_1 + x0_2 + x0_3 + x0_4)
        out = self.ca_inter(out) * (out + m_intra.repeat(1, 1, 1, 4))
        return self.conv_out(out)


_gelu = nn.get_activation("gelu")  # jax.nn.gelu: the tanh approximation


class _TransformerLayer(tnn.Module):
    def __init__(self, dim, heads, mlp_dim, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.norm1 = nn.LayerNorm(dim, device=device)
        self.attn = MultiHeadAttention(dim, heads, qkv_bias=True, **kw)
        self.norm2 = nn.LayerNorm(dim, device=device)
        self.fc1 = nn.Linear(dim, mlp_dim, **kw)
        self.fc2 = nn.Linear(mlp_dim, dim, **kw)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.fc2(_gelu(self.fc1(self.norm2(x))))


class _CrossTransformerLayer(tnn.Module):
    """Pixels (queries) attend to the semantic tokens (keys and values,
    not normalised)."""

    def __init__(self, dim, heads, mlp_dim, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.norm1 = nn.LayerNorm(dim, device=device)
        self.attn = DetrAttention(dim, heads, **kw)
        self.norm2 = nn.LayerNorm(dim, device=device)
        self.fc1 = nn.Linear(dim, mlp_dim, **kw)
        self.fc2 = nn.Linear(mlp_dim, dim, **kw)

    def forward(self, x, m):
        x = x + self.attn(self.norm1(x), m, m)
        return x + self.fc2(_gelu(self.fc1(self.norm2(x))))


class BIT(tnn.Module):
    """Bitemporal image transformer: a ResNet-18 to stride 8, ``token_len``
    semantic tokens an image (a softmax over the pixels), a token encoder
    over both images' tokens, a decoder taking each image's pixels to its
    tokens, and a head over the absolute difference, upsampled to the
    input's size."""

    def __init__(self, in_channels=3, num_classes=2, token_len=4, dim=32,
                 enc_depth=1, dec_depth=8, heads=8, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.backbone = ResNet(depth=18, num_classes=0, with_pool=False,
                               **kw)
        self.conv_squeeze = Conv3x3(self.backbone.feat_channels[1], dim,
                                    norm=True, act=True, **kw)
        self.token_len = token_len
        self.conv_att = Conv1x1(dim, token_len, **kw)
        self.encoder = tnn.ModuleList([
            _TransformerLayer(dim, heads, dim * 2, **kw)
            for _ in range(enc_depth)])
        self.decoder = tnn.ModuleList([
            _CrossTransformerLayer(dim, heads, dim * 2, **kw)
            for _ in range(dec_depth)])
        self.head = nn.Sequential(Conv3x3(dim, dim, norm=True, act=True, **kw),
                                  Conv3x3(dim, num_classes, **kw))

    def _features(self, x):
        return self.conv_squeeze(self.backbone.features(x)[1])  # stride 8

    def _tokens(self, x):
        b, h, w, c = x.shape
        att = torch.softmax(
            self.conv_att(x).reshape(b, h * w, self.token_len), 1)
        return torch.einsum("bnt,bnc->btc", att, x.reshape(b, h * w, c))

    def forward(self, t1, t2):
        x1 = self._features(t1)
        x2 = self._features(t2)
        tokens = torch.cat([self._tokens(x1), self._tokens(x2)], 1)
        for layer in self.encoder:
            tokens = layer(tokens)
        tok1, tok2 = tokens.chunk(2, 1)
        b, h, w, c = x1.shape

        def decode(x, tok):
            seq = x.reshape(b, h * w, c)
            for layer in self.decoder:
                seq = layer(seq, tok)
            return seq.reshape(b, h, w, c)

        diff = (decode(x1, tok1) - decode(x2, tok2)).abs()
        diff = interpolate(diff, size=t1.shape[1:3], mode="bilinear")
        return self.head(diff)


# ------------------------------------------------------------------ DSIFN
class VGG16FeaturePicker(tnn.Module):
    """VGG-16's conv trunk (torchvision's ``features[:30]``), returning
    the ReLU outputs at its indices 3, 8, 15, 22 and 29: channels 64, 128,
    256, 512, 512 at strides 1, 2, 4, 8, 16."""

    _CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512]

    def __init__(self, indices=(3, 8, 15, 22, 29), device=None,
                 generator=None):
        super().__init__()
        layers, cin = [], 3
        for v in self._CFG:
            if v == "M":
                layers.append(MaxPool2x2())
            else:
                layers += [nn.Conv2d(cin, v, 3, padding=1, device=device,
                                     generator=generator),
                           nn.Activation("relu")]
                cin = v
        self.features = tnn.ModuleList(layers)
        self.indices = set(indices)

    def forward(self, x):
        picked = []
        for idx, layer in enumerate(self.features):
            x = layer(x)
            if idx in self.indices:
                picked.append(x)
        return picked


class _ConvPReLUBN(tnn.Module):
    """conv3x3, PReLU, then BatchNorm (the PReLU before the norm, as in
    the reference), then dropout 0.6 if asked."""

    def __init__(self, cin, cout, with_dropout=False, device=None,
                 generator=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1, device=device,
                              generator=generator)
        self.prelu = nn.PReLU(device=device)
        self.bn = nn.BatchNorm(cout, device=device)
        self.drop = nn.Dropout(0.6) if with_dropout else None

    def forward(self, x):
        x = self.bn(self.prelu(self.conv(x)))
        return x if self.drop is None else self.drop(x)


class DSIFN(tnn.Module):
    """Deeply supervised image fusion network: a siamese VGG-16 feature
    picker and a decoder that fuses each level by channel attention and
    spatial attention, upsampling by transposed 2x2 convs.  In training
    it returns its five outputs: the last, then the four deeper ones
    resized (bilinear, ``align_corners=True``) to the input's size."""

    def __init__(self, in_channels=3, num_classes=2, use_dropout=False,
                 device=None, generator=None):
        super().__init__()
        if in_channels != 3:
            raise ValueError("DSIFN's VGG-16 encoder takes RGB images")
        device = resolve_device(device)
        kw = dict(device=device, generator=generator)
        self.encoder = VGG16FeaturePicker(**kw)
        self.sa1 = SpatialAttention(**kw)
        self.sa2 = SpatialAttention(**kw)
        self.sa3 = SpatialAttention(**kw)
        self.sa4 = SpatialAttention(**kw)
        self.sa5 = SpatialAttention(**kw)

        def cpb(cin, cout):
            return _ConvPReLUBN(cin, cout, use_dropout, **kw)

        self.o1_conv1 = cpb(1024, 512)
        self.o1_conv2 = cpb(512, 512)
        self.bn_sa1 = nn.BatchNorm(512, device=device)
        self.o1_conv3 = Conv1x1(512, num_classes, **kw)
        self.trans_conv1 = nn.ConvTranspose2d(512, 512, 2, stride=2, **kw)
        self.ca2 = ChannelAttention(1536, **kw)
        self.o2_conv1 = cpb(1536, 512)
        self.o2_conv2 = cpb(512, 256)
        self.o2_conv3 = cpb(256, 256)
        self.bn_sa2 = nn.BatchNorm(256, device=device)
        self.o2_conv4 = Conv1x1(256, num_classes, **kw)
        self.trans_conv2 = nn.ConvTranspose2d(256, 256, 2, stride=2, **kw)
        self.ca3 = ChannelAttention(768, **kw)
        self.o3_conv1 = cpb(768, 256)
        self.o3_conv2 = cpb(256, 128)
        self.o3_conv3 = cpb(128, 128)
        self.bn_sa3 = nn.BatchNorm(128, device=device)
        self.o3_conv4 = Conv1x1(128, num_classes, **kw)
        self.trans_conv3 = nn.ConvTranspose2d(128, 128, 2, stride=2, **kw)
        self.ca4 = ChannelAttention(384, **kw)
        self.o4_conv1 = cpb(384, 128)
        self.o4_conv2 = cpb(128, 64)
        self.o4_conv3 = cpb(64, 64)
        self.bn_sa4 = nn.BatchNorm(64, device=device)
        self.o4_conv4 = Conv1x1(64, num_classes, **kw)
        self.trans_conv4 = nn.ConvTranspose2d(64, 64, 2, stride=2, **kw)
        self.ca5 = ChannelAttention(192, **kw)
        self.o5_conv1 = cpb(192, 64)
        self.o5_conv2 = cpb(64, 32)
        self.o5_conv3 = cpb(32, 16)
        self.bn_sa5 = nn.BatchNorm(16, device=device)
        self.o5_conv4 = Conv1x1(16, num_classes, **kw)

    def forward(self, t1, t2):
        f1 = self.encoder(t1)
        f2 = self.encoder(t2)
        x = self.o1_conv2(self.o1_conv1(torch.cat([f1[4], f2[4]], -1)))
        x = self.bn_sa1(self.sa1(x) * x)
        aux = [x]
        for lvl, i in zip((2, 3, 4, 5), (3, 2, 1, 0)):
            x = getattr(self, f"trans_conv{lvl - 1}")(x)
            x = torch.cat([x, f1[i], f2[i]], -1)
            x = getattr(self, f"ca{lvl}")(x) * x
            for j in (1, 2, 3):
                x = getattr(self, f"o{lvl}_conv{j}")(x)
            x = getattr(self, f"bn_sa{lvl}")(getattr(self, f"sa{lvl}")(x) * x)
            aux.append(x)
        out5 = self.o5_conv4(x)
        if not self.training:
            return out5
        size = t1.shape[1:3]
        return [out5, _up_to(self.o4_conv4(aux[3]), size),
                _up_to(self.o3_conv4(aux[2]), size),
                _up_to(self.o2_conv4(aux[1]), size),
                _up_to(self.o1_conv3(aux[0]), size)]


# ------------------------------------------------- STANet/DSAMNet shared
class RSBackbone(tnn.Module):
    """A ResNet with the given strides (conv1, layer1..layer4), returning
    C2-C5."""

    def __init__(self, in_ch=3, arch="resnet18", strides=(2, 1, 2, 2, 2),
                 device=None, generator=None):
        super().__init__()
        self.resnet = ResNet(depth=int(arch.replace("resnet", "")),
                             num_classes=0, with_pool=False, strides=strides,
                             in_channels=in_ch, device=device,
                             generator=generator)

    def forward(self, x):
        return self.resnet.features(x)


class RSDecoder(tnn.Module):
    """Each level reduced to 96 channels by a 1x1 conv, the deeper three
    resized (bilinear, ``align_corners=True``) to the first's size, then
    a 3x3 and a 1x1 conv to ``f_ch``."""

    def __init__(self, f_ch=64, in_chs=(64, 128, 256, 512), device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.dr1 = Conv1x1(in_chs[0], 96, norm=True, act=True, **kw)
        self.dr2 = Conv1x1(in_chs[1], 96, norm=True, act=True, **kw)
        self.dr3 = Conv1x1(in_chs[2], 96, norm=True, act=True, **kw)
        self.dr4 = Conv1x1(in_chs[3], 96, norm=True, act=True, **kw)
        self.conv_out = nn.Sequential(
            Conv3x3(384, 256, norm=True, act=True, **kw), nn.Dropout(0.5),
            Conv1x1(256, f_ch, norm=True, act=True, **kw))

    def forward(self, feats):
        f1 = self.dr1(feats[0])
        size = f1.shape[1:3]
        f2 = _up_to(self.dr2(feats[1]), size)
        f3 = _up_to(self.dr3(feats[2]), size)
        f4 = _up_to(self.dr4(feats[3]), size)
        return self.conv_out(torch.cat([f1, f2, f3, f4], -1))


def _attend(q, k, v, key_ch):
    """softmax(q k^T / sqrt(key_ch)) v over [B, N, C] rows, in x's dtype,
    as the reference computes it (no kernel of ours)."""
    energy = (q @ k.transpose(1, 2)) * key_ch ** -0.5
    return torch.softmax(energy, -1) @ v


class BAM(tnn.Module):
    """Non-local self-attention over every position of the two dates'
    width-interleaved map [B, H, 2W, C] (average-pooled by ``ds`` first,
    the result resized back by nearest), plus the input."""

    def __init__(self, in_ch, ds=1, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.ds = ds
        self.key_ch = in_ch // 8
        self.conv_q = Conv1x1(in_ch, self.key_ch, **kw)
        self.conv_k = Conv1x1(in_ch, self.key_ch, **kw)
        self.conv_v = Conv1x1(in_ch, in_ch, **kw)

    def forward(self, x):
        x_rs = nn.AvgPool2d(self.ds, self.ds)(x) if self.ds > 1 else x
        b, h, w, c = x_rs.shape
        out = _attend(self.conv_q(x_rs).reshape(b, h * w, self.key_ch),
                      self.conv_k(x_rs).reshape(b, h * w, self.key_ch),
                      self.conv_v(x_rs).reshape(b, h * w, c), self.key_ch)
        out = out.reshape(b, h, w, c)
        if self.ds > 1:
            out = interpolate(out, size=x.shape[1:3], mode="nearest")
        return out + x


class PAMBlock(tnn.Module):
    """Self-attention within each of ``scale`` x ``scale`` subregions (H
    and W divisible by ``scale``)."""

    def __init__(self, in_ch, scale=1, ds=1, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.scale = scale
        self.ds = ds
        self.key_ch = in_ch // 8
        self.conv_q = Conv1x1(in_ch, self.key_ch, norm=True, **kw)
        self.conv_k = Conv1x1(in_ch, self.key_ch, norm=True, **kw)
        self.conv_v = Conv1x1(in_ch, in_ch, **kw)

    def _split(self, x):
        b, h, w, c = x.shape
        s = self.scale
        x = x.reshape(b, s, h // s, s, w // s, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b * s * s, -1, c)

    def _merge(self, x, b, h, w, c):
        s = self.scale
        x = x.reshape(b, s, s, h // s, w // s, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, h, w, c)

    def forward(self, x):
        x_rs = nn.AvgPool2d(self.ds, self.ds)(x) if self.ds > 1 else x
        b, h, w, c = x_rs.shape
        out = _attend(self._split(self.conv_q(x_rs)),
                      self._split(self.conv_k(x_rs)),
                      self._split(self.conv_v(x_rs)), self.key_ch)
        out = self._merge(out, b, h, w, c)
        if self.ds > 1:
            out = interpolate(out, size=x.shape[1:3], mode="nearest")
        return out


class PAM(tnn.Module):
    """Pyramid attention: a ``PAMBlock`` at each scale, concatenated, then
    a 1x1 conv without bias."""

    def __init__(self, in_ch, ds=1, scales=(1, 2, 4, 8), device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.stages = tnn.ModuleList([PAMBlock(in_ch, s, ds, **kw)
                                      for s in scales])
        self.conv_out = Conv1x1(in_ch * len(scales), in_ch, bias=False, **kw)

    def forward(self, x):
        return self.conv_out(torch.cat([stage(x) for stage in self.stages],
                                       -1))


class _STAttention(tnn.Module):
    """Interleave the two dates along the width ([B, H, 2W, C], column 2j
    from t1 and 2j + 1 from t2), attend, and take them apart again."""

    def __init__(self, att):
        super().__init__()
        self.att = att

    def forward(self, x1, x2):
        b, h, w, c = x1.shape
        x = torch.stack([x1, x2], 3).reshape(b, h, 2 * w, c)
        y = self.att(x).reshape(b, h, w, 2, c)
        return y[..., 0, :], y[..., 1, :]


class STANet(tnn.Module):
    """Spatial-temporal attention network: a shared ResNet-18 and decoder
    to stride 4, BAM or PAM across both dates, the absolute difference
    resized (bilinear, ``align_corners=True``) to the input's size, then
    two 3x3 convs."""

    def __init__(self, in_channels=3, num_classes=2, att_type="BAM",
                 ds_factor=1, width=64, device=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        self.extract_backbone = RSBackbone(in_channels, **kw)
        self.extract_decoder = RSDecoder(width, **kw)
        if att_type == "BAM":
            self.attend = _STAttention(BAM(width, ds_factor, **kw))
        elif att_type == "PAM":
            self.attend = _STAttention(PAM(width, ds_factor, **kw))
        else:
            raise ValueError(f"unsupported att_type {att_type}")
        self.conv_out = nn.Sequential(
            Conv3x3(width, width, norm=True, act=True, **kw),
            Conv3x3(width, num_classes, **kw))

    def forward(self, t1, t2):
        f1 = self.extract_decoder(self.extract_backbone(t1))
        f2 = self.extract_decoder(self.extract_backbone(t2))
        f1, f2 = self.attend(f1, f2)
        return self.conv_out(_up_to((f1 - f2).abs(), t1.shape[1:3]))


# ----------------------------------------------------------------- DSAMNet
class DSLayer(tnn.Module):
    """Deep-supervision head: a strided transposed 3x3 conv (with
    ``output_padding``), BatchNorm, ReLU, dropout 0.2, a transposed 3x3
    conv."""

    def __init__(self, in_ch, out_ch, itm_ch, stride, output_padding,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.up1 = nn.ConvTranspose2d(in_ch, itm_ch, 3, stride=stride,
                                      padding=1,
                                      output_padding=output_padding, **kw)
        self.bn = nn.BatchNorm(itm_ch, device=device)
        self.drop = nn.Dropout(0.2)
        self.up2 = nn.ConvTranspose2d(itm_ch, out_ch, 3, padding=1, **kw)

    def forward(self, x):
        return self.up2(self.drop(nn.relu(self.bn(self.up1(x)))))


class DSAMNet(tnn.Module):
    """Deeply supervised attention metric network: a shared ResNet-18 at
    strides (1, 1, 2, 2, 1) and decoder, a CBAM on each date, the absolute
    difference resized to the input's size, two 3x3 convs; in training
    also the two deep-supervision heads on the C2 and C3 differences."""

    def __init__(self, in_channels=3, num_classes=2, ca_ratio=8, sa_kernel=7,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        width = 64
        self.backbone = RSBackbone(in_channels, strides=(1, 1, 2, 2, 1), **kw)
        self.decoder = RSDecoder(width, **kw)
        self.cbam1 = CBAM(width, ca_ratio, sa_kernel, **kw)
        self.cbam2 = CBAM(width, ca_ratio, sa_kernel, **kw)
        self.dsl2 = DSLayer(64, num_classes, 32, stride=2, output_padding=1,
                            **kw)
        self.dsl3 = DSLayer(128, num_classes, 32, stride=4, output_padding=3,
                            **kw)
        self.conv_out = nn.Sequential(
            Conv3x3(width, width, norm=True, act=True, **kw),
            Conv3x3(width, num_classes, **kw))

    def forward(self, t1, t2):
        f1 = self.backbone(t1)
        f2 = self.backbone(t2)
        y1 = self.cbam1(self.decoder(f1))
        y2 = self.cbam2(self.decoder(f2))
        pred = self.conv_out(_up_to((y1 - y2).abs(), t1.shape[1:3]))
        if not self.training:
            return pred
        return [pred, self.dsl2((f1[0] - f2[0]).abs()),
                self.dsl3((f1[1] - f2[1]).abs())]


# ------------------------------------------------------------------ FCCDN
class _NLBlock(tnn.Module):
    """Self-similarity non-local block: softmax(x x^T / sqrt(C)) times a
    3x3 conv-BN of x, then a 3x3 conv-BN-ReLU."""

    def __init__(self, in_ch, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv_v = Conv3x3(in_ch, in_ch, norm=True, **kw)
        self.w = Conv3x3(in_ch, in_ch, norm=True, act=True, **kw)

    def forward(self, x):
        b, h, w, c = x.shape
        qk = x.reshape(b, h * w, c)
        out = _attend(qk, qk, self.conv_v(x).reshape(b, h * w, c), c)
        return self.w(out.reshape(b, h, w, c))


class NLFPN(tnn.Module):
    """Non-local feature pyramid: a three-level encoder and a decoder whose
    levels are gated by non-local blocks, between an optional 1x1
    reduction to a quarter of the channels and its inverse."""

    def __init__(self, in_dim, reduction=True, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        if reduction:
            self.reduction = Conv1x1(in_dim, in_dim // 4, norm=True, act=True,
                                     **kw)
            self.re_reduction = Conv1x1(in_dim // 4, in_dim, norm=True,
                                        act=True, **kw)
            in_dim //= 4
        else:
            self.reduction = self.re_reduction = None

        def c3(cin, cout):
            return Conv3x3(cin, cout, norm=True, act=True, **kw)

        self.conv_e1 = c3(in_dim, in_dim)
        self.conv_e2 = c3(in_dim, in_dim * 2)
        self.conv_e3 = c3(in_dim * 2, in_dim * 4)
        self.conv_d1 = c3(in_dim, in_dim)
        self.conv_d2 = c3(in_dim * 2, in_dim)
        self.conv_d3 = c3(in_dim * 4, in_dim * 2)
        self.nl3 = _NLBlock(in_dim * 2, **kw)
        self.nl2 = _NLBlock(in_dim, **kw)
        self.nl1 = _NLBlock(in_dim, **kw)
        self.pool = MaxPool2x2()

    def forward(self, x):
        if self.reduction is not None:
            x = self.reduction(x)
        e1 = self.conv_e1(x)
        e2 = self.conv_e2(self.pool(e1))
        e3 = self.conv_e3(self.pool(e2))
        d3 = self.conv_d3(e3)
        d3 = _up2(d3 * self.nl3(d3))
        d2 = self.conv_d2(e2 + d3)
        d2 = _up2(d2 * self.nl2(d2))
        d1 = self.conv_d1(e1 + d2)
        d1 = d1 * self.nl1(d1)
        if self.re_reduction is not None:
            d1 = self.re_reduction(d1)
        return d1


class _Cat(tnn.Module):
    """Nearest 2x upsample of ``x`` (if asked), concatenation with ``y``,
    a 1x1 conv-BN-ReLU."""

    def __init__(self, in_high, in_low, out_ch, upsample=False, device=None,
                 generator=None):
        super().__init__()
        self.do_upsample = upsample
        self.conv2d = Conv1x1(in_high + in_low, out_ch, norm=True, act=True,
                              device=device, generator=generator)

    def forward(self, x, y):
        if self.do_upsample:
            x = interpolate(x, scale_factor=2, mode="nearest")
        return self.conv2d(torch.cat([x, y], -1))


class _DoubleConv(tnn.Module):
    def __init__(self, cin, cout, stride=1, dilation=1, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv = nn.Sequential(
            nn.Conv2d(cin, cout, 3, stride=stride, dilation=dilation,
                      padding=dilation, **kw),
            nn.BatchNorm(cout, device=device), nn.Activation("relu"),
            nn.Conv2d(cout, cout, 3, padding=1, **kw),
            nn.BatchNorm(cout, device=device), nn.Activation("relu"))

    def forward(self, x):
        return self.conv(x)


class _SEModule(tnn.Module):
    def __init__(self, channels, reduction_channels, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.fc1 = nn.Conv2d(channels, reduction_channels, 1, **kw)
        self.fc2 = nn.Conv2d(reduction_channels, channels, 1, **kw)

    def forward(self, x):
        s = self.fc2(nn.relu(self.fc1(x.mean((1, 2), keepdim=True))))
        return x * torch.sigmoid(s)


class _FCCDNBlock(tnn.Module):
    """Two double convs (the second strided or dilated), SE, and the first
    one's output (max-pooled where the block downsamples) added back."""

    def __init__(self, inplanes, planes, downsample, use_se, stride,
                 dilation, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv1 = _DoubleConv(inplanes, planes, **kw)
        self.conv2 = _DoubleConv(planes, planes, stride, dilation, **kw)
        self.se = _SEModule(planes, planes // 4, **kw) if use_se else None
        self.downsample = MaxPool2x2() if downsample else None

    def forward(self, x):
        residual = out = self.conv1(x)
        out = self.conv2(out)
        if self.se is not None:
            out = self.se(out)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return nn.relu(out + residual)


class _DenseCat(tnn.Module):
    """Dense fusion of the two dates, its three 3x3 convs shared by both:
    the sum of all six outputs, or with ``diff`` the absolute difference
    of each date's sum; then a 1x1 conv-BN-ReLU."""

    def __init__(self, in_ch, out_ch, diff=False, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.diff = diff
        self.conv1 = Conv3x3(in_ch, in_ch, act=True, **kw)
        self.conv2 = Conv3x3(in_ch, in_ch, act=True, **kw)
        self.conv3 = Conv3x3(in_ch, in_ch, act=True, **kw)
        self.conv_out = Conv1x1(in_ch, out_ch, norm=True, act=True, **kw)

    def _dense(self, x):
        x1 = self.conv1(x)
        x2 = self.conv2(x1)
        return x1, x2, self.conv3(x2 + x1)

    def forward(self, x, y):
        x1, x2, x3 = self._dense(x)
        y1, y2, y3 = self._dense(y)
        if self.diff:
            return self.conv_out((x1 + x2 + x3 - y1 - y2 - y3).abs())
        return self.conv_out(x1 + x2 + x3 + y1 + y2 + y3)


class _DFModule(tnn.Module):
    """Difference-and-sum fusion of the two dates' features, after an
    optional 1x1 reduction to half the channels shared by both."""

    def __init__(self, dim_in, dim_out, reduction=True, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        if reduction:
            self.reduction = Conv1x1(dim_in, dim_in // 2, norm=True,
                                     act=True, **kw)
            dim_in //= 2
        else:
            self.reduction = None
        self.cat1 = _DenseCat(dim_in, dim_out, diff=False, **kw)
        self.cat2 = _DenseCat(dim_in, dim_out, diff=True, **kw)
        self.conv1 = Conv3x3(dim_out, dim_out, norm=True, act=True, **kw)

    def forward(self, x1, x2):
        if self.reduction is not None:
            x1 = self.reduction(x1)
            x2 = self.reduction(x2)
        return self.conv1(self.cat2(x1, x2)) + self.cat1(x1, x2)


class FCCDN(tnn.Module):
    """Feature-constraint change detection network: a siamese encoder of
    double convs with SE, the non-local pyramid at its centre, a decoder
    for each date and the fusion stream between them; ``os`` 16, 8 or 4
    sets where the encoder downsamples and where it dilates.  In training
    it also returns each date's segmentation logits (1 channel, at the
    stride-2 map)."""

    def __init__(self, in_channels=3, num_classes=2, os=16, use_se=True,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        if os >= 16:
            dilation, stride, pool = [1] * 4, [2] * 4, [True] * 4
        elif os == 8:
            dilation, stride = [2, 1, 1, 1], [1, 2, 2, 2]
            pool = [False, True, True, True]
        else:
            dilation, stride = [2, 2, 1, 1], [1, 1, 2, 2]
            pool = [False, False, True, True]
        ch = [256, 128, 64, 32]
        self.block1 = _FCCDNBlock(in_channels, ch[3], pool[3], use_se,
                                  stride[3], dilation[3], **kw)
        self.block2 = _FCCDNBlock(ch[3], ch[2], pool[2], use_se, stride[2],
                                  dilation[2], **kw)
        self.block3 = _FCCDNBlock(ch[2], ch[1], pool[1], use_se, stride[1],
                                  dilation[1], **kw)
        self.block4 = _FCCDNBlock(ch[1], ch[0], pool[0], use_se, stride[0],
                                  dilation[0], **kw)
        self.center = NLFPN(ch[0], True, **kw)
        self.decoder3 = _Cat(ch[0], ch[1], ch[1], pool[0], **kw)
        self.decoder2 = _Cat(ch[1], ch[2], ch[2], pool[1], **kw)
        self.decoder1 = _Cat(ch[2], ch[3], ch[3], pool[2], **kw)
        self.df1 = _DFModule(ch[3], ch[3], True, **kw)
        self.df2 = _DFModule(ch[2], ch[2], True, **kw)
        self.df3 = _DFModule(ch[1], ch[1], True, **kw)
        self.df4 = _DFModule(ch[0], ch[0], True, **kw)
        self.catc3 = _Cat(ch[0], ch[1], ch[1], pool[0], **kw)
        self.catc2 = _Cat(ch[1], ch[2], ch[2], pool[1], **kw)
        self.catc1 = _Cat(ch[2], ch[3], ch[3], pool[2], **kw)
        self.upsample_x2 = nn.Sequential(
            nn.Conv2d(ch[3], 8, 3, padding=1, **kw),
            nn.BatchNorm(8, device=kw["device"]), nn.Activation("relu"))
        self.conv_out = nn.Conv2d(8, num_classes, 3, padding=1, **kw)
        self.conv_out_class = nn.Conv2d(ch[3], 1, 1, **kw)

    def _encode(self, x):
        e1 = self.block1(x)
        e2 = self.block2(e1)
        e3 = self.block3(e2)
        return e1, e2, e3, self.center(self.block4(e3))

    def forward(self, t1, t2):
        e1_1, e2_1, e3_1, y1 = self._encode(t1)
        e1_2, e2_2, e3_2, y2 = self._encode(t2)
        c = self.df4(y1, y2)
        y1 = self.decoder3(y1, e3_1)
        y2 = self.decoder3(y2, e3_2)
        c = self.catc3(c, self.df3(y1, y2))
        y1 = self.decoder2(y1, e2_1)
        y2 = self.decoder2(y2, e2_2)
        c = self.catc2(c, self.df2(y1, y2))
        y1 = self.decoder1(y1, e1_1)
        y2 = self.decoder1(y2, e1_2)
        c = self.catc1(c, self.df1(y1, y2))
        y = self.conv_out(_up2(self.upsample_x2(c)))
        if self.training:
            return [y, self.conv_out_class(y1), self.conv_out_class(y2)]
        return y
