"""Layers of the ported slices, NHWC at every public call.

Counterpart of ``tlxcv_tpu/nn/layers.py``: the same dtype discipline
(parameters f32, compute follows the input's dtype, normalisation
statistics in f32) and the same attribute names, with torch's weight
layouts: conv ``(O, I, kh, kw)``, dense ``(out, in)``.  Each layer takes
an explicit ``device`` (``None``: the CUDA card) and a ``torch.Generator``
for its initial weights.

int8 serving (``ops.quant``): a quantized Conv2d or Linear holds its weight
as int8 codes packed once as ``[out, Kp]``, K-contiguous in ``(kh, kw,
Cin)`` order and zero-padded to ``Kp`` (a multiple of 16), with a per-out
channel ``w_scale``.  With a calibrated ``a_scale`` a conv runs as im2col
plus the int8 product and the reference's epilogue (scale, bias, fused
ReLU, requantize): on the card one launch of the hand-written kernel,
``ops.cuda.matmul.int8_matmul_requant``, which writes no int32 sums; on the
CPU its plain version, the int32 product, then ``requantize``.  Without
``a_scale``, the weight is dequantized and the layer runs in float.  A
grouped conv (``groups`` > 1) runs one such product per group.

Quantization-aware training (``ops.quant.enable_qat``): a flagged float
Conv2d or Linear fake-quantizes its weight per output channel with the
scale and clip of ``ops.quant.quantize_weights``, and, once calibrated,
its input with its ``a_scale``, each with a straight-through estimator.
"""
from __future__ import annotations

import math
import typing as tp

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core import init as I
from ..device import resolve_device
from ..ops.cuda.matmul import int8_matmul_requant, pad_k, padded_k

__all__ = ["Conv2d", "Conv3d", "ConvTranspose2d", "Linear", "Embedding",
           "BatchNorm", "BatchNorm2d", "LayerNorm", "GroupNorm", "PReLU",
           "MaxPool2d", "AvgPool2d", "MaxPool3d", "AvgPool3d",
           "AdaptiveAvgPool2d", "GlobalAvgPool2d",
           "Dropout", "DropPath", "Identity", "Sequential", "Activation",
           "leaky_relu", "relu", "get_activation", "set_quant_attr"]


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


# ResNet calls ``nn.relu`` through the package at call time, so that the
# quantization trace (ops.quant._trace) can patch it.  Not in place: the
# trace tells tensors apart by id().
relu = F.relu


def leaky_relu(x, negative_slope=0.01):
    """``jax.nn.leaky_relu``: ``x`` where ``x >= 0``, else
    ``negative_slope * x`` (DarkNet's ConvBNLayer takes 0.1)."""
    return F.leaky_relu(x, negative_slope)

_ACTS: dict[str, tp.Callable] = {
    "relu": F.relu, "relu6": F.relu6, "gelu": _gelu, "silu": F.silu,
    "swish": F.silu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
    "hardswish": F.hardswish, "hard_swish": F.hardswish,
    "hardsigmoid": F.hardsigmoid, "hard_sigmoid": F.hardsigmoid,
    "leaky_relu": leaky_relu, "leakyrelu": leaky_relu, "mish": F.mish,
    "identity": lambda x: x, "linear": lambda x: x,
}


def get_activation(act) -> tp.Callable:
    """Resolve an activation given a name, callable, or None."""
    if act is None:
        return lambda x: x
    if callable(act):
        return act
    try:
        return _ACTS[act.lower()]
    except KeyError:
        raise ValueError(f"unknown activation {act!r}") from None


class Activation(nn.Module):
    def __init__(self, act):
        super().__init__()
        self.fn = get_activation(act)

    def forward(self, x):
        return self.fn(x)


class Identity(nn.Module):
    def forward(self, x, *a, **k):
        return x


class PReLU(nn.Module):
    """Parametric ReLU: ``x`` where ``x >= 0``, else ``a * x``, the slope
    (one shared by default) cast to x's dtype."""

    def __init__(self, num_parameters=1, init=0.25, device=None):
        super().__init__()
        self.weight = nn.Parameter(I.constant(
            (num_parameters,), init, device=resolve_device(device)))

    def forward(self, x):
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


class Sequential(nn.Module):
    """Children in a ModuleList named ``layers``, as the JAX Sequential
    keeps them, so that state paths read ``layer1.layers.0.conv1``."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)):
            layers = tuple(layers[0])
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x

    def __getitem__(self, i):
        return self.layers[i]

    def __len__(self):
        return len(self.layers)


def _ntuple(v, n):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


def _pair(v):
    return _ntuple(v, 2)


def _conv_padding(padding, nd=2):
    """Normalise a padding spec: 'SAME'/'VALID', an int, per-dim ints, or
    explicit ((lo, hi), ...).  Integers pad both sides, as in torch."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return ((padding, padding),) * nd
    padding = list(padding)
    if all(isinstance(p, int) for p in padding):
        return tuple((p, p) for p in padding)
    return tuple(tuple(p) for p in padding)


def _explicit_pads(padding, in_hw, kernel, stride, dilation):
    """Per spatial dim (lo, hi) pads, for any number of dims."""
    if padding == "VALID":
        return ((0, 0),) * len(in_hw)
    if padding == "SAME":  # lax's rule: the odd pixel goes after
        pads = []
        for n, k, s, d in zip(in_hw, kernel, stride, dilation):
            total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
            pads.append((total // 2, total - total // 2))
        return tuple(pads)
    return padding


def _out_size(n, pads, k, s, d):
    return (n + pads[0] + pads[1] - d * (k - 1) - 1) // s + 1


def _torch_pads(pads):
    """(lo, hi) per spatial dim, first dim first, as ``F.pad``'s flat
    list, last dim first."""
    return [p for lo_hi in reversed(pads) for p in lo_hi]


# ------------------------------------------------------------------ int8
_QUANT_BUFFERS = ("w_scale", "a_scale", "out_scale")


def set_quant_attr(mod, name, value):
    """Give a Conv2d or Linear one of the tensors that quantization adds:
    a scale (a buffer) or the bias of a folded BatchNorm (a parameter).
    ``None`` removes a bias."""
    if name == "bias":
        mod.bias = None if value is None else nn.Parameter(
            torch.as_tensor(value, dtype=torch.float32,
                            device=mod.weight.device))
    elif name in _QUANT_BUFFERS:
        mod.register_buffer(name, torch.as_tensor(
            value, dtype=torch.float32, device=mod.weight.device).clone())
    else:
        raise ValueError(f"{name!r} is not a quantization tensor")


def _quantize_input(x, s_in):
    return torch.round(x.float() / s_in).clamp(-127, 127).to(torch.int8)


def _int8_product(mod, cols, w, s_in, out_dtype, rows=slice(None)):
    """int8 patches [M, Kp] times the packed weight's ``rows``, then the
    reference's epilogue in its op order (scale the int32 sums, add the
    bias; with ``out_scale``, ReLU if it was fused and requantize to int8,
    round half to even as jnp.round).  On the card one kernel does both,
    writing no int32 sums; on the CPU the plain product, then the same
    arithmetic."""
    out_scale = getattr(mod, "out_scale", None)
    relu = out_scale is not None and getattr(mod, "relu_fused", False)
    bias = None if mod.bias is None else mod.bias[rows]
    return int8_matmul_requant(cols, w[rows], s_in * mod.w_scale[rows], bias,
                               relu, out_scale, out_dtype)


def _serving_only(x):
    """The int8 product has no backward and the quantized input carries no
    gradient: on the card, an input that requires grad raises where
    autograd would record, instead of handing back no gradient."""
    if x.is_cuda and torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("the int8 layer has no backward: call it under "
                           "torch.no_grad() or torch.inference_mode()")


def true_div(x, divisor: float):
    """``x / divisor`` correctly rounded on every device: the card divides
    by a Python number as a multiply by its rounded reciprocal, which can
    land an ulp off the CPU's quotient; a tensor divisor is divided."""
    return x / x.new_full((), divisor)


def _int8_weight(w_int8):
    return nn.Parameter(w_int8, requires_grad=False)


# ------------------------------------------------------------------- QAT
def _fake_quant_w(w):
    """Per-output-channel symmetric int8 fake quant with a straight-through
    estimator, ``f + (q - f).detach()``.  The scale is bitwise the one
    ``ops.quant.quantize_weights`` computes (``max|w| / 127`` over every
    axis but the first, the output channel of OIHW and (out, in), at least
    1e-12) and the codes are its codes, so the forward sees the weight the
    int8 serving path will load; the gradient reaches the float master
    unchanged.  The arithmetic is f32, the result in ``w``'s dtype (under
    a bf16 compute policy: the fake quant of the bf16 cast of the
    masters, as in the reference)."""
    f = w.float()
    s = torch.clamp_min(true_div(f.abs().amax(dim=tuple(range(1, f.ndim)),
                                              keepdim=True), 127.0), 1e-12)
    q = torch.round(f / s).clamp(-127, 127) * s
    return (f + (q - f).detach()).to(w.dtype)


def _fake_quant_a(x, s_in):
    """Static activation fake quant with the calibrated scalar scale,
    straight-through on x: the serving path's input quantization.  The
    scale is a buffer, so it takes no gradient and no update, and stays
    f32 under a bf16 compute policy (the reference's Trainer casts its
    ``a_scale`` parameter to bf16): the scale the int8 layer will serve
    with."""
    f = x.float()
    q = torch.round(f / s_in).clamp(-127, 127) * s_in
    return (f + (q - f).detach()).to(x.dtype)


def _qat_wx(mod, w, x):
    """QAT fake quant of (weight, input) per the module's ``enable_qat``
    flags."""
    if getattr(mod, "_qat", False):
        w = _fake_quant_w(w)
        a_scale = getattr(mod, "a_scale", None)
        if getattr(mod, "_qat_act", False) and a_scale is not None:
            x = _fake_quant_a(x, a_scale)
    return w, x


class Conv2d(nn.Module):
    """2D convolution, NHWC in and out, weight stored OIHW (packed
    ``[out, Kp]`` int8 once quantized)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, bias=True, w_init=None,
                 b_init=None, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.in_channels = in_channels
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride)
        self.dilation = _pair(dilation)
        self.groups = groups
        self.padding = _conv_padding(padding)
        shape = (out_channels, in_channels // groups, *self.kernel_size)
        w_init = w_init or (lambda s, **kw: I.kaiming_normal(
            s, mode="fan_out", **kw))
        self.weight = nn.Parameter(
            w_init(shape, generator=generator, device=device))
        if bias:
            b_init = b_init or I.zeros
            self.bias = nn.Parameter(
                b_init((out_channels,), generator=generator, device=device))
        else:
            self.bias = None

    def _pads(self, hw):
        return _explicit_pads(self.padding, hw, self.kernel_size,
                              self.stride, self.dilation)

    def _conv(self, x, w):
        x = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC bytes
        (h0, h1), (w0, w1) = self._pads(x.shape[2:])
        if h0 == h1 and w0 == w1:
            pad = (h0, w0)
        else:
            x = F.pad(x, (w0, w1, h0, h1))
            pad = 0
        return F.conv2d(x, w, None, self.stride, pad, self.dilation,
                        self.groups).permute(0, 2, 3, 1)

    def forward(self, x):
        w = self.weight
        if w.dtype == torch.int8:
            return self._int8_call(x, w)
        w, x = _qat_wx(self, w, x)
        y = self._conv(x, w.to(x.dtype))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y

    # int8 serving -----------------------------------------------------
    def load_int8(self, codes, w_scale):
        """Take int8 codes in the float layout (OIHW) and their per-out
        channel scale; the codes are packed once as [out, Kp]."""
        cout = codes.shape[0]
        codes = codes.to(self.weight.device)
        packed = pad_k(codes.permute(0, 2, 3, 1).reshape(cout, -1))
        self.weight = _int8_weight(packed.contiguous())
        set_quant_attr(self, "w_scale", w_scale)

    def _unpacked(self):
        """The int8 codes back in OIHW."""
        kh, kw = self.kernel_size
        cin = self.in_channels // self.groups
        w = self.weight[:, :kh * kw * cin]
        return w.reshape(-1, kh, kw, cin).permute(0, 3, 1, 2)

    def _patches(self, xq, kp=True):
        """im2col of an NHWC int8 input: [N*Ho*Wo, Kp] rows in (kh, kw, Cin)
        order, zero columns up to Kp (``kp`` False: K columns).  Built from
        shifted slices (torch's unfold has no int8 kernel); a 1x1 stride-1
        conv takes the input as it is."""
        n, h, w, c = xq.shape
        (kh, kw), (sh, sw), (dh, dw) = (self.kernel_size, self.stride,
                                        self.dilation)
        (h0, h1), (w0, w1) = self._pads((h, w))
        ho = _out_size(h, (h0, h1), kh, sh, dh)
        wo = _out_size(w, (w0, w1), kw, sw, dw)
        k = kh * kw * c
        if (kh, kw, sh, sw, h0, h1, w0, w1) == (1, 1, 1, 1, 0, 0, 0, 0) \
                and (k == padded_k(k) or not kp):
            return xq.reshape(n * h * w, c), (n, ho, wo)
        if h0 or h1 or w0 or w1:
            xq = F.pad(xq, (0, 0, w0, w1, h0, h1))
        cols = [xq[:, i * dh:i * dh + (ho - 1) * sh + 1:sh,
                   j * dw:j * dw + (wo - 1) * sw + 1:sw, :]
                for i in range(kh) for j in range(kw)]
        if kp and padded_k(k) > k:
            cols.append(xq.new_zeros(n, ho, wo, padded_k(k) - k))
        return torch.cat(cols, dim=-1).reshape(n * ho * wo, -1), (n, ho, wo)

    def _group_patches(self, xq):
        """im2col of a grouped conv: [G, N*Ho*Wo, Kp] int8, group j's rows
        in (kh, kw, Cin/G) order over its own input channels, zero columns
        up to Kp; each group's matrix contiguous."""
        cols, shape = self._patches(xq, kp=False)
        m, g = cols.shape[0], self.groups
        taps = self.kernel_size[0] * self.kernel_size[1]
        cols = cols.reshape(m, taps, g, -1).permute(2, 0, 1, 3)
        return pad_k(cols.reshape(g, m, -1)).contiguous(), shape

    def _int8_call(self, x, w):
        """Quantized serving path (counterpart of the reference's
        ``Conv2d._int8_call``).  With ``a_scale`` the conv runs int8 x int8
        -> int32; with ``out_scale`` (ops.quant.fuse_requantize) it emits
        the next layer's int8 codes, which that layer takes as they are.
        int8 in gives bf16 out."""
        int8_in = x.dtype == torch.int8
        out_dtype = x.dtype if x.dtype in (torch.float32, torch.bfloat16) \
            else (torch.bfloat16 if int8_in else torch.float32)
        a_scale = getattr(self, "a_scale", None)
        if a_scale is not None:
            _serving_only(x)
            xq = x if int8_in else _quantize_input(x, a_scale)
            if self.groups != 1:
                return self._grouped_int8(xq, w, a_scale, out_dtype)
            cols, (n, ho, wo) = self._patches(xq)
            y = _int8_product(self, cols, w, a_scale, out_dtype)
            return y.reshape(n, ho, wo, -1)
        wf = (self._unpacked().float()
              * self.w_scale[:, None, None, None]).to(out_dtype)
        y = self._conv(x.to(out_dtype), wf)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y.to(out_dtype)

    def _grouped_int8(self, xq, w, a_scale, out_dtype):
        """The reference's int8 conv with ``feature_group_count``: group j's
        patches times rows j*Cout/G.. of the packed weight, each group one
        call of the fused GEMM (one kernel launch on the card) with its
        slice of the epilogue's scale and bias, the outputs side by side in
        channel order."""
        cols, (n, ho, wo) = self._group_patches(xq)
        og = w.shape[0] // self.groups
        y = torch.cat([_int8_product(self, cols[j], w, a_scale, out_dtype,
                                     slice(j * og, (j + 1) * og))
                       for j in range(self.groups)], dim=-1)
        return y.reshape(n, ho, wo, -1)


class ConvTranspose2d(nn.Module):
    """Transposed 2D convolution, NHWC in and out, torch geometry: output
    ``(H - 1)·s - 2p + k + output_padding``.  The weight is torch's
    ``(in, out/groups, kh, kw)``; the JAX package's HWIO ``(kh, kw, in/g,
    out)`` kernel maps onto it with no flip (``utils.bridge``), since
    ``F.conv_transpose2d`` is the lhs-dilated conv with the flipped kernel
    that the reference spells out.  The default init is the reference's,
    kaiming normal over fan_out = out·kh·kw."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, bias=True, groups=1,
                 w_init=None, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.output_padding = _pair(output_padding)
        self.groups = groups
        kh, kw = self.kernel_size
        shape = (in_channels, out_channels // groups, kh, kw)
        if w_init is None:
            std = math.sqrt(2.0) / math.sqrt(out_channels * kh * kw)
            w_init = lambda s, **kw_: I.normal(s, std=std, **kw_)  # noqa: E731
        self.weight = nn.Parameter(
            w_init(shape, generator=generator, device=device))
        self.bias = nn.Parameter(I.zeros((out_channels,), device=device)) \
            if bias else None

    def forward(self, x):
        y = F.conv_transpose2d(
            x.permute(0, 3, 1, 2), self.weight.to(x.dtype), None,
            self.stride, self.padding, self.output_padding, self.groups)
        y = y.permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class Conv3d(nn.Module):
    """3D convolution, NDHWC in and out, weight stored OIDHW (the JAX
    package's DHWIO, ``utils.bridge``), as I3D's video nets take it.
    "SAME" follows lax's rule, the odd pixel after (a 7x7x7 stem at
    stride 2 pads (2, 3) on an even side), which ``F.conv3d``'s symmetric
    padding cannot express: uneven pads go through ``F.pad`` first."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding="SAME", bias=True, w_init=None, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        self.kernel_size = _ntuple(kernel_size, 3)
        self.stride = _ntuple(stride, 3)
        self.padding = _conv_padding(padding, nd=3)
        shape = (out_channels, in_channels, *self.kernel_size)
        w_init = w_init or (lambda s, **kw: I.kaiming_normal(
            s, mode="fan_out", **kw))
        self.weight = nn.Parameter(
            w_init(shape, generator=generator, device=device))
        self.bias = (nn.Parameter(I.zeros((out_channels,), device=device))
                     if bias else None)

    def forward(self, x):
        x = x.permute(0, 4, 1, 2, 3)  # NCDHW view of the NDHWC bytes
        pads = _explicit_pads(self.padding, x.shape[2:], self.kernel_size,
                              self.stride, (1, 1, 1))
        if all(lo == hi for lo, hi in pads):
            pad = tuple(lo for lo, _ in pads)
        else:
            x = F.pad(x, _torch_pads(pads))
            pad = 0
        y = F.conv3d(x, self.weight.to(x.dtype), None, self.stride,
                     pad).permute(0, 2, 3, 4, 1)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class Linear(nn.Module):
    """Dense layer, weight ``(out, in)`` (packed ``[out, Kp]`` int8 once
    quantized).  The bias is added after the product, in the input's
    dtype, as the JAX layer does."""

    def __init__(self, in_features, out_features, bias=True, w_init=None,
                 b_init=None, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.in_features = in_features
        shape = (out_features, in_features)
        w_init = w_init or (lambda s, **kw: I.kaiming_uniform(
            s, nonlinearity="linear", **kw))
        self.weight = nn.Parameter(
            w_init(shape, generator=generator, device=device))
        if bias:
            b_init = b_init or I.zeros
            self.bias = nn.Parameter(
                b_init((out_features,), generator=generator, device=device))
        else:
            self.bias = None

    def forward(self, x):
        w = self.weight
        if w.dtype == torch.int8:
            return self._int8_call(x, w)
        w, x = _qat_wx(self, w, x)
        y = F.linear(x, w.to(x.dtype))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y

    def load_int8(self, codes, w_scale):
        """Take int8 codes in the float layout (out, in) and their per-out
        channel scale; the codes are padded once to [out, Kp]."""
        codes = codes.to(self.weight.device)
        self.weight = _int8_weight(pad_k(codes).contiguous())
        set_quant_attr(self, "w_scale", w_scale)

    def _int8_call(self, x, w):
        """Quantized serving path (counterpart of the reference's
        ``Linear._int8_call``); the output keeps a float input's dtype."""
        out_dtype = x.dtype if x.dtype in (torch.float32, torch.bfloat16) \
            else torch.float32
        a_scale = getattr(self, "a_scale", None)
        if a_scale is not None:
            _serving_only(x)
            xq = _quantize_input(x, a_scale).reshape(-1, self.in_features)
            y = _int8_product(self, pad_k(xq), w, a_scale, out_dtype)
            return y.reshape(*x.shape[:-1], -1)
        wf = (w[:, :self.in_features].float()
              * self.w_scale[:, None]).to(out_dtype)
        y = F.linear(x.to(out_dtype), wf)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y.to(out_dtype)


class Embedding(nn.Module):
    """A lookup table ``[num_embeddings, features]`` (initial std 0.02, as
    the JAX layer); rows come out in the table's dtype."""

    def __init__(self, num_embeddings, features, w_init=None, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        w_init = w_init or (lambda s, **kw: I.normal(s, std=0.02, **kw))
        self.weight = nn.Parameter(w_init((num_embeddings, features),
                                          generator=generator, device=device))

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class BatchNorm(nn.Module):
    """Batch normalisation over every axis but the last (channel) one.

    ``momentum`` is the fraction of the running statistics KEPT per
    training step (the JAX package's convention, 0.9; torch's own momentum
    is the updated fraction), and ``running_var`` takes the unbiased batch
    variance.  The running statistics are buffers, updated in place.  In
    eval the scale and offset are computed in f32 and applied in the
    input's dtype.  A BatchNorm folded into its conv (``ops.quant.
    fold_batchnorm``) returns the very tensor object it was given."""

    def __init__(self, num_features, eps=1e-5, momentum=0.9, affine=True,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.eps = eps
        self.momentum = momentum
        if affine:
            self.weight = nn.Parameter(I.ones((num_features,), device=device))
            self.bias = nn.Parameter(I.zeros((num_features,), device=device))
        else:
            self.weight = self.bias = None
        self.register_buffer("running_mean",
                             I.zeros((num_features,), device=device))
        self.register_buffer("running_var",
                             I.ones((num_features,), device=device))

    def forward(self, x):
        if getattr(self, "_folded", False):
            if self.training:
                raise RuntimeError(
                    "BatchNorm was folded for serving; it cannot be "
                    "trained (rebuild the model for training)")
            return x
        axes = tuple(range(x.ndim - 1))
        if self.training:
            xf = x.float()
            mean = xf.mean(axes)
            var = xf.var(axes, correction=0)
            n = x.numel() // x.shape[-1]
            var_u = var * (n / max(n - 1, 1))
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var
                                       + (1 - m) * var_u)
        else:
            mean, var = self.running_mean, self.running_var
        scale = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            scale = scale * self.weight
        offset = -mean * scale
        if self.bias is not None:
            offset = offset + self.bias
        return x * scale.to(x.dtype) + offset.to(x.dtype)


BatchNorm2d = BatchNorm  # NHWC: one reduction for 1d/2d/3d inputs


class LayerNorm(nn.Module):
    """Mean and population variance in f32, ``rsqrt(var + eps)`` and the
    affine in f32, then back to the input's dtype."""

    def __init__(self, num_features, eps=1e-5, affine=True, device=None):
        super().__init__()
        device = resolve_device(device)
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(I.ones((num_features,), device=device))
            self.bias = nn.Parameter(I.zeros((num_features,), device=device))
        else:
            self.weight = self.bias = None

    def forward(self, x):
        # torch's layer_norm keeps the statistics and the affine in f32 for
        # bf16 input; weights of another dtype than x (f32 weights, bf16
        # input) go through f32 so they are not rounded to x's dtype
        w, b = self.weight, self.bias
        if w is not None and w.dtype != x.dtype:
            return F.layer_norm(x.float(), x.shape[-1:], w.float(), b.float(),
                                self.eps).to(x.dtype)
        return F.layer_norm(x, x.shape[-1:], w, b, self.eps)


class GroupNorm(nn.Module):
    """Group normalisation of NHWC input over (H, W, C / groups), channel
    ``c`` in group ``c // (C / groups)``: statistics, normalisation and
    affine in f32 (``F.group_norm`` on an f32 copy, since on a bf16 tensor
    it applies the affine in bf16), then back to the input's dtype."""

    def __init__(self, num_groups, num_channels, eps=1e-5, affine=True,
                 device=None):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f"{num_channels} channels do not split into "
                             f"{num_groups} groups")
        device = resolve_device(device)
        self.num_groups = num_groups
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(I.ones((num_channels,), device=device))
            self.bias = nn.Parameter(I.zeros((num_channels,), device=device))
        else:
            self.weight = self.bias = None

    def forward(self, x):
        acc = _acc_dtype(x)
        w, b = self.weight, self.bias
        y = F.group_norm(x.to(acc).movedim(-1, 1), self.num_groups,
                         None if w is None else w.to(acc),
                         None if b is None else b.to(acc), self.eps)
        return y.movedim(1, -1).to(x.dtype)


# --------------------------------------------------------------- pooling
_MAX_POOL = {2: F.max_pool2d, 3: F.max_pool3d}
_SUM_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _pool_geometry(x, window, stride, padding):
    """Window, stride and (lo, hi) pads over the spatial dims of a
    channels-last ``x`` (2 for NHWC, 3 for NDHWC)."""
    nd = x.ndim - 2
    window = _ntuple(window, nd)
    stride = window if stride is None else _ntuple(stride, nd)
    if isinstance(padding, str):
        pads = _explicit_pads(padding.upper(), x.shape[1:-1], window, stride,
                              (1,) * nd)
    else:
        pads = tuple((p, p) for p in _ntuple(padding, nd))
    return window, stride, pads


def _max_pool(x, window, stride, padding):
    """Window max; padding never wins (-inf, or the integer type's least
    value for int8 codes, NHWC only)."""
    window, stride, pads = _pool_geometry(x, window, stride, padding)
    if x.is_floating_point():
        xc = x.movedim(-1, 1)
        if all(lo == hi <= k // 2 for (lo, hi), k in zip(pads, window)):
            pad = tuple(lo for lo, _ in pads)
        else:
            xc = F.pad(xc, _torch_pads(pads), value=float("-inf"))
            pad = 0
        return _MAX_POOL[len(window)](xc, window, stride, pad).movedim(1, -1)
    # integer codes: shifted slices (no int8 pooling kernel is assumed)
    (kh, kw), (sh, sw), ((h0, h1), (w0, w1)) = window, stride, pads
    n, h, w, c = x.shape
    ho = _out_size(h, (h0, h1), kh, sh, 1)
    wo = _out_size(w, (w0, w1), kw, sw, 1)
    xp = F.pad(x, (0, 0, w0, w1, h0, h1), value=torch.iinfo(x.dtype).min)
    out = None
    for i in range(kh):
        for j in range(kw):
            s = xp[:, i:i + (ho - 1) * sh + 1:sh, j:j + (wo - 1) * sw + 1:sw]
            out = s if out is None else torch.maximum(out, s)
    return out.contiguous()


def _acc_dtype(x):
    """f32 for the sums of f32 and bf16 inputs; float64 inputs (a CPU
    reference) stay float64."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _avg_pool(x, window, stride, padding):
    """Window mean in f32 that leaves padding out of the count (torch's
    count_include_pad=False), back in the input's dtype."""
    window, stride, pads = _pool_geometry(x, window, stride, padding)
    acc = _acc_dtype(x)
    flat = _torch_pads(pads)
    xf = F.pad(x.to(acc).movedim(-1, 1), flat)
    ones = F.pad(x.new_ones((1, 1, *x.shape[1:-1]), dtype=acc), flat)
    pool = _SUM_POOL[len(window)]
    summed = pool(xf, window, stride, divisor_override=1)
    counts = pool(ones, window, stride, divisor_override=1)
    return (summed / counts).movedim(1, -1).to(x.dtype)


class MaxPool2d(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding

    def forward(self, x):
        return _max_pool(x, self.k, self.s, self.p)


class AvgPool2d(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0):
        super().__init__()
        self.k, self.s, self.p = kernel_size, stride, padding

    def forward(self, x):
        return _avg_pool(x, self.k, self.s, self.p)


class MaxPool3d(MaxPool2d):
    """Window max over (D, H, W) of NDHWC input, -inf padding."""


class AvgPool3d(AvgPool2d):
    """Window mean over (D, H, W) of NDHWC input, padding out of the
    count."""


def _avg_matrix(inp, out):
    """Output bin i averages input rows [floor(i*inp/out),
    ceil((i+1)*inp/out)), as torch's adaptive_avg_pool2d."""
    m = np.zeros((out, inp), np.float32)
    for i in range(out):
        a = (i * inp) // out
        b = -(-((i + 1) * inp) // out)
        m[i, a:b] = 1.0 / (b - a)
    return torch.from_numpy(m)


class AdaptiveAvgPool2d(nn.Module):
    """Adaptive average pool to a fixed (h, w) output (NHWC)."""

    def __init__(self, output_size):
        super().__init__()
        self.output_size = _pair(output_size)

    def forward(self, x):
        oh, ow = self.output_size
        n, h, w, c = x.shape
        if h % oh == 0 and w % ow == 0:
            return x.reshape(n, oh, h // oh, ow, w // ow, c).mean((2, 4))
        acc = _acc_dtype(x)
        ah = _avg_matrix(h, oh).to(x.device, acc)
        aw = _avg_matrix(w, ow).to(x.device, acc)
        out = torch.einsum("ih,nhwc->niwc", ah, x.to(acc))
        out = torch.einsum("jw,niwc->nijc", aw, out)
        return out.to(x.dtype)


class GlobalAvgPool2d(nn.Module):
    def __init__(self, keepdims=False):
        super().__init__()
        self.keepdims = keepdims

    def forward(self, x):
        return x.mean((1, 2), keepdim=self.keepdims)


# -------------------------------------------------------- regularisation
def _keep_mask(shape, keep, generator, device):
    """Bernoulli(keep) mask drawn from ``generator`` (torch's default one
    on ``device`` when None)."""
    where = generator.device if generator is not None else device
    u = torch.rand(shape, generator=generator, device=where)
    return (u < keep).to(device)


class Dropout(nn.Module):
    def __init__(self, p=0.5, generator=None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        mask = _keep_mask(x.shape, keep, self.generator, x.device)
        return torch.where(mask, x / keep, 0.0).to(x.dtype)


class DropPath(nn.Module):
    """Stochastic depth: drop the whole residual branch per sample."""

    def __init__(self, p=0.0, generator=None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = _keep_mask(shape, keep, self.generator, x.device)
        return torch.where(mask, x / keep, 0.0).to(x.dtype)
