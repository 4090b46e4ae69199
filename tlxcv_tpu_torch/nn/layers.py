"""Layers of the ViT slice, NHWC at every public call.

Counterpart of ``tlxcv_tpu/nn/layers.py``: the same dtype discipline
(parameters f32, compute follows the input's dtype, normalisation
statistics in f32) and the same attribute names, with torch's weight
layouts: conv ``(O, I, kh, kw)``, dense ``(out, in)``.  Each layer takes
an explicit ``device`` (``None``: the CUDA card) and a ``torch.Generator``
for its initial weights.  The int8 serving and QAT branches belong to a
later slice.
"""
from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from ..core import init as I
from ..device import resolve_device

__all__ = ["Conv2d", "Linear", "LayerNorm", "Dropout", "DropPath",
           "Identity", "get_activation"]


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


_ACTS: dict[str, tp.Callable] = {
    "relu": F.relu, "relu6": F.relu6, "gelu": _gelu, "silu": F.silu,
    "swish": F.silu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
    "hardswish": F.hardswish, "hard_swish": F.hardswish,
    "hardsigmoid": F.hardsigmoid, "hard_sigmoid": F.hardsigmoid,
    "leaky_relu": F.leaky_relu, "leakyrelu": F.leaky_relu, "mish": F.mish,
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


class Identity(nn.Module):
    def forward(self, x, *a, **k):
        return x


def _int8_unported(layer):
    raise NotImplementedError(
        f"{type(layer).__name__}: int8 weights belong to the int8 serving "
        "slice, which is not ported yet")


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _conv_padding(padding):
    """Normalise a padding spec: 'SAME'/'VALID', an int, per-dim ints, or
    explicit ((lo, hi), ...).  Integers pad both sides, as in torch."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return ((padding, padding),) * 2
    padding = list(padding)
    if all(isinstance(p, int) for p in padding):
        return tuple((p, p) for p in padding)
    return tuple(tuple(p) for p in padding)


def _explicit_pads(padding, in_hw, kernel, stride, dilation):
    if padding == "VALID":
        return ((0, 0), (0, 0))
    if padding == "SAME":  # lax's rule: the odd pixel goes after
        pads = []
        for n, k, s, d in zip(in_hw, kernel, stride, dilation):
            total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
            pads.append((total // 2, total - total // 2))
        return tuple(pads)
    return padding


class Conv2d(nn.Module):
    """2D convolution, NHWC in and out, weight stored OIHW."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, bias=True, w_init=None,
                 b_init=None, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
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

    def forward(self, x):
        w = self.weight
        if w.dtype == torch.int8:
            _int8_unported(self)
        x = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC bytes
        (h0, h1), (w0, w1) = _explicit_pads(
            self.padding, x.shape[2:], self.kernel_size, self.stride,
            self.dilation)
        if h0 == h1 and w0 == w1:
            pad = (h0, w0)
        else:
            x = F.pad(x, (w0, w1, h0, h1))
            pad = 0
        y = F.conv2d(x, w.to(x.dtype), None, self.stride, pad, self.dilation,
                     self.groups).permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class Linear(nn.Module):
    """Dense layer, weight ``(out, in)``.  The bias is added after the
    product, in the input's dtype, as the JAX layer does."""

    def __init__(self, in_features, out_features, bias=True, w_init=None,
                 b_init=None, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
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
            _int8_unported(self)
        y = F.linear(x, w.to(x.dtype))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


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
