"""Weight initializers drawing from an explicit ``torch.Generator``.

Counterpart of ``tlxcv_tpu/core/init.py``.  Values are drawn on the CPU
from the given generator (``None``: torch's default one) and then moved to
``device``, so a seed gives the same weights on every device.  Shapes use
the port's layouts: dense weights ``(out, in)``, conv weights ``(O, I, kh,
kw)``.
"""
from __future__ import annotations

import math

import torch

_F32 = torch.float32


def _place(x, device):
    return x.to(device) if device is not None else x


def zeros(shape, generator=None, device=None):
    return torch.zeros(shape, dtype=_F32, device=device)


def ones(shape, generator=None, device=None):
    return torch.ones(shape, dtype=_F32, device=device)


def constant(shape, value, generator=None, device=None):
    return torch.full(shape, float(value), dtype=_F32, device=device)


def normal(shape, std=0.02, mean=0.0, generator=None, device=None):
    x = torch.randn(shape, generator=generator, dtype=_F32)
    return _place(x * std + mean, device)


def uniform(shape, minval=-0.05, maxval=0.05, generator=None, device=None):
    x = torch.rand(shape, generator=generator, dtype=_F32)
    return _place(x * (maxval - minval) + minval, device)


def truncated_normal(shape, std=0.02, mean=0.0, generator=None, device=None):
    # truncate at 2 std by resampling what falls outside
    x = torch.randn(shape, generator=generator, dtype=_F32)
    bad = x.abs() > 2.0
    while bad.any():
        x[bad] = torch.randn(int(bad.sum()), generator=generator, dtype=_F32)
        bad = x.abs() > 2.0
    return _place(x * std + mean, device)


def _fan(shape):
    """fan_in/fan_out for dense ``(out, in)`` or conv ``(O, I, *kernel)``."""
    if len(shape) == 2:
        return shape[1], shape[0]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def kaiming_normal(shape, mode="fan_in", nonlinearity="relu", generator=None,
                   device=None):
    fan_in, fan_out = _fan(shape)
    fan = fan_in if mode == "fan_in" else fan_out
    gain = math.sqrt(2.0) if nonlinearity == "relu" else 1.0
    return normal(shape, std=gain / math.sqrt(max(fan, 1)),
                  generator=generator, device=device)


def kaiming_uniform(shape, mode="fan_in", nonlinearity="relu", generator=None,
                    device=None):
    fan_in, fan_out = _fan(shape)
    fan = fan_in if mode == "fan_in" else fan_out
    gain = math.sqrt(2.0) if nonlinearity == "relu" else 1.0
    bound = gain * math.sqrt(3.0 / max(fan, 1))
    return uniform(shape, -bound, bound, generator=generator, device=device)


def xavier_normal(shape, gain=1.0, generator=None, device=None):
    fan_in, fan_out = _fan(shape)
    std = gain * math.sqrt(2.0 / max(fan_in + fan_out, 1))
    return normal(shape, std=std, generator=generator, device=device)


def xavier_uniform(shape, gain=1.0, generator=None, device=None):
    fan_in, fan_out = _fan(shape)
    bound = gain * math.sqrt(6.0 / max(fan_in + fan_out, 1))
    return uniform(shape, -bound, bound, generator=generator, device=device)
