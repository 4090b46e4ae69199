"""The kernels' forward entries as PyTorch operators, namespace ``tlxcv``.

Each wrapper's forward entry is one operator defined here
(``torch.library.Library``'s ``define`` and ``impl``): its CUDA
implementation launches the kernel, its CPU implementation is the plain
version, and its fake function gives the output's shape, strides and dtype
without running either.  So ``torch.export`` traces through a wrapper (the
ctypes launch takes raw pointers, which fake tensors do not have) and the
exported graph holds the operator, which replays the kernel when it is
served; a loaded artifact needs these operators registered, which importing
``tlxcv_tpu_torch.ops.cuda`` does.  The wrappers' ``autograd.Function``s
stay the outer layer of every path that trains: an operator has no autograd
formula of its own.

The CUDA implementation never calls the plain version, and the CPU one
never launches.
"""
from __future__ import annotations

import torch

__all__ = ["LIB", "define", "needs_grad", "check_device"]

LIB = torch.library.Library("tlxcv", "DEF")


def define(schema: str, cpu, cuda, fake):
    """Define ``tlxcv::<name>`` from ``schema`` with its CPU and CUDA
    implementations and its fake function; returns the operator's overload,
    the cheapest handle to call."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, cpu, "CPU")
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"tlxcv::{name}", fake, lib=LIB)
    return getattr(torch.ops.tlxcv, name).default


def needs_grad(*tensors) -> bool:
    """True where autograd would record a call on ``tensors``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def check_device(name, t):
    """Only CPU and CUDA tensors reach an operator: any other device (a
    meta tensor) would take its fake function and return an empty
    result."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got "
                         f"{t.device}")
