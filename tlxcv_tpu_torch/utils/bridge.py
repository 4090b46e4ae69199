"""Copy weights from the JAX package into a port model.

The JAX package flattens a model with ``split()`` into ``{path: array}``:
attribute names joined by "/", a list index as one segment
(``blocks/3/attn/qkv/weight``).  The port mirrors the attribute names, so
the torch key is the same path joined by "." and no name table is needed.
Layouts differ only for weights: conv HWIO -> OIHW, 3D conv DHWIO ->
OIDHW, transposed conv HWIO ``(kh, kw, in/g, out)`` -> torch's ``(in,
out/g, kh, kw)`` with no flip, dense (in, out) -> (out, in).  Everything
else (embedding tables, ``pos_embed``, ``cls_token``, LayerNorm, biases,
BatchNorm running statistics) copies as it is.

A model quantized by the JAX package's ``ops.quant`` carries int8 weights
and the tensors quantization added (``w_scale``, ``a_scale``,
``out_scale``, a folded conv's ``bias``); the port's layer takes the int8
weight through ``load_int8`` (which packs it) and gains the others.  The
boolean marks (``relu_fused`` on a conv, ``_folded`` on a BatchNorm) are
not in ``split()``; pass them as ``marks``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..nn.layers import (Conv2d, Conv3d, ConvTranspose2d, Linear,
                         set_quant_attr)

__all__ = ["load_jax_params"]

_ADDED_BY_QUANTIZATION = ("a_scale", "out_scale", "bias")


def _to_port_layout(owner, leaf, arr):
    if leaf == "weight" and isinstance(owner, Conv2d):
        return arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if leaf == "weight" and isinstance(owner, Conv3d):
        return arr.transpose(4, 3, 0, 1, 2)  # DHWIO -> OIDHW
    if leaf == "weight" and isinstance(owner, ConvTranspose2d):
        # (kh, kw, in/g, out): output channel j*out/g + o belongs to group
        # j, whose inputs are j*in/g + i -> (in, out/g, kh, kw)
        kh, kw, cin_g, cout = arr.shape
        g = owner.groups
        arr = arr.reshape(kh, kw, cin_g, g, cout // g)
        return arr.transpose(3, 2, 4, 0, 1).reshape(g * cin_g, cout // g,
                                                    kh, kw)
    if leaf == "weight" and isinstance(owner, Linear):
        return arr.T                      # (in, out) -> (out, in)
    return arr


def _owner(model, key):
    owner_name, _, leaf = key.rpartition(".")
    return model.get_submodule(owner_name), leaf


def _take_quantized(model, flat):
    """Give each layer whose JAX weight is int8 its int8 weight with its
    ``w_scale``, and the other tensors quantization added."""
    for key, arr in flat.items():
        if key.rpartition(".")[2] != "weight" or arr.dtype != np.int8:
            continue
        owner, leaf = _owner(model, key)
        prefix = key[:-len(leaf)]
        owner.load_int8(torch.tensor(_to_port_layout(owner, leaf, arr)),
                        torch.tensor(flat[prefix + "w_scale"]))
        for name in _ADDED_BY_QUANTIZATION:
            if prefix + name in flat and getattr(owner, name, None) is None:
                set_quant_attr(owner, name, torch.tensor(flat[prefix + name]))


@torch.no_grad()
def load_jax_params(model: torch.nn.Module, flat: dict, strict: bool = True,
                    marks: dict | None = None):
    """Write the JAX package's flat params and state (numpy arrays keyed by
    ``split()`` path) into ``model``.  ``marks`` maps a JAX module path to
    plain attributes to set on the port's module (``{"layer1/layers/0/
    conv1": {"relu_fused": True}}``).  With ``strict``, a key the model
    does not have, or a model tensor the dict does not cover, raises
    ``KeyError``; a shape that does not match raises ``ValueError``."""
    flat = {path.replace("/", "."): np.asarray(arr)
            for path, arr in flat.items()}
    _take_quantized(model, flat)
    targets = dict(model.named_parameters())
    persistent = model.state_dict().keys()  # not derived tables (Swin's)
    targets.update((k, b) for k, b in model.named_buffers()
                   if k in persistent)
    unmatched, seen = [], set()
    for key, arr in flat.items():
        if key not in targets:
            unmatched.append(key)
            continue
        owner, leaf = _owner(model, key)
        dst = targets[key]
        if dst.dtype == torch.int8:  # packed by load_int8 above
            seen.add(key)
            continue
        src = _to_port_layout(owner, leaf, arr)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{key}: shape {src.shape} does not fit "
                             f"{tuple(dst.shape)}")
        dst.copy_(torch.tensor(src, dtype=dst.dtype))
        seen.add(key)
    for path, attrs in (marks or {}).items():
        mod = model.get_submodule(path.replace("/", "."))
        for name, value in attrs.items():
            setattr(mod, name, value)
    if strict:
        if unmatched:
            raise KeyError(f"load_jax_params: {len(unmatched)} unmatched "
                           f"keys, e.g. {sorted(unmatched)[:5]}")
        uncovered = [k for k in targets if k not in seen]
        if uncovered and flat:
            raise KeyError(f"load_jax_params: {len(uncovered)} model tensors "
                           f"not in the dict, e.g. {uncovered[:5]}")
    return model
