"""Copy weights from the JAX package into a port model.

The JAX package flattens a model with ``split()`` into ``{path: array}``:
attribute names joined by "/", a list index as one segment
(``blocks/3/attn/qkv/weight``).  The port mirrors the attribute names, so
the torch key is the same path joined by "." and no name table is needed.
Layouts differ only for weights: conv HWIO -> OIHW, dense (in, out) ->
(out, in).  Everything else (``pos_embed``, ``cls_token``, LayerNorm,
biases, running statistics) copies as it is.
"""
from __future__ import annotations

import numpy as np
import torch

from ..nn.layers import Conv2d, Linear

__all__ = ["load_jax_params"]


def _to_port_layout(owner, leaf, arr):
    if leaf == "weight" and isinstance(owner, Conv2d):
        return arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if leaf == "weight" and isinstance(owner, Linear):
        return arr.T                      # (in, out) -> (out, in)
    return arr


@torch.no_grad()
def load_jax_params(model: torch.nn.Module, flat: dict, strict: bool = True):
    """Write the JAX package's flat params and state (numpy arrays keyed by
    ``split()`` path) into ``model``.  With ``strict``, a key the model does
    not have, or a model tensor the dict does not cover, raises
    ``KeyError``; a shape that does not match raises ``ValueError``."""
    targets = dict(model.named_parameters())
    targets.update(model.named_buffers())
    unmatched, seen = [], set()
    for path, arr in flat.items():
        key = path.replace("/", ".")
        if key not in targets:
            unmatched.append(path)
            continue
        owner_name, _, leaf = key.rpartition(".")
        owner = model.get_submodule(owner_name)
        src = _to_port_layout(owner, leaf, np.asarray(arr))
        dst = targets[key]
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{path}: shape {src.shape} does not fit "
                             f"{tuple(dst.shape)}")
        dst.copy_(torch.tensor(src, dtype=dst.dtype))
        seen.add(key)
    if strict:
        if unmatched:
            raise KeyError(f"load_jax_params: {len(unmatched)} unmatched "
                           f"keys, e.g. {sorted(unmatched)[:5]}")
        uncovered = [k for k in targets if k not in seen]
        if uncovered and flat:
            raise KeyError(f"load_jax_params: {len(uncovered)} model tensors "
                           f"not in the dict, e.g. {uncovered[:5]}")
    return model
