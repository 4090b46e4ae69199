"""Checkpoint IO (counterpart of ``tlxcv_tpu/utils/checkpoint.py``).

Two tiers, as in the reference:

- :func:`save_weights` / :func:`load_weights`: a flat npz of the module's
  ``state_dict`` (parameters and persistent buffers, "."-joined keys,
  torch layouts).  npz holds no bfloat16 (nor the float8 types), so such
  a tensor is upcast to f32, which is exact, and its dtype name recorded
  under the reference's ``__ml_dtypes__`` manifest entry.  The manifest is
  read by dtype name through ``torch``, so neither package needs
  ``ml_dtypes``.  :func:`load_weights` also reads an npz that the JAX
  package's ``save_weights`` wrote ("/"-joined keys, HWIO convs, (in, out)
  dense weights): it goes through ``utils.bridge.load_jax_params``, so
  that weights trained in JAX are served by the port.  The port writes no
  marker of its own into the file.
- :class:`TrainCheckpoint`: the full training state, parameters, buffers
  (BatchNorm statistics), the optimizer's state, the step and ``extra``
  trees (the Trainer's EMA and loop state), as npz plus a manifest.  The
  optimizer state is torch's (``train.optimizers``), not optax's, so a
  full train state is the port's own format: only weights cross between
  the packages.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from .bridge import load_jax_params

__all__ = ["save_weights", "load_weights", "TrainCheckpoint"]

_DTYPE_KEY = "__ml_dtypes__"
_MANIFEST_KEY = "__manifest__"
_FORMAT = "tlxcv_tpu_torch.TrainCheckpoint/1"


def _to_numpy(v):
    """A tensor or array as numpy, and the dtype name to record when npz
    cannot hold its dtype (None when it can)."""
    if not isinstance(v, torch.Tensor):
        return np.asarray(v), None
    t = v.detach().cpu()
    try:
        return t.numpy(), None
    except TypeError:  # bfloat16 and the float8 types
        return t.float().numpy(), str(t.dtype)[6:]


def _savable(arrays: dict) -> dict:
    out, casts = {}, {}
    for k, v in arrays.items():
        out[k], name = _to_numpy(v)
        if name is not None:
            casts[k] = name
    if casts:
        out[_DTYPE_KEY] = np.frombuffer(json.dumps(casts).encode(),
                                        np.uint8).copy()
    return out


def _json(entry) -> dict:
    return json.loads(bytes(entry.tobytes()).decode())


def _read(path):
    """The npz's arrays as tensors, each in the dtype it was saved from,
    and its manifest (None when it has none)."""
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    casts = _json(arrays.pop(_DTYPE_KEY)) if _DTYPE_KEY in arrays else {}
    manifest = (_json(arrays.pop(_MANIFEST_KEY))
                if _MANIFEST_KEY in arrays else None)
    out = {}
    for k, a in arrays.items():
        t = torch.from_numpy(np.array(a))  # a copy; keeps 0-d arrays 0-d
        out[k] = t.to(getattr(torch, casts[k])) if k in casts else t
    return out, manifest


def _write(path, arrays: dict, manifest=None):
    """npz at exactly ``path`` (``np.savez`` given a name would append
    ".npz")."""
    arrays = _savable(arrays)
    if manifest is not None:
        arrays[_MANIFEST_KEY] = np.frombuffer(json.dumps(manifest).encode(),
                                              np.uint8).copy()
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def save_weights(module: torch.nn.Module, path):
    """The module's ``state_dict`` as a flat npz at ``path``."""
    _write(path, module.state_dict())


def load_weights(module: torch.nn.Module, path, strict: bool = True,
                 layout: str | None = None):
    """Load an npz of weights into ``module`` in place, each tensor on the
    module's own device and in its dtype.  ``layout`` "jax" reads the JAX
    package's file through the bridge (layouts converted, ``strict`` as
    there); "torch" reads the port's own through ``load_state_dict``.
    ``None`` tells them apart: keys with a "/" are the JAX package's paths,
    and so is a file whose keys or shapes do not fit the module as they
    are (a JAX module of one level, a Linear, has no "/"; where such a
    file also fits as it is, a square Linear, pass ``layout="jax"``)."""
    arrays, _ = _read(path)
    if layout is None:
        sd = module.state_dict()
        fits = all(k in sd and sd[k].shape == t.shape
                   for k, t in arrays.items())
        layout = "torch" if fits and not any("/" in k for k in arrays) \
            else "jax"
    if layout == "jax":
        flat = {k: (t.float() if t.dtype == torch.bfloat16 else t).numpy()
                for k, t in arrays.items()}
        load_jax_params(module, flat, strict=strict)
    elif layout == "torch":
        module.load_state_dict(arrays, strict=strict)
    else:
        raise ValueError(f"layout {layout!r}: 'jax', 'torch' or None")
    return module


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


class TrainCheckpoint:
    """Save and restore (params, buffers, opt_state, step, extra) as npz
    plus a manifest.  Every tree is a dict of tensors (nested dicts
    allowed), keyed as the caller likes; restore reads into templates of
    the same keys and returns tensors in the dtypes they were saved in,
    on the CPU: the caller puts each on its template's device."""

    @staticmethod
    def save(path, params: dict, buffers: dict, opt_state: dict, step: int,
             extra: dict | None = None):
        tree = {"params": params, "state": buffers, "opt": opt_state}
        if extra:
            tree["extra"] = extra
        arrays = _flatten(tree)
        arrays["step"] = np.asarray(step, np.int64)
        _write(path, arrays, manifest={"format": _FORMAT})

    @staticmethod
    def restore(path, params: dict, buffers: dict, opt_state: dict,
                extra: dict | None = None):
        """Returns (params, buffers, opt_state, step), plus ``extra`` as a
        fifth element when it is given; each tree has the template's keys,
        and a key missing from the file raises ``KeyError``."""
        arrays, manifest = _read(path)
        if (manifest or {}).get("format") != _FORMAT:
            raise ValueError(f"{path}: not a {_FORMAT} checkpoint")

        def take(prefix, tree):
            out = {}
            for k, v in tree.items():
                key = f"{prefix}/{k}"
                if isinstance(v, dict):
                    out[k] = take(key, v)
                elif key in arrays:
                    out[k] = arrays[key]
                else:
                    raise KeyError(f"{path}: no {key!r} in the checkpoint")
            return out

        out = (take("params", params), take("state", buffers),
               take("opt", opt_state), int(arrays["step"]))
        return out if extra is None else (*out, take("extra", extra))
