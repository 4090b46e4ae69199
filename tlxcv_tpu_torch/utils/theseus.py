"""Pattern-based sub-layer access and surgery (counterpart of
``tlxcv_tpu/utils/theseus.py``, PaddleClas' TheseusLayer mechanism for
feature extraction and sub-layer replacement), on ``nn.Module``s.

Paths are the JAX package's: attribute names joined by "/", a list index
as one segment (``layer1/layers/0/conv1``).  The port mirrors the JAX
attribute names, and its lists are ``ModuleList``s, so the same path
reaches the same sub-layer in both packages; a ``ModuleList`` or
``ModuleDict`` is a container there, not a module, and is not listed.
"""
from __future__ import annotations

import fnmatch
import typing as tp

from torch import nn

__all__ = ["named_modules", "get_by_path", "upgrade_sublayer",
           "FeatureRecorder", "record_features"]

_CONTAINERS = (nn.ModuleList, nn.ModuleDict)


def named_modules(module: nn.Module):
    """Iterate (path, module) pairs, '/'-separated paths, the module itself
    first with path ''; a module reached by two paths comes once by each."""
    for name, mod in module.named_modules(remove_duplicate=False):
        if not isinstance(mod, _CONTAINERS):
            yield name.replace(".", "/"), mod


def get_by_path(module: nn.Module, path: str):
    """Fetch a sub-module by '/'-separated path."""
    obj = module
    for part in path.split("/"):
        if not part:
            continue
        obj = obj[int(part)] if isinstance(obj, nn.ModuleList) else \
            obj[part] if isinstance(obj, nn.ModuleDict) else \
            getattr(obj, part)
    return obj


def _set_by_path(module, path, value):
    parts = [p for p in path.split("/") if p]
    parent = (get_by_path(module, "/".join(parts[:-1])) if len(parts) > 1
              else module)
    last = parts[-1]
    if isinstance(parent, nn.ModuleList):
        parent[int(last)] = value
    elif isinstance(parent, nn.ModuleDict):
        parent[last] = value
    else:
        setattr(parent, last, value)


def _hits(module, pattern):
    return [p for p, _ in named_modules(module)
            if p and fnmatch.fnmatch(p, pattern)]


def upgrade_sublayer(module: nn.Module, pattern: str,
                     replace_fn: tp.Callable[[nn.Module], nn.Module]):
    """Replace every sub-module whose path matches the glob ``pattern``
    with ``replace_fn(old)``; returns the paths replaced."""
    hits = _hits(module, pattern)
    for p in hits:
        _set_by_path(module, p, replace_fn(get_by_path(module, p)))
    return hits


class FeatureRecorder(nn.Module):
    """Transparent wrapper that stores its sub-module's output."""

    def __init__(self, inner: nn.Module, store: dict, key: str):
        super().__init__()
        self.inner = inner
        self._store = store  # a plain dict: not a sub-module, not state
        self._key = key

    def forward(self, *args, **kwargs):
        out = self.inner(*args, **kwargs)
        self._store[self._key] = out
        return out


def record_features(module: nn.Module, patterns: tp.Sequence[str]):
    """Wrap the sub-modules whose paths match any of ``patterns`` so that
    forward passes record their outputs.  Returns the store: after a call,
    ``store[path]`` holds that sub-layer's latest output."""
    store: dict = {}
    for pattern in patterns:
        for p in _hits(module, pattern):
            _set_by_path(module, p,
                         FeatureRecorder(get_by_path(module, p), store, p))
    return store
