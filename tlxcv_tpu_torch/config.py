"""Model registry (counterpart of ``tlxcv_tpu/config.py:13-35``): a flat
table of model factories keyed by name."""
from __future__ import annotations

import functools
import typing as tp

from .device import resolve_device

_MODEL_REGISTRY: dict[str, tp.Callable] = {}


def register_model(name=None):
    def deco(fn):
        _MODEL_REGISTRY[name or fn.__name__] = fn
        return fn
    return deco


def list_models(filter: str = ""):
    _populate()
    return sorted(k for k in _MODEL_REGISTRY if filter in k)


def create_model(name, device=None, **kwargs):
    """Build a registered model on ``device`` (``None``: the CUDA card;
    raises ``RuntimeError`` when there is none)."""
    _populate()
    try:
        factory = _MODEL_REGISTRY[name]
    except KeyError:
        close = [k for k in _MODEL_REGISTRY if name.lower() in k.lower()]
        raise KeyError(f"unknown model {name!r}; similar: {close[:8]}") from None
    return factory(device=resolve_device(device), **kwargs)


_POPULATED = False


def _populate():
    """Fill the registry from the ported model modules, once."""
    global _POPULATED
    if _POPULATED:
        return
    _POPULATED = True
    from .models import classification as C
    from .models import detection as D
    from .models import facial_landmark_detection as F
    from .models import human_pose_estimation as P
    from .models import segmentation as S

    for mod in (C, S):
        for name in mod.MODELS:
            _MODEL_REGISTRY.setdefault(name, getattr(mod, name))
    _MODEL_REGISTRY.setdefault("mask_rcnn", D.MaskRCNN)
    _MODEL_REGISTRY.setdefault("yolov3", D.YOLOv3)
    _MODEL_REGISTRY.setdefault("ssd", D.SSD)
    _MODEL_REGISTRY.setdefault("detr", D.detr_resnet50)
    _MODEL_REGISTRY.setdefault("pose_hrnet_w32", P.pose_hrnet_w32)
    _MODEL_REGISTRY.setdefault("pfld", F.PFLD)
    for arch in ("ppyoloe_s", "ppyoloe_m", "ppyoloe_l", "ppyoloe_x"):
        _MODEL_REGISTRY.setdefault(
            arch, functools.partial(D.ppyoloe, arch))
