"""Model registry and experiment configs (counterpart of
``tlxcv_tpu/config.py``): a flat table of model factories keyed by name;
``Config``, a flat experiment config that builds the model, the optimizer,
the task and the Trainer from a plain dict, a YAML or a JSON file
(``config.py:103-165``); and the segmentation configs (``load_seg_config``,
``build_seg_model``: ``config.py:161-201``), PaddleSeg-style YAMLs such as
``configs/segmentation/*/*.yml``.  GAN recipes (``build_gan_trainer``)
come with the GAN trainers (ROADMAP queue 1, item 13)."""
from __future__ import annotations

import dataclasses
import functools
import json
import os
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
    from .models import face_recognition as FR
    from .models import facial_landmark_detection as F
    from .models import human_pose_estimation as P
    from .models import ocr as O
    from .models import rs as RS
    from .models import segmentation as S
    from .models import video_classification as V

    for mod in (C, S):
        for name in mod.MODELS:
            _MODEL_REGISTRY.setdefault(name, getattr(mod, name))
    # the JAX package's aliases
    for alias, factory in (("pp_hgnet", C.pp_hgnet_small),
                           ("darknet53", C.darknet53_cls),
                           ("rexnet", C.rexnet_1_0)):
        _MODEL_REGISTRY.setdefault(alias, factory)
    _MODEL_REGISTRY.setdefault("retinaface", FR.RetinaFace)
    _MODEL_REGISTRY.setdefault("arcface", FR.ArcFace)
    _MODEL_REGISTRY.setdefault("trocr", O.TrOCR)
    _MODEL_REGISTRY.setdefault("i3d", V.InceptionI3d)
    _MODEL_REGISTRY.setdefault("mask_rcnn", D.MaskRCNN)
    _MODEL_REGISTRY.setdefault("yolov3", D.YOLOv3)
    _MODEL_REGISTRY.setdefault("ssd", D.SSD)
    _MODEL_REGISTRY.setdefault("detr", D.detr_resnet50)
    _MODEL_REGISTRY.setdefault("pose_hrnet_w32", P.pose_hrnet_w32)
    _MODEL_REGISTRY.setdefault("pfld", F.PFLD)
    _MODEL_REGISTRY.setdefault("fcos_r50", D.fcos_r50)
    _MODEL_REGISTRY.setdefault("fcos_dcn_r50", D.fcos_dcn_r50)
    _MODEL_REGISTRY.setdefault("bit", RS.BIT)
    _MODEL_REGISTRY.setdefault("snunet", RS.SNUNet)
    _MODEL_REGISTRY.setdefault("fc_ef", RS.FCEarlyFusion)
    _MODEL_REGISTRY.setdefault("farseg", RS.FarSeg)
    for name, factory in (("retinanet", D.retinanet_r50),
                          ("faster_rcnn", D.faster_rcnn),
                          ("cascade_rcnn", D.cascade_rcnn_r50),
                          ("gfl_r50", D.gfl_r50), ("tood_r50", D.tood_r50),
                          ("centernet", D.centernet_r50),
                          ("ttfnet", D.ttfnet_darknet53),
                          ("picodet_lcnet", D.picodet_lcnet),
                          ("solov2_r50", D.solov2_r50)):
        _MODEL_REGISTRY.setdefault(name, factory)
    for arch in ("ppyoloe_s", "ppyoloe_m", "ppyoloe_l", "ppyoloe_x"):
        _MODEL_REGISTRY.setdefault(
            arch, functools.partial(D.ppyoloe, arch))
    for arch in D.YOLOX_SIZES:
        _MODEL_REGISTRY.setdefault(arch, functools.partial(D.yolox, arch))


@dataclasses.dataclass
class Config:
    """Flat experiment config: model + optimizer + training params.  The
    ``build_*`` methods build on ``device`` (``None``: the CUDA card)."""

    model: str = "resnet50"
    model_kwargs: dict = dataclasses.field(default_factory=dict)
    task: str = "classification"
    optimizer: str = "Adam"
    lr: float = 1e-3
    optimizer_kwargs: dict = dataclasses.field(default_factory=dict)
    batch_size: int = 32
    n_epoch: int = 10
    seed: int = 0
    ema_decay: tp.Optional[float] = None  # the Trainer's weight EMA

    @classmethod
    def from_file(cls, path):
        """A YAML (``.yaml``/``.yml``, needs PyYAML) or JSON file."""
        with open(path) as f:
            if path.endswith((".yaml", ".yml")):
                try:
                    import yaml
                except ImportError as err:
                    raise ImportError(
                        "Config.from_file reads YAML with PyYAML (the yaml "
                        "module), which is not installed; pass a JSON "
                        "file or build Config(**dict)") from err
                d = yaml.safe_load(f)
            else:
                d = json.load(f)
        return cls(**d)

    def build_model(self, device=None):
        return create_model(self.model, device=device, **self.model_kwargs)

    def build_optimizer(self):
        """The ``train.optimizers`` factory named ``optimizer`` at ``lr``."""
        from .train import optimizers as opt

        return getattr(opt, self.optimizer)(self.lr, **self.optimizer_kwargs)

    def build_task(self, device=None):
        from . import tasks

        if self.task == "gan":
            raise NotImplementedError("Config: task 'gan' is not ported yet "
                                      "(ROADMAP queue 1, item 12)")
        names = {
            "classification": tasks.ImageClassification,
            "segmentation": tasks.ImageSegmentation,
            "detection": tasks.ObjectDetection,
            "pose": tasks.HumanPoseEstimation,
            "landmark": tasks.FacialLandmarkDetection,
            "ocr": tasks.OpticalCharacterRecognition,
            "video": tasks.VideoClassification,
        }
        return names[self.task](self.build_model(device))

    def build_trainer(self, network=None, device=None, **kw):
        """Task + optimizer + Trainer in one step (the EMA wired
        through); ``kw`` goes to the Trainer (``metrics=``, ...)."""
        from .train import Trainer

        net = network if network is not None else self.build_task(device)
        kw.setdefault("ema_decay", self.ema_decay)
        return Trainer(network=net, optimizer=self.build_optimizer(),
                       seed=self.seed, device=device, **kw)


def load_seg_config(path):
    """Load a PaddleSeg-style segmentation YAML with ``_base_`` inheritance
    (the base's path is relative to the file): the child's top-level keys
    replace the base's.  Needs PyYAML."""
    try:
        import yaml
    except ImportError as err:
        raise ImportError("load_seg_config reads YAML and needs PyYAML "
                          "(the yaml module), which is not installed") \
            from err
    with open(path) as f:
        cfg = yaml.safe_load(f)
    base_rel = cfg.pop("_base_", None)
    if base_rel:
        base = load_seg_config(
            os.path.normpath(os.path.join(os.path.dirname(path), base_rel)))
        base.update(cfg)
        cfg = base
    return cfg


def build_seg_model(cfg_or_path, device=None, generator=None):
    """Build the segmentation model a seg config names (a dict or a YAML
    path) on ``device`` (``None``: the card), as the JAX package does: the
    ``model.type`` class of ``models.segmentation`` (else a registered
    name) with the config's ``num_classes`` and nothing else of the model
    section, and a string ``backbone`` built by its ``resnet_vd`` factory
    at its defaults (output stride 8)."""
    cfg = (load_seg_config(cfg_or_path) if isinstance(cfg_or_path, str)
           else dict(cfg_or_path))
    from .models import segmentation as S
    from .models.backbones import resnet_vd

    device = resolve_device(device)
    m = dict(cfg["model"])
    name = m.pop("type")
    kwargs = {"device": device, "generator": generator}
    if "num_classes" in m:
        kwargs["num_classes"] = m["num_classes"]
    if isinstance(m.get("backbone"), str):
        if name == "DeepLabV3P":
            return S.deeplabv3p(backbone=m["backbone"], **kwargs)
        kwargs["backbone"] = getattr(resnet_vd, m["backbone"])(
            device=device, generator=generator)
    factory = getattr(S, name, None)
    if factory is None:
        return create_model(name, **kwargs)
    return factory(**kwargs)
