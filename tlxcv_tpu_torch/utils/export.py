"""Serving export: a model as a self-contained ``torch.export`` artifact
(counterpart of ``tlxcv_tpu/utils/export.py``, whose artifact is StableHLO).

    art = export_model(model, (224, 224, 3))        # symbolic batch
    save_exported("resnet50.pt2", art)
    serve = load_exported("resnet50.pt2")           # -> callable
    logits = serve(images)                          # any batch size

The artifact is the eval-mode graph of ``model.method`` with the weights
inside it, traced on the model's device: no model code is needed to serve
it.  The port's kernels appear in it as the ``tlxcv`` operators
(``ops.cuda.library``): exported on the card it replays them, exported on
the CPU it runs their plain versions; ``load_exported`` imports
``tlxcv_tpu_torch.ops.cuda`` so that they are registered.  Quantized models
export the same way (their int8 weights and scales are in the artifact).

Where ``torch.export`` has no counterpart of the reference, the port raises
``NotImplementedError``: an artifact for several platforms at once (the
reference's ``platforms=("tpu", "cpu")``; here an artifact runs where it was
traced), and ``sharding`` (ROADMAP queue 1, item 15).
"""
from __future__ import annotations

import os
import typing as tp

import torch

__all__ = ["export_model", "save_exported", "load_exported"]

_PLATFORMS = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}


class _Method(torch.nn.Module):
    """``model.<method>`` as the forward ``torch.export`` traces: the input
    ``x`` by name, for its symbolic batch, then the static ``extra``."""

    def __init__(self, model, method):
        super().__init__()
        self.model = model
        self.method = "forward" if method == "__call__" else method

    def forward(self, x, *extra):
        return getattr(self.model, self.method)(x, *extra)


def _device_of(model):
    for t in (*model.parameters(), *model.buffers()):
        return t.device
    return torch.device("cpu")


def _example(spec, device):
    """An example input from a tensor or a ``(shape, dtype)`` pair."""
    if isinstance(spec, torch.Tensor):
        return spec.to(device)
    shape, dtype = spec
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def export_model(model, input_shape: tp.Sequence[int], *,
                 batch: tp.Union[str, int, None] = "b",
                 dtype=torch.float32, method: str = "__call__",
                 platforms: tp.Optional[tp.Sequence[str]] = None,
                 extra_specs: tp.Sequence = (), sharding=None):
    """Export ``model.method`` in eval mode with its weights inside.

    ``input_shape`` is the per-example shape (H, W, C); ``batch`` is the
    name of a symbolic batch dimension (default ``"b"``: the artifact takes
    any batch size; it is traced at batch 2, since torch specialises a
    dimension of size 1) or a concrete int for a fixed-batch artifact.
    ``platforms``, if given, names the one platform of the model's device
    (``"cpu"``, or ``"cuda"``/``"gpu"``).  ``extra_specs`` are further
    static inputs: tensors or ``(shape, dtype)`` pairs.  Returns a
    ``torch.export.ExportedProgram``."""
    if sharding is not None:
        raise NotImplementedError(
            "export_model: sharded serving artifacts are not ported yet "
            "(ROADMAP queue 1, item 15)")
    device = _device_of(model)
    if platforms is not None:
        platforms = tuple(platforms)
        if len(platforms) != 1:
            raise NotImplementedError(
                f"export_model: a torch.export artifact runs where it was "
                f"traced; it cannot hold the {len(platforms)} platforms "
                f"{platforms} at once")
        if _PLATFORMS.get(platforms[0]) != device.type:
            raise ValueError(f"export_model: platforms={platforms} but the "
                             f"model lies on {device}; move it there first")
    symbolic = isinstance(batch, str)
    b = 2 if symbolic else (int(batch) if batch is not None else 1)
    x = torch.zeros((b, *input_shape), dtype=dtype, device=device)
    extras = tuple(_example(s, device) for s in extra_specs)
    dynamic = None
    if symbolic:
        dynamic = ({0: torch.export.Dim(batch)},) + (None,) * len(extras)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            return torch.export.export(_Method(model, method), (x, *extras),
                                       dynamic_shapes=dynamic, strict=False)
    finally:
        model.train(was_training)


def save_exported(path: str, exported) -> int:
    """Write an ``ExportedProgram`` to ``path``; returns the byte size."""
    torch.export.save(exported, path)
    return os.path.getsize(path)


def load_exported(path: str):
    """Load an artifact written by ``save_exported``; returns ``fn(x, ...)
    -> out``, the graph run without autograd (no model code needed: the
    port's operators are registered by importing ``ops.cuda``)."""
    from ..ops import cuda  # noqa: F401  (registers the tlxcv operators)

    module = torch.export.load(path).module()

    def serve(*args):
        with torch.no_grad():
            return module(*args)

    serve.module = module
    return serve
