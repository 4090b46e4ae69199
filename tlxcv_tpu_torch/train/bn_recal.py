"""Exact BatchNorm running-statistics re-estimation (counterpart of
``tlxcv_tpu/train/bn_recal.py``; the SWA ``update_bn`` idiom).

BatchNorm's running statistics are an EMA that lags the activations while
the weights move; with the weights frozen the batch statistics are
stationary, so their exact average over N batches removes the lag.  Every
BatchNorm's momentum is set to 0 for the passes, which under the port's
convention (the kept fraction, the JAX package's) makes each forward's
running statistics that batch's own; those are averaged in f32 and written
back into the buffers.  A BatchNorm the forward does not run keeps its
statistics; frozen BatchNorms (DETR's) are buffers no forward writes.
"""
from __future__ import annotations

import typing as tp

import torch

from ..nn.layers import BatchNorm

__all__ = ["recalibrate_batch_stats"]


@torch.no_grad()
def recalibrate_batch_stats(model: torch.nn.Module, batches: tp.Iterable,
                            forward: tp.Union[str, tp.Callable] = "forward"):
    """Replace every BatchNorm's running statistics by their exact average
    over ``batches``, computed in train mode with the weights unchanged.

    ``batches`` yields forward-argument tuples (or one tensor a batch);
    ``forward`` is the method (by name) or callable to drive.  The model's
    buffers are updated in place; returns ``{path: tensor}`` of the
    statistics written.  The model's mode and the BatchNorms' momenta are
    restored."""
    fwd = getattr(model, forward) if isinstance(forward, str) else forward
    bns = {path: m for path, m in model.named_modules()
           if isinstance(m, BatchNorm)}
    saved = {path: m.momentum for path, m in bns.items()}
    was_training = model.training
    bufs = {f"{path}.{name}": getattr(m, name) for path, m in bns.items()
            for name in ("running_mean", "running_var")}
    start = {k: b.clone() for k, b in bufs.items()}
    acc, n = None, 0
    try:
        for m in bns.values():
            m.momentum = 0.0
        model.train()
        for args in batches:
            for k, b in bufs.items():  # each pass starts from the same state
                b.copy_(start[k])
            fwd(*(args if isinstance(args, tuple) else (args,)))
            stats = {k: b.to(torch.float32, copy=True)
                     for k, b in bufs.items()}
            acc = stats if acc is None else {k: acc[k] + stats[k]
                                             for k in acc}
            n += 1
    except BaseException:
        for k, b in bufs.items():
            b.copy_(start[k])
        raise
    finally:
        for path, m in bns.items():
            m.momentum = saved[path]
        model.train(was_training)
    for k, b in bufs.items():
        b.copy_(start[k] if acc is None else acc[k] / n)
    return bufs if n else {}
