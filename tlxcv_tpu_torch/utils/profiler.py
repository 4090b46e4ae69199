"""Tracing and timing (counterpart of ``tlxcv_tpu/utils/profiler.py``):
``torch.profiler`` traces in place of ``jax.profiler``'s, the card's
properties in place of the JAX device list, and a wall-clock benchmark that
waits for the card where the reference blocks on a host fetch."""
from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "device_info", "benchmark_fn", "Timer"]


@contextlib.contextmanager
def trace(logdir: str = "torch-trace"):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where a card
    is present) and write a Chrome trace, viewable in Perfetto, to
    ``logdir/trace.json``.  Yields the profiler: ``key_averages()`` gives
    the per-op table."""
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_info():
    """The card's name, memory, multiprocessor count and compute capability
    (``torch.cuda.get_device_properties``), or the CPU's platform when
    there is no card."""
    if not torch.cuda.is_available():
        return {"platform": "cpu", "device_kind": "cpu", "num_devices": 0,
                "backend": "cpu"}
    p = torch.cuda.get_device_properties(0)
    return {"platform": "gpu", "device_kind": p.name,
            "num_devices": torch.cuda.device_count(),
            "backend": f"cuda {torch.version.cuda}",
            "total_memory": p.total_memory,
            "multi_processor_count": p.multi_processor_count,
            "capability": f"{p.major}.{p.minor}"}


class Timer:
    def __init__(self):
        self.t0 = time.perf_counter()

    def elapsed(self):
        return time.perf_counter() - self.t0


def _sync(out):
    """Wait until ``out`` is ready: the card's queue drained where a tensor
    of the output lies on it."""
    stack = [out]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
            return
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)


def benchmark_fn(fn, *args, iters=20, warmup=2, **kwargs):
    """Seconds a call of ``fn(*args, **kwargs)``: ``warmup`` calls, then
    ``iters`` calls timed on the wall clock from the first launch until the
    last output is ready (the card's queue drained after the last)."""
    for _ in range(warmup):
        _sync(fn(*args, **kwargs))
    t0 = time.perf_counter()
    for _ in range(iters - 1):
        fn(*args, **kwargs)
    _sync(fn(*args, **kwargs))
    return (time.perf_counter() - t0) / iters
