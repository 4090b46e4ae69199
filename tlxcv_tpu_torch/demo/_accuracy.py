"""What the hermetic accuracy checks share: the kernels' launch counters
(``ops.cuda``), the card's name, the results files and the floors.

Each check (``demo/<task>/accuracy_check*.py``) trains a model from random
weights on a procedural numpy fixture and scores it on the task's metric.
Its ``main`` takes ``device=None`` (the card; it raises without one) or
``device="cpu"``, and writes its results JSON before it judges the floor,
with the card's name and power limit (``device``), the launches of every
hand-written kernel it reached (``kernel_launches``) and its metrics
beside their floors (``metrics``, rows made by ``metric``).  It returns
that result (a row, or a list of rows for a runner of several models), or
raises ``BelowFloor`` carrying it.
"""
from __future__ import annotations

import fcntl
import json
import os
import subprocess

import numpy as np
import torch

from ..ops.cuda import launch_counts, reset_launches

__all__ = ["BelowFloor", "card", "judge", "launch_counts", "merge_rows",
           "metric", "reset_launches", "results_path", "to_device",
           "write_results"]


class BelowFloor(AssertionError):
    """A check's result with a metric on the wrong side of its floor (or a
    row that raised); ``result`` is what ``main`` would have returned."""

    def __init__(self, result):
        self.result = result
        rows = result if isinstance(result, list) else [result]
        missed = [f"{r.get('model', '')} {m['metric']} {m['value']} "
                  f"(floor {m['floor']})".strip()
                  for r in rows for m in r.get("metrics", ()) if not m["ok"]]
        missed += [f"{r['model']}: {r['error']}" for r in rows if "error" in r]
        super().__init__("below floor: " + "; ".join(missed))


def metric(name, value, floor, higher=True):
    """One of a result's ``metrics``: the value beside its floor, and
    whether it clears it (``higher``: at or above it, else at or below)."""
    return {"metric": name, "value": value, "floor": floor, "higher": higher,
            "ok": bool(value >= floor if higher else value <= floor)}


def judge(result):
    """``result`` (a row or a list of rows) if every row has metrics and
    clears each; else raises ``BelowFloor`` carrying it."""
    rows = result if isinstance(result, list) else [result]
    if not all(r.get("metrics") and all(m["ok"] for m in r["metrics"])
               for r in rows):
        raise BelowFloor(result)
    return result


def card(device):
    """``nvidia-smi``'s name and power limit of the card, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def results_path(script, name, out_dir=None):
    """The results file ``name`` beside ``script`` or in ``out_dir``."""
    folder = out_dir or os.path.dirname(os.path.abspath(script))
    os.makedirs(folder, exist_ok=True)
    return os.path.join(folder, name)


def write_results(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def merge_rows(path, rows, order=None):
    """Merge ``rows`` (dicts keyed by "model") into the list in ``path``
    under an exclusive lock on its folder, so that processes writing one
    results file side by side keep each other's rows; sorted by
    ``order(row)`` when given.  Returns the merged list."""
    folder = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
    try:
        fcntl.flock(folder, fcntl.LOCK_EX)
        merged = {}
        if os.path.exists(path):
            with open(path) as f:
                merged = {r["model"]: r for r in json.load(f)}
        merged.update({r["model"]: r for r in rows})
        out = list(merged.values())
        if order is not None:
            out.sort(key=order)
        write_results(path, out)
    finally:
        os.close(folder)  # releases the lock
    return out


def to_device(tree, device):
    """numpy arrays (or a dict of them) as tensors on ``device``; integer
    arrays become int64 (torch's index type)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    t = torch.from_numpy(np.ascontiguousarray(tree))
    if not t.is_floating_point() and t.dtype != torch.bool:
        t = t.long()
    return t.to(device)
