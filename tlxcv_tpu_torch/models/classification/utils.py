"""Shared classifier helpers (counterpart of
``tlxcv_tpu/models/classification/utils.py``)."""
from __future__ import annotations


def make_divisible(v, divisor=8, min_value=None):
    """``v`` rounded to the nearest multiple of ``divisor`` (at least
    ``min_value``), one ``divisor`` more where that loses over 10%."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v
