"""Hermetic detection accuracy check: FCOS on a ResNet-18 trunk, trained
from random weights on the procedural ``ShapesDetection`` fixture for
2,000 steps at b32 128^2 (Adam, cosine decay from 1e-3), must reach COCO
mAP 0.75 on 128 held-out images.  Port of
``demo/object_detection/accuracy_check.py``; the loop is
``accuracy_sweep.run_model("fcos")``.

    python -m tlxcv_tpu_torch.demo.object_detection.accuracy_check

writes the row into ``sweep_results.json`` beside this file.
"""
from __future__ import annotations

from .accuracy_sweep import main as sweep_main

__all__ = ["main"]


def main(device=None, steps=None, batch=None, val_num=128, out_dir=None):
    """The FCOS row of the sweep (in a list); ``BelowFloor`` under the
    floor."""
    rows = sweep_main(["fcos"], steps=steps, device=device, out_dir=out_dir,
                      batch=batch, val_num=val_num)
    print(f"PASS mAP={rows[0]['map']:.4f} (floor {rows[0]['floor']})")
    return rows


if __name__ == "__main__":
    main()
