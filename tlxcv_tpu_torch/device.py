"""Where the port runs: on the card unless the caller asks for the CPU."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; it raises when there is none, so that a
    caller who asked for nothing never runs quietly on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: tlxcv_tpu_torch runs on the GPU unless "
                "the caller passes device='cpu'")
        return torch.device("cuda")
    return torch.device(device)


@contextlib.contextmanager
def full_f32():
    """TF32 off for the card's convolutions and matrix products, restored
    after, whatever the caller set globally."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
