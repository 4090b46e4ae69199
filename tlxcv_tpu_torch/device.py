"""Where the port runs: on the card unless the caller asks for the CPU."""
from __future__ import annotations

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
