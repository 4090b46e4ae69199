"""tlxcv_tpu_torch: the PyTorch/CUDA port of tlxcv_tpu for NVIDIA Hopper.

It stands alone: it imports torch, numpy and the standard library, never
JAX or the ``tlxcv_tpu`` package it is held against.  Entry points run on
the CUDA card unless the caller passes ``device="cpu"``.
"""
from .config import (Config, build_seg_model, create_model, list_models,
                     load_seg_config, register_model)
from .device import resolve_device

__all__ = ["Config", "build_seg_model", "create_model", "list_models",
           "load_seg_config", "register_model", "resolve_device"]
