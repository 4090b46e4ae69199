"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``tlxcv_tpu_torch/csrc/<name>.cu`` has a plain C interface and becomes
``tlxcv_tpu_torch/_build/<name>.so``, compiled for Hopper (``sm_90a``) once
per process, at first use.  Sources named together are compiled in
parallel, one nvcc each.  Nothing is downloaded; a failed build raises with
nvcc's output.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}  # nvcc's output (ptxas register/spill report)
_lock = threading.Lock()


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "tlxcv_tpu_torch are built with the CUDA toolkit")
    return path


def build(*names: str) -> None:
    """Compile the named sources (every one under csrc/ when none is named)
    in parallel and load them."""
    with _lock:
        todo = [n for n in (names or sources()) if n not in _libs]
        if not todo:
            return
        BUILD_DIR.mkdir(exist_ok=True)
        nvcc = _nvcc()
        jobs = []
        for name in todo:
            src = CSRC / f"{name}.cu"
            if not src.is_file():
                raise FileNotFoundError(src)
            tmp = BUILD_DIR / f".{name}.{os.getpid()}.so"
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((name, tmp, proc))
        failed = []
        for name, tmp, proc in jobs:  # wait for every nvcc before raising
            out, _ = proc.communicate()
            build_logs[name] = out
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {name}.cu:\n{out}")
                continue
            so = BUILD_DIR / f"{name}.so"
            os.replace(tmp, so)  # atomic: concurrent processes may build too
            _libs[name] = ctypes.CDLL(str(so))
        if failed:
            raise RuntimeError("\n".join(failed))


def library(name: str) -> ctypes.CDLL:
    if name not in _libs:
        build(name)
    return _libs[name]
