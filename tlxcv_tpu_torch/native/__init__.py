"""Native (C++) host ops, bound with ctypes (counterpart of
``tlxcv_tpu/native``, whose sources ``image_ops.cpp`` and ``jpeg_ops.cpp``
this package keeps its own copies of).

Each library is built with g++ at first use into ``native/_build/`` (not
committed), and rebuilt when its source is newer: ``image_ops`` (the fused
bilinear resize + normalize of a uint8 NHWC batch, threaded over the
batch) and ``jpeg_ops`` (libjpeg decode, alone or fused with the resize and
normalize).  Every entry point keeps the reference's pure-Python fallback,
taken when its library did not build (no compiler, no ``jpeglib.h``);
``available()`` and ``jpeg_available()`` say which route runs.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "image_ops.cpp")
_LIB_PATH = os.path.join(_HERE, "_build", "libimage_ops.so")
_lock = threading.Lock()
_lib = None
_build_failed = False


def _build():
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
           _SRC, "-o", _LIB_PATH]
    subprocess.run(cmd, check=True, capture_output=True)


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            if (not os.path.exists(_LIB_PATH) or
                    os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC)):
                _build()
            lib = ctypes.CDLL(_LIB_PATH)
            lib.resize_normalize_batch.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float), ctypes.c_int]
            lib.resize_normalize_batch.restype = None
            _lib = lib
        except Exception:
            _build_failed = True
            _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def resize_normalize_batch(images: np.ndarray, size, mean, std,
                           threads: int = 0) -> np.ndarray:
    """Fused uint8 NHWC batch -> resized normalized float32 NHWC.

    images: [B, H, W, C] uint8 (contiguous). size: (dh, dw).
    Falls back to a numpy implementation when the native lib is absent.
    """
    images = np.ascontiguousarray(images, np.uint8)
    if images.ndim == 3:
        images = images[None]
    b, sh, sw, c = images.shape
    dh, dw = size
    mean = np.ascontiguousarray(np.broadcast_to(np.asarray(mean, np.float32),
                                                (c,)))
    std = np.ascontiguousarray(np.broadcast_to(np.asarray(std, np.float32),
                                               (c,)))
    lib = _load()
    if lib is None:
        return _fallback(images, (dh, dw), mean, std)
    out = np.empty((b, dh, dw, c), np.float32)
    lib.resize_normalize_batch(
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        b, sh, sw, c,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        dh, dw,
        mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        threads)
    return out


def _fallback(images, size, mean, std):
    try:
        import cv2

        out = np.stack([cv2.resize(im, size[::-1],
                                   interpolation=cv2.INTER_LINEAR)
                        for im in images]).astype(np.float32)
    except Exception:
        dh, dw = size
        b, sh, sw, c = images.shape
        ys = np.clip(((np.arange(dh) + 0.5) * sh / dh - 0.5).round(), 0,
                     sh - 1).astype(int)
        xs = np.clip(((np.arange(dw) + 0.5) * sw / dw - 0.5).round(), 0,
                     sw - 1).astype(int)
        out = images[:, ys][:, :, xs].astype(np.float32)
    return (out - mean) / std


# ---------------------------------------------------------------------------
# JPEG decode (links system libjpeg; separate .so so image_ops stays
# dependency-free)
# ---------------------------------------------------------------------------
_JPEG_SRC = os.path.join(_HERE, "jpeg_ops.cpp")
_JPEG_LIB_PATH = os.path.join(_HERE, "_build", "libjpeg_ops.so")
_jpeg_lib = None
_jpeg_failed = False


def _load_jpeg():
    global _jpeg_lib, _jpeg_failed
    with _lock:
        if _jpeg_lib is not None or _jpeg_failed:
            return _jpeg_lib
        try:
            if (not os.path.exists(_JPEG_LIB_PATH) or
                    os.path.getmtime(_JPEG_LIB_PATH)
                    < os.path.getmtime(_JPEG_SRC)):
                os.makedirs(os.path.dirname(_JPEG_LIB_PATH), exist_ok=True)
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                     "-pthread", _JPEG_SRC, "-ljpeg", "-o", _JPEG_LIB_PATH],
                    check=True, capture_output=True)
            lib = ctypes.CDLL(_JPEG_LIB_PATH)
            lib.decode_resize_normalize_batch.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float), ctypes.c_int]
            lib.decode_resize_normalize_batch.restype = ctypes.c_int
            lib.decode_jpeg.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
            lib.decode_jpeg.restype = ctypes.c_int
            _jpeg_lib = lib
        except Exception:
            _jpeg_failed = True
            _jpeg_lib = None
    return _jpeg_lib


def jpeg_available() -> bool:
    return _load_jpeg() is not None


def _jpeg_dims(data: bytes):
    """(height, width) from the SOFn header, or None if unparseable.

    Lets decode_jpeg allocate exactly H*W*3 instead of a fixed 192 MB
    worst-case buffer per call.
    """
    i, n = 2, len(data)
    while i + 9 < n:
        if data[i] != 0xFF:
            i += 1
            continue
        marker = data[i + 1]
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            i += 2
            continue
        seg_len = (data[i + 2] << 8) | data[i + 3]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            h = (data[i + 5] << 8) | data[i + 6]
            w = (data[i + 7] << 8) | data[i + 8]
            return h, w
        i += 2 + seg_len
    return None


def decode_jpeg(data: bytes, max_hw=(8192, 8192)) -> np.ndarray:
    """Decode one JPEG -> [H, W, 3] uint8 RGB (native libjpeg; PIL
    fallback)."""
    lib = _load_jpeg()
    if lib is None:
        from PIL import Image
        import io

        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    buf = np.frombuffer(data, np.uint8)
    dims = _jpeg_dims(data)
    cap = (dims[0] * dims[1] * 3 if dims is not None
           else max_hw[0] * max_hw[1] * 3)
    out = np.empty(cap, np.uint8)
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.decode_jpeg(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
        ctypes.byref(h), ctypes.byref(w))
    if rc == 2 and dims is not None:
        # header parse under-estimated (shouldn't happen) — worst-case retry
        cap = max_hw[0] * max_hw[1] * 3
        out = np.empty(cap, np.uint8)
        rc = lib.decode_jpeg(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
            ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise ValueError(f"JPEG decode failed (rc={rc})")
    return out[: h.value * w.value * 3].reshape(h.value, w.value, 3).copy()


def decode_resize_normalize(jpegs, size, mean, std,
                            threads: int = 0) -> np.ndarray:
    """Fused native pipeline: list of JPEG byte strings -> decoded,
    bilinear-resized, normalized float32 [N, dh, dw, 3] in ONE
    multi-threaded C++ pass (decode and resize never surface to Python).

    Falls back to per-image decode + resize_normalize_batch when the
    native jpeg lib is unavailable.
    """
    dh, dw = size
    mean = np.ascontiguousarray(np.broadcast_to(
        np.asarray(mean, np.float32), (3,)))
    std = np.ascontiguousarray(np.broadcast_to(
        np.asarray(std, np.float32), (3,)))
    lib = _load_jpeg()
    if lib is None:
        imgs = [decode_jpeg(j) for j in jpegs]
        return np.stack([
            resize_normalize_batch(im, size, mean, std)[0] for im in imgs])
    data = np.frombuffer(b"".join(jpegs), np.uint8)
    offsets = np.zeros(len(jpegs) + 1, np.int64)
    np.cumsum([len(j) for j in jpegs], out=offsets[1:])
    out = np.empty((len(jpegs), dh, dw, 3), np.float32)
    rc = lib.decode_resize_normalize_batch(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(jpegs),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), dh, dw,
        mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), threads)
    if rc != 0:
        raise ValueError(f"JPEG decode failed at image {rc - 1}")
    return out
