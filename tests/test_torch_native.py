"""The port's native host ops against the JAX package's on the CPU.

Each package builds its own copy of ``image_ops.cpp`` and ``jpeg_ops.cpp``
with g++ into its own ``native/_build/``; the port's libraries must give
the reference's bytes exactly.  The pure-Python fallbacks (taken where a
library did not build) stay within the reference's tolerance of the
libraries: 0.05 in normalised units, cv2's fixed-point resize against the
float one (``tests/test_native.py``).
"""
import io

import numpy as np
import pytest
from PIL import Image

from tlxcv_tpu import native as JN
from tlxcv_tpu_torch import native as TN


def _jpegs(rng, n, hw=(45, 61)):
    out = []
    for _ in range(n):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(
            buf, format="JPEG", quality=85)
        out.append(buf.getvalue())
    return out


def test_port_builds_its_own_libraries():
    assert TN.available() and TN.jpeg_available()
    assert TN._LIB_PATH != JN._LIB_PATH
    assert "tlxcv_tpu_torch" in TN._LIB_PATH
    with open(TN._SRC) as a, open(JN._SRC) as b:
        assert a.read().split("\n", 2)[2] == b.read().split("\n", 1)[1]
    with open(TN._JPEG_SRC) as a, open(JN._JPEG_SRC) as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("shape,size,threads", [
    ((4, 97, 133, 3), (64, 80), 0), ((2, 30, 20, 1), (61, 47), 1),
    ((3, 16, 16, 4), (16, 16), 2)])
def test_resize_normalize_is_bitwise_the_reference_library(rng, shape, size,
                                                           threads):
    imgs = rng.integers(0, 256, shape, dtype=np.uint8)
    c = shape[-1]
    mean, std = rng.uniform(50, 150, c), rng.uniform(30, 70, c)
    got = TN.resize_normalize_batch(imgs, size, mean, std, threads)
    want = JN.resize_normalize_batch(imgs, size, mean, std, threads)
    assert got.dtype == np.float32 and got.shape == (shape[0], *size, c)
    np.testing.assert_array_equal(got, want)


def test_jpeg_routes_are_bitwise_the_reference_library(rng):
    blobs = _jpegs(rng, 5)
    for b in blobs:
        np.testing.assert_array_equal(TN.decode_jpeg(b), JN.decode_jpeg(b))
    mean, std = (120.0, 110.0, 100.0), (60.0, 50.0, 40.0)
    got = TN.decode_resize_normalize(blobs, (32, 40), mean, std, threads=2)
    want = JN.decode_resize_normalize(blobs, (32, 40), mean, std, threads=2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, TN.resize_normalize_batch(
            np.stack([TN.decode_jpeg(b) for b in blobs]), (32, 40), mean,
            std))
    with pytest.raises(ValueError):
        TN.decode_jpeg(b"\xff\xd8 not a jpeg")


def test_fallbacks_within_the_reference_tolerance(rng, monkeypatch):
    imgs = rng.integers(0, 256, (3, 50, 70, 3), dtype=np.uint8)
    mean, std = (125.3, 123.0, 113.9), (63.0, 62.1, 66.7)
    lib = TN.resize_normalize_batch(imgs, (33, 41), mean, std)
    blobs = _jpegs(rng, 3)
    lib_jpeg = TN.decode_resize_normalize(blobs, (33, 41), mean, std)
    monkeypatch.setattr(TN, "_load", lambda: None)
    monkeypatch.setattr(TN, "_load_jpeg", lambda: None)
    fallback = TN.resize_normalize_batch(imgs, (33, 41), mean, std)
    np.testing.assert_allclose(fallback, lib, atol=0.05, rtol=0)
    # without libjpeg the decode is PIL's: the same libjpeg underneath
    np.testing.assert_allclose(
        TN.decode_resize_normalize(blobs, (33, 41), mean, std), lib_jpeg,
        atol=0.05, rtol=0)
    np.testing.assert_array_equal(TN.decode_jpeg(blobs[0]),
                                  JN.decode_jpeg(blobs[0]))
