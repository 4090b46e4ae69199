"""The port's segmentation image ops against the JAX package on the CPU:
ENet's argmax pool and unpool, the bicubic resize, the ``fast_path``
keyword and the same-size bilinear resize.

Tolerances: the pool's values and indices and the unpool's output are
bitwise (a window of equal elements goes to its first, row-major, in both).
The bicubic resize within 2e-6 of the largest magnitude: the same f32
weights, two separable products against the reference's one einsum, so f32
sums in another order.  The two bilinear routes within 1e-6 (one rounding
of weights that differ in the last bit), the same-size resize exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlxcv_tpu.ops import image as J
from tlxcv_tpu_torch.ops import image as T


def _ties(rng, shape):
    """ReLU'd small integers: most windows hold equal elements, many all
    zeros, as after ENet's ReLUs."""
    return np.maximum(rng.integers(-3, 3, size=shape), 0).astype(np.float32)


@pytest.mark.parametrize("shape,k,s,p", [
    ((2, 8, 8, 5), 2, 2, 0),       # ENet's down blocks
    ((2, 9, 7, 3), 2, 2, 0),       # odd sizes: the last row and col dropped
    ((2, 9, 7, 3), 3, 2, 1),       # overlapping, padded windows
    ((1, 6, 10, 4), (2, 3), None, 0),
    ((1, 5, 5, 2), 3, 1, 1),
])
@pytest.mark.parametrize("data", ["ties", "normal", "constant"])
def test_argmax_pool_is_bitwise_the_references(rng, shape, k, s, p, data):
    if data == "ties":
        x = _ties(rng, shape)
    elif data == "normal":
        x = rng.normal(size=shape).astype(np.float32)
    else:
        x = np.full(shape, -2.5, np.float32)
    want_v, want_i = J.max_pool2d_with_argmax(jnp.asarray(x), k, s, p)
    got_v, got_i = T.max_pool2d_with_argmax(torch.from_numpy(x), k, s, p)
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("shape", [(2, 8, 8, 5), (2, 9, 7, 3), (1, 4, 6, 16)])
def test_unpool_scatters_as_the_reference(rng, shape):
    x = _ties(rng, shape)
    vals, idx = J.max_pool2d_with_argmax(jnp.asarray(x), 2, 2)
    # other values than the pooled ones, as ENet's up blocks scatter
    y = rng.normal(size=vals.shape).astype(np.float32)
    want = J.max_unpool2d(jnp.asarray(y), idx, shape[1:3])
    got = T.max_unpool2d(torch.from_numpy(y),
                         torch.from_numpy(np.array(idx)), shape[1:3])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unpool_drops_indices_outside_the_output(rng):
    """As ``.at[].set(mode="drop")``: -1 counts from the end, 16 and 99 are
    outside a 4x4 output."""
    y = rng.normal(size=(1, 2, 2, 3)).astype(np.float32)
    idx = np.array([[[[0, -1, 15], [3, 16, 5]], [[99, 8, 9], [12, 13, 2]]]],
                   np.int32)
    want = J.max_unpool2d(jnp.asarray(y), jnp.asarray(idx), (4, 4))
    got = T.max_unpool2d(torch.from_numpy(y), torch.from_numpy(idx), (4, 4))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("hw,out", [
    ((8, 8), (16, 16)), ((8, 8), (16, 20)), ((5, 7), (13, 3)),
    ((16, 20), (7, 9)),            # downscale: the kernel widened
    ((32, 32), (8, 8)), ((9, 9), (9, 4)), ((6, 6), (6, 6)),
])
def test_bicubic_matches_jax_image_resize(rng, hw, out):
    x = rng.normal(size=(2, *hw, 3)).astype(np.float32)
    want = np.asarray(J.interpolate(jnp.asarray(x), size=out,
                                    mode="bicubic"))
    got = T.interpolate(torch.from_numpy(x), size=out, mode="bicubic")
    assert got.shape == (2, *out, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-6 * np.abs(want).max())


def test_bicubic_is_not_torchs_bicubic(rng):
    """F.interpolate's bicubic (a = -0.75, no antialias) is another
    function: the port does not take it."""
    x = rng.normal(size=(1, 16, 16, 2)).astype(np.float32)
    want = np.asarray(J.interpolate(jnp.asarray(x), size=(6, 6),
                                    mode="bicubic"))
    torchs = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=(6, 6),
        mode="bicubic").permute(0, 2, 3, 1).numpy()
    assert np.abs(torchs - want).max() > 1e-2 * np.abs(want).max()


@pytest.mark.parametrize("align_corners", [False, True])
def test_same_size_bilinear_is_an_identity(rng, align_corners):
    """JPU resizes C4 and C5 to C3's size, which a stride-8 backbone keeps:
    the very tensor comes back."""
    x = torch.from_numpy(rng.normal(size=(2, 6, 9, 4)).astype(np.float32))
    got = T.interpolate(x, size=(6, 9), mode="bilinear",
                        align_corners=align_corners)
    assert got is x
    want = J.interpolate(jnp.asarray(x.numpy()), size=(6, 9),
                         align_corners=align_corners)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fast_path", [True, False])
@pytest.mark.parametrize("factor", [2, 4])
def test_fast_path_keyword_matches_the_reference(rng, fast_path, factor):
    x = rng.normal(size=(2, 5, 6, 3)).astype(np.float32)
    size = (5 * factor, 6 * factor)
    want = np.asarray(J.interpolate(jnp.asarray(x), size=size,
                                    fast_path=fast_path))
    got = T.interpolate(torch.from_numpy(x), size=size, fast_path=fast_path)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="mode"):
        T.interpolate(torch.zeros(1, 4, 4, 1), size=(8, 8), mode="area")
