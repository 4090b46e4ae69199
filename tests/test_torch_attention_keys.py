"""Attention with a key length of its own (Sk != Sq), the port against the
JAX package on the CPU.

The JAX package's ``scaled_dot_product_attention`` (its default einsum
path) takes any key length; DETR's cross-attention has 100 queries over
H·W keys.  The port's ``scaled_dot_product_attention`` and
``flash_attention`` once refused k and v whose length differed from q's,
even on the CPU, where the JAX package computes them.  The Pallas kernel
itself takes one S, so it is held against the port at Sq = Sk only, in
interpret mode as the JAX package's own tests run it."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlxcv_tpu.nn.attention import scaled_dot_product_attention as jax_sdpa
from tlxcv_tpu.ops.pallas.attention import flash_attention as jax_flash
from tlxcv_tpu_torch.nn.attention import scaled_dot_product_attention
from tlxcv_tpu_torch.ops.cuda.attention import (flash_attention,
                                                flash_attention_plain)

B, H, D = 2, 3, 16
LENGTHS = [(1, 7), (8, 24), (24, 8), (100, 257)]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _inputs(rng, sq, sk):
    q = rng.normal(size=(B, H, sq, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, H, sk, D)).astype(np.float32)
            for _ in range(2))
    return q, k, v


def _strided(q, k, v):
    """[B, H, S, D] views into token-major projections, as DETR's
    ``_split`` hands them over: q from [B, Sq, H, D], k and v from one
    packed [B, Sk, 2, H, D]."""
    tq = _t(q.transpose(0, 2, 1, 3)).transpose(1, 2)
    kv = _t(np.stack([k, v], 0).transpose(1, 3, 0, 2, 4))  # B, Sk, 2, H, D
    tk, tv = kv.permute(2, 0, 3, 1, 4)
    assert not tk.is_contiguous()
    return tq, tk, tv


@pytest.mark.parametrize("layout", ["3d", "4d_strided"])
@pytest.mark.parametrize("bias", [None, "shared", "per_bh"])
@pytest.mark.parametrize("sq,sk", LENGTHS)
def test_sdpa_takes_its_own_key_length(rng, sq, sk, bias, layout):
    """The port's ``scaled_dot_product_attention`` and
    ``flash_attention_plain`` against the JAX einsum path, f32, within
    1e-5 (the same arithmetic in another summation order)."""
    q, k, v = _inputs(rng, sq, sk)
    b = None
    if bias is not None:
        b = rng.normal(size=(1 if bias == "shared" else B * H, sq, sk)
                       ).astype(np.float32)
    mask = b  # [1, Sq, Sk] broadcasts over B and H; [BH, Sq, Sk] fits 3D
    if layout == "3d":
        q, k, v = (x.reshape(B * H, -1, D) for x in (q, k, v))
        tq, tk, tv = map(_t, (q, k, v))
    else:
        tq, tk, tv = _strided(q, k, v)
        if bias == "per_bh":
            mask = b.reshape(B, H, sq, sk)
    want = np.asarray(jax_sdpa(*map(jnp.asarray, (q, k, v)),
                               mask=None if mask is None
                               else jnp.asarray(mask)))
    got = scaled_dot_product_attention(
        tq, tk, tv, mask=None if mask is None else _t(mask))
    assert got.shape == tq.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    plain = flash_attention_plain(tq, tk, tv,
                                  bias=None if b is None else _t(b))
    np.testing.assert_allclose(plain.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        flash_attention(tq, tk, tv, bias=None if b is None else _t(b))
        .numpy(), plain.numpy())


def test_cross_attention_of_the_queue_3_input(rng):
    """The recorded fault's minimal input: q [2, 2, 8, 16], k and v [2, 2,
    24, 16].  The parent tree raised ``ValueError`` here; the JAX package
    returns the attention."""
    q = rng.normal(size=(2, 2, 8, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 2, 24, 16)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(jax_sdpa(*map(jnp.asarray, (q, k, v))))
    got = scaled_dot_product_attention(*map(_t, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("with_bias", [False, True])
def test_plain_matches_the_pallas_kernel_at_equal_lengths(rng, with_bias):
    """At Sq = Sk the plain version still matches the Pallas kernel in
    interpret mode (ragged S = 40 against its 32-row blocks)."""
    bh, s, d = 4, 40, 32
    q, k, v = (rng.normal(size=(bh, s, d)).astype(np.float32)
               for _ in range(3))
    bias = rng.normal(size=(bh, s, s)).astype(np.float32) if with_bias \
        else None
    want = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)),
                                bias=None if bias is None
                                else jnp.asarray(bias),
                                block_q=32, block_k=32, interpret=True))
    got = flash_attention_plain(*map(_t, (q, k, v)),
                                bias=None if bias is None else _t(bias))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("shapes", [
    ((2, 8, 16), (2, 24, 32), (2, 24, 32)),   # head dims differ
    ((2, 8, 16), (2, 24, 16), (2, 20, 16)),   # k and v lengths differ
    ((2, 8, 16), (3, 24, 16), (3, 24, 16)),   # leading dims differ
    ((2, 8, 16), (2, 2, 24, 16), (2, 2, 24, 16)),  # ranks differ
])
def test_mismatched_keys_still_raise(shapes):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError):
        flash_attention(q, k, v)


def test_bias_must_be_sq_by_sk():
    q, k = torch.zeros(2, 8, 16), torch.zeros(2, 24, 16)
    with pytest.raises(ValueError, match=r"\[1\|BH, 8, 24\]"):
        flash_attention(q, k, k, bias=torch.zeros(1, 24, 8))
