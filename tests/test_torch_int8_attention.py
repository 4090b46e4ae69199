"""The port's opt-in int8 attention against the JAX package's ``_int8_sdpa``
on the CPU.

Tolerances: the per-head quantization (codes and scales) and the int32
products are exact, bitwise.  The two softmaxes may differ in the last
ulp, and a probability code ``round(p / ps)`` that sits on a rounding
boundary may then move by one: at most 1 apart, in at most 1% of the
codes.  Each such code moves an output by ``ps * vs * |v code|`` <=
``ps * vs * 127``; the outputs are held to 2e-6 of the largest magnitude,
which the measured difference (about 2.5e-7 of it) sits well inside.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlxcv_tpu.nn import attention as JA
from tlxcv_tpu_torch.nn import attention as TA
from tlxcv_tpu_torch.utils import load_jax_params

SHAPE = (2, 3, 33, 16)


def _qkv(rng):
    return [rng.normal(size=SHAPE).astype(np.float32) * 2 for _ in range(3)]


def _mask(rng, masked):
    if not masked:
        return None
    return np.where(rng.random((1, 1, SHAPE[2], SHAPE[2])) < 0.2, -1e9,
                    0.0).astype(np.float32)


def _jax_probability_codes(q, k, mask, scale):
    """The reference's steps up to the probability codes."""
    qi, qs = JA._quant_dyn(jnp.asarray(q))
    ki, ks = JA._quant_dyn(jnp.asarray(k))
    acc = jnp.einsum("...qd,...kd->...qk", qi, ki,
                     preferred_element_type=jnp.int32)
    attn = acc.astype(jnp.float32) * (qs * ks * scale)
    if mask is not None:
        attn = attn + jnp.asarray(mask)
    p = np.asarray(jax.nn.softmax(attn, axis=-1))
    ps = np.maximum(p.max(-1, keepdims=True), 1e-6) / 127.0
    return np.asarray(acc), np.round(p / ps).astype(np.int8)


@pytest.mark.parametrize("masked", [False, True])
def test_int8_sdpa_matches_jax(rng, masked):
    q, k, v = _qkv(rng)
    mask = _mask(rng, masked)
    scale = SHAPE[-1] ** -0.5
    for t in (q, k, v):
        jq, js = JA._quant_dyn(jnp.asarray(t))
        tq, ts = TA._quant_dyn(torch.from_numpy(t))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))

    want_acc, want_codes = _jax_probability_codes(q, k, mask, scale)
    tq, tqs = TA._quant_dyn(torch.from_numpy(q))
    tk, tks = TA._quant_dyn(torch.from_numpy(k))
    acc = TA.int8_products(tq, tk.transpose(-1, -2))
    np.testing.assert_array_equal(acc.numpy(), want_acc.astype(np.float32))
    attn = acc * (tqs * tks * scale)
    if mask is not None:
        attn = attn + torch.from_numpy(mask)
    p = torch.softmax(attn, -1)
    ps = torch.clamp_min(p.amax(-1, keepdim=True), 1e-6) / 127.0
    codes = torch.round(p / ps).to(torch.int8).numpy()
    moved = codes.astype(np.int32) - want_codes
    assert np.abs(moved).max() <= 1
    assert (moved != 0).mean() <= 0.01

    want = np.asarray(JA._int8_sdpa(*map(jnp.asarray, (q, k, v)),
                                    None if mask is None
                                    else jnp.asarray(mask), scale))
    with torch.no_grad():
        got = TA._int8_sdpa(*map(torch.from_numpy, (q, k, v)),
                            None if mask is None else torch.from_numpy(mask),
                            scale).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 * np.abs(want).max())


def test_use_int8_attention_global_and_per_call(rng):
    q, k, v = (torch.from_numpy(t) for t in _qkv(rng))
    with torch.no_grad():
        int8 = TA._int8_sdpa(q, k, v, None, SHAPE[-1] ** -0.5)
        float_ = TA.scaled_dot_product_attention(q, k, v)
        assert not torch.equal(int8, float_)
        assert torch.equal(TA.scaled_dot_product_attention(
            q, k, v, use_int8=True), int8)
        try:
            TA.use_int8_attention(True)
            assert torch.equal(TA.scaled_dot_product_attention(q, k, v), int8)
            assert torch.equal(TA.scaled_dot_product_attention(
                q, k, v, use_int8=False), float_)
        finally:
            TA.use_int8_attention(False)
        assert torch.equal(TA.scaled_dot_product_attention(q, k, v), float_)


def test_mha_with_int8_attention_matches_jax(rng):
    dim, heads, n = 64, 4, 17
    jm = JA.MultiHeadAttention(dim, heads, qkv_bias=True)
    tm = TA.MultiHeadAttention(dim, heads, qkv_bias=True, device="cpu")
    load_jax_params(tm, {p: np.asarray(a) for p, a in jm.state_dict().items()})
    x = rng.normal(size=(2, n, dim)).astype(np.float32)
    try:
        JA.use_int8_attention(True)
        TA.use_int8_attention(True)
        want = np.asarray(jm(jnp.asarray(x)))
        with torch.no_grad():
            got = tm(torch.from_numpy(x)).numpy()
    finally:
        JA.use_int8_attention(False)
        TA.use_int8_attention(False)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-4 * np.abs(want).max())


def test_int8_products_are_exact_up_to_the_guard(rng):
    k = TA.INT8_EXACT_K
    assert k == 1040 and k * 127 ** 2 < 2 ** 24 <= (k + 1) * 127 ** 2
    a = torch.full((2, 3, k), 127, dtype=torch.int8)
    b = torch.full((2, k, 5), -127, dtype=torch.int8)
    assert (TA.int8_products(a, b) == -k * 127 ** 2).all()
    a = torch.from_numpy(rng.integers(-127, 128, (2, 4, 7, k), np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (2, 4, k, 9), np.int8))
    got = TA.int8_products(a, b)
    assert got.dtype == torch.float32
    want = TA.int8_products_plain(a, b)
    assert want.dtype == torch.int32
    assert torch.equal(got.to(torch.int32), want)
    # past the guard: int32 sums over chunks of at most 1040, equal to the
    # plain int32 product (cast to f32 once), up to the int32 limit
    for kk in (k + 1, 2 * k + 7):
        a2 = torch.from_numpy(rng.integers(-127, 128, (2, 3, kk), np.int8))
        b2 = torch.from_numpy(rng.integers(-127, 128, (2, kk, 5), np.int8))
        assert torch.equal(TA.int8_products(a2, b2),
                           TA.int8_products_plain(a2, b2).float())
    big = TA.INT8_INT32_K
    assert big * 127 ** 2 < 2 ** 31 <= (big + 1) * 127 ** 2
    a2 = torch.full((1, 1, 3 * k), 127, dtype=torch.int8)
    b2 = torch.full((1, 3 * k, 1), 127, dtype=torch.int8)
    assert TA.int8_products(a2, b2).item() == float(3 * k * 127 ** 2)
    with pytest.raises(ValueError, match="overflows"):
        TA.int8_products(torch.zeros(1, 2, big + 1, dtype=torch.int8),
                         torch.zeros(1, big + 1, 2, dtype=torch.int8))
    with pytest.raises(TypeError):
        TA.int8_products(a.float(), b)
    with pytest.raises(ValueError):
        TA.int8_products(a, b[..., :-1, :])


def test_int8_attention_refuses_gradients(rng):
    q = torch.from_numpy(_qkv(rng)[0]).requires_grad_()
    with pytest.raises(RuntimeError, match="serving-only"):
        TA.scaled_dot_product_attention(q, q, q, use_int8=True)
    with torch.no_grad():
        TA.scaled_dot_product_attention(q, q, q, use_int8=True)


@pytest.mark.parametrize("sk", [1041, 1050, 4096])
def test_int8_sdpa_past_the_exact_f32_range_matches_jax(rng, sk):
    """More keys than the f32 product holds exactly (1040): q [1, 2, 4,
    32], k and v [1, 2, Sk, 32] (1050 is DETR-R50's encoder at 800x1344).
    The codes of q, k and v are bitwise the reference's; the P.V sums over
    Sk, given the reference's probability codes, bitwise its int32 sums
    (cast to f32); the outputs within the tolerance of
    ``test_int8_sdpa_matches_jax``."""
    q = rng.normal(size=(1, 2, 4, 32)).astype(np.float32) * 2
    k, v = (rng.normal(size=(1, 2, sk, 32)).astype(np.float32) * 2
            for _ in range(2))
    scale = 32 ** -0.5
    for t in (q, k, v):
        jq, js = JA._quant_dyn(jnp.asarray(t))
        tq, ts = TA._quant_dyn(torch.from_numpy(t))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    _, pcodes = _jax_probability_codes(q, k, None, scale)
    vi, _ = JA._quant_dyn(jnp.asarray(v))
    want_pv = jnp.einsum("...qk,...kd->...qd", jnp.asarray(pcodes), vi,
                         preferred_element_type=jnp.int32)
    got_pv = TA.int8_products(torch.from_numpy(pcodes),
                              torch.from_numpy(np.array(vi)))
    np.testing.assert_array_equal(
        got_pv.numpy(), np.asarray(want_pv).astype(np.float32))

    want = np.asarray(JA._int8_sdpa(*map(jnp.asarray, (q, k, v)), None,
                                    scale))
    with torch.no_grad():
        got = TA.scaled_dot_product_attention(
            *map(torch.from_numpy, (q, k, v)), use_int8=True).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 * np.abs(want).max())
