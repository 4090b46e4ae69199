"""Port attention (ops.cuda.attention, nn.attention) against the JAX
package on the CPU, on the reference's own flash-attention cases
(tests/test_pallas_ops.py).  The JAX side runs as its own tests run it:
the XLA path, or the Pallas kernel with ``interpret=True``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlxcv_tpu.nn.attention import MultiHeadAttention as JaxMHA
from tlxcv_tpu.nn.attention import scaled_dot_product_attention as jax_sdpa
from tlxcv_tpu.ops.pallas.attention import flash_attention as jax_flash
from tlxcv_tpu_torch.nn.attention import (MultiHeadAttention,
                                          scaled_dot_product_attention)
from tlxcv_tpu_torch.ops.cuda.attention import (flash_attention,
                                                flash_attention_plain)
from tlxcv_tpu_torch.utils import load_jax_params


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("bh,s,d,nb", [(4, 197, 64, 1), (6, 197, 64, 3),
                                       (8, 49, 32, 4)])
def test_flash_matches_jax(rng, bh, s, d, nb, with_bias):
    q, k, v = (rng.normal(size=(bh, s, d)).astype(np.float32)
               for _ in range(3))
    bias = (rng.normal(size=(bh, s, s)).astype(np.float32)
            if with_bias else None)
    jb = None if bias is None else jnp.asarray(bias)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_xla = np.asarray(jax_sdpa(jq, jk, jv, mask=jb))
    want_pallas = np.asarray(jax_flash(jq, jk, jv, bias=jb, nb=nb,
                                       interpret=True))
    tb = None if bias is None else _t(bias)
    for fn in (flash_attention_plain, flash_attention):
        got = fn(_t(q), _t(k), _t(v), bias=tb).numpy()
        np.testing.assert_allclose(got, want_xla, atol=2e-5)
        np.testing.assert_allclose(got, want_pallas, atol=2e-5)


@pytest.mark.parametrize("mask_shape", [(1, 1, 60, 60), (60, 60),
                                        (2, 3, 60, 60), (2, 1, 60, 60)])
def test_sdpa_mask_wiring_matches_jax(rng, mask_shape):
    """[B, H, S, D] + a broadcastable mask, as test_sdpa_use_flash_wiring:
    batch/head-invariant masks become one [1, S, S] bias, the rest a
    per-BH bias."""
    q, k, v = (rng.normal(size=(2, 3, 60, 32)).astype(np.float32)
               for _ in range(3))
    mask = rng.normal(size=mask_shape).astype(np.float32)
    want = np.asarray(jax_sdpa(*map(jnp.asarray, (q, k, v, mask))))
    got = scaled_dot_product_attention(_t(q), _t(k), _t(v), mask=_t(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5)


def test_first_kv_tile_fully_masked_rows():
    """Block-diagonal mask: with 32-key tiles the second segment's queries
    see their whole first tile masked (test_pallas_ops.py:156)."""
    rng = np.random.default_rng(0)
    bh, s, d = 2, 64, 32
    q, k, v = (rng.normal(size=(bh, s, d)).astype(np.float32)
               for _ in range(3))
    seg = np.arange(s) // 32
    mask = np.where(seg[:, None] == seg[None, :], 0.0, -np.inf)
    bias = np.broadcast_to(mask, (1, s, s)).astype(np.float32)
    want = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)),
                                bias=jnp.asarray(bias), block_q=32,
                                block_k=32, interpret=True))
    got = flash_attention(_t(q), _t(k), _t(v), bias=_t(bias)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_fully_masked_row_is_finite():
    """A row masked across all of S averages v over its S keys.  The TPU
    kernel instead divides the sum of v by its padded length (here 64 for
    S = 40 at block_k = 32), so only that row differs; no parity is
    asked for it."""
    rng = np.random.default_rng(0)
    bh, s, d = 1, 40, 32
    q, k, v = (rng.normal(size=(bh, s, d)).astype(np.float32)
               for _ in range(3))
    bias = np.zeros((1, s, s), np.float32)
    bias[0, 0] = -np.inf
    out = flash_attention(_t(q), _t(k), _t(v), bias=_t(bias)).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out[:, 0], v.mean(1), atol=1e-6)
    tpu = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)),
                               bias=jnp.asarray(bias), block_q=32,
                               block_k=32, interpret=True))
    np.testing.assert_allclose(tpu[:, 0], v.sum(1) / 64, atol=1e-6)
    np.testing.assert_allclose(out[:, 1:], tpu[:, 1:], atol=2e-5)


def test_fully_masked_row_is_a_documented_divergence(monkeypatch):
    """A query row masked across all of S has no single reference value:
    the JAX package's default sdpa path gives NaN (softmax over an all
    -inf row), its opt-in Pallas path sum(v[:S]) / S_padded with S padded
    to the 256-row block of _flash_sdpa.  The port gives the finite
    mean(v[:S]) on its one path.  Every other row agrees."""
    import tlxcv_tpu.ops.pallas.attention as PA

    orig = PA.flash_attention
    monkeypatch.setattr(PA, "flash_attention",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    rng = np.random.default_rng(1)
    b, h, s, d = 1, 2, 40, 32
    q, k, v = (rng.normal(size=(b, h, s, d)).astype(np.float32)
               for _ in range(3))
    mask = np.zeros((s, s), np.float32)
    mask[0] = -np.inf
    jq, jk, jv, jm = map(jnp.asarray, (q, k, v, mask))
    default = np.asarray(jax_sdpa(jq, jk, jv, mask=jm))
    pallas = np.asarray(jax_sdpa(jq, jk, jv, mask=jm, use_flash=True))
    port = scaled_dot_product_attention(_t(q), _t(k), _t(v),
                                        mask=_t(mask)).numpy()
    assert np.isnan(default[:, :, 0]).all()
    np.testing.assert_allclose(pallas[:, :, 0], v.sum(2) / 256, atol=1e-6)
    np.testing.assert_allclose(port[:, :, 0], v.mean(2), atol=1e-6)
    assert np.isfinite(port).all()
    for other in (default, pallas):
        np.testing.assert_allclose(port[:, :, 1:], other[:, :, 1:],
                                   atol=3e-5)


def test_flash_takes_packed_qkv_views(rng):
    """[B, H, S, D] views into one packed [B, S, 3, H, D] projection (what
    MultiHeadAttention passes) give the [BH, S, D] results."""
    b, h, s, d = 2, 3, 50, 32
    packed = torch.from_numpy(
        rng.normal(size=(b, s, 3, h, d)).astype(np.float32))
    q, k, v = packed.permute(2, 0, 3, 1, 4)
    bias = torch.from_numpy(rng.normal(size=(b * h, s, s)).astype(np.float32))
    out = flash_attention(q, k, v, bias=bias)
    assert out.shape == (b, h, s, d)
    flat = [t.reshape(b * h, s, d).contiguous() for t in (q, k, v)]
    want = flash_attention(*flat, bias=bias)
    torch.testing.assert_close(out.reshape(b * h, s, d), want, rtol=0,
                               atol=0)
    with pytest.raises(ValueError):
        flash_attention(q[0], k, v)


@pytest.mark.parametrize("fn", [flash_attention, flash_attention_plain])
def test_rejects_bad_bias_leading_dim(fn):
    q = torch.zeros(4, 16, 32)
    with pytest.raises(ValueError):
        fn(q, q, q, bias=torch.zeros(2, 16, 16))
    with pytest.raises(ValueError):
        fn(q, q, q, bias=torch.zeros(1, 16, 15))


def test_no_plain_fallback_off_the_cpu():
    """Only a CPU tensor takes the plain version; any other device goes to
    the kernel's checks (and here raises), never quietly to torch ops."""
    q = torch.empty(2, 8, 32, device="meta")
    before = flash_attention.launches
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    assert flash_attention.launches == before


def test_int8_attention_not_ported():
    """The int8 attention runs (the name is kept from when this test
    checked its refusal; its parity with the reference is in
    tests/test_torch_int8_attention.py): all-zero inputs give zeros, also
    at a head dim past the exact f32 range (1041), where the products are
    summed in int32 over chunks of at most 1040 and equal the plain int32
    product."""
    from tlxcv_tpu_torch.nn.attention import (int8_products,
                                              int8_products_plain)

    q = torch.zeros(1, 2, 8, 32)
    out = scaled_dot_product_attention(q, q, q, use_int8=True)
    assert out.shape == q.shape and not out.any()
    big = torch.zeros(1, 1, 4, 1041)
    out = scaled_dot_product_attention(big, big, big, use_int8=True)
    assert out.shape == big.shape and not out.any()
    g = torch.Generator().manual_seed(0)
    a = torch.randint(-127, 128, (1, 4, 1041), generator=g).to(torch.int8)
    b = torch.randint(-127, 128, (1, 1041, 4), generator=g).to(torch.int8)
    assert torch.equal(int8_products(a, b),
                       int8_products_plain(a, b).float())


@pytest.mark.parametrize("with_mask", [False, True])
def test_mha_matches_jax(rng, with_mask):
    dim, heads, n = 64, 4, 17
    jm = JaxMHA(dim, heads, qkv_bias=True)
    tm = MultiHeadAttention(dim, heads, qkv_bias=True, device="cpu")
    load_jax_params(tm, {p: np.asarray(a) for p, a in jm.state_dict().items()})
    x = rng.normal(size=(2, n, dim)).astype(np.float32)
    mask = (rng.normal(size=(1, 1, n, n)).astype(np.float32)
            if with_mask else None)
    want = jm(jnp.asarray(x), mask=None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        got = tm(_t(x), mask=None if mask is None else _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert jax.default_backend() == "cpu"


def test_card_call_is_a_function_whose_backward_raises(monkeypatch, rng):
    """The card's call is an autograd node: its output has a ``grad_fn``,
    and its backward is the backward kernel's route (it raised before the
    kernel existed, rather than hand back zeros).  Here both launches are
    the plain versions, so the Function runs on the CPU: its forward is
    the plain result, and the gradients reaching the packed qkv are those
    of autograd through the plain forward; without grad it saves
    nothing."""
    import tlxcv_tpu_torch.ops.cuda.attention as A

    def plain_launch(q, k, v, bias, scale, with_lse=False):
        out, lse = flash_attention_plain(q, k, v, bias, scale,
                                         return_lse=True)
        out = out if q.ndim == 3 else out.transpose(1, 2).contiguous()
        return out, lse if with_lse else None

    def plain_backward(q, k, v, bias, scale, out, lse, grad):
        o = out if q.ndim == 3 else out.transpose(1, 2)
        g = grad if q.ndim == 3 else grad.transpose(1, 2)
        return A.flash_attention_backward_plain(q, k, v, bias, scale, o,
                                                lse, g)

    monkeypatch.setattr(A, "_launch_kernel", plain_launch)
    monkeypatch.setattr(A, "flash_attention_backward", plain_backward)
    b, h, s, d = 2, 3, 20, 32
    packed = torch.from_numpy(
        rng.normal(size=(b, s, 3, h, d)).astype(np.float32))
    packed.requires_grad_()
    q, k, v = packed.permute(2, 0, 3, 1, 4)
    out = A._FlashAttention.apply(q, k, v, None, d ** -0.5, True)
    assert out.grad_fn is not None and out.shape == (b, s, h, d)
    want = flash_attention_plain(q, k, v).transpose(1, 2)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    g = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32))
    got = torch.autograd.grad(out, packed, g)[0]
    ref = torch.autograd.grad(want, packed, g)[0]
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=1e-5 * float(ref.abs().max()))
    with torch.no_grad():  # no graph, nothing saved
        assert A._FlashAttention.apply(q, k, v, None, 0.5,
                                       False).grad_fn is None
