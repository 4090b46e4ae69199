"""The flash-attention backward's plain version against the JAX package on
the CPU.

``flash_attention_backward_plain`` (the formulas of
``csrc/flash_attention_bwd.cu``) and autograd through
``flash_attention_plain`` are both held against ``jax.grad`` of
``tlxcv_tpu.nn.attention.scaled_dot_product_attention`` on its default
(einsum) path, in f32: the JAX package's Pallas kernel has no VJP, and it
trains on that path.  Tolerance 1e-5 of each gradient's largest magnitude:
f32 sums over at most 128 head dims and 33 keys, taken in other orders.
``lse`` from the plain forward equals the log-sum-exp of the JAX scores
within 1e-5 (absolute; the scores are O(10)).  A query row whose every key
is masked is pinned on its own (the JAX default path gives NaN there; the
port's forward averages v, and its backward is that function's gradient).

The edge shapes are those of the card kernel's 64-row tiles (Sq and Sk
each in {1, 63, 64, 65, 127, 128, 129, 197}, each against both of its
neighbours in that list, at every head dim the kernel takes), with no
bias, one broadcast over the heads or one per head; there the sums run
over up to 197 keys, and the bound is 1e-5 of the largest magnitude of
the three gradients: at Sk = 1 the exact dq and dk are 0 (a softmax over
one key is constant, so dP - delta cancels), and both sides give f32
rounding of that cancellation, on the scale of the terms, which dv
shows."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlxcv_tpu.nn.attention import scaled_dot_product_attention as j_sdpa
from tlxcv_tpu_torch.ops.cuda.attention import (
    NEG, flash_attention, flash_attention_backward_plain,
    flash_attention_plain)

TOL = 1e-5

CASES = {
    # name: (batch, heads, Sq, Sk, D, mask)
    "vit_like_s13_d64": (2, 3, 13, 13, 64, False),
    "sq7_sk33": (2, 2, 7, 33, 32, False),
    "additive_mask": (2, 2, 9, 12, 64, True),
    "d32": (1, 2, 11, 11, 32, False),
    "d96": (1, 2, 11, 11, 96, False),
    "d128": (1, 2, 11, 17, 128, True),
    "odd_d": (2, 1, 5, 6, 7, False),
}


def _inputs(rng, b, h, sq, sk, d, masked):
    q = rng.normal(size=(b, h, sq, d)).astype(np.float32)
    k = rng.normal(size=(b, h, sk, d)).astype(np.float32)
    v = rng.normal(size=(b, h, sk, d)).astype(np.float32)
    g = rng.normal(size=(b, h, sq, d)).astype(np.float32)
    mask = None
    if masked:
        mask = (rng.normal(size=(1, 1, sq, sk)) * 2).astype(np.float32)
        mask[..., ::3] = -1e9                    # a large finite mask
        mask[..., 1::4] = -np.inf                # and -inf entries
        mask[..., :, 0] = 0.0                    # no row masked entirely
    return q, k, v, g, mask


def _jax_grads(q, k, v, g, mask):
    def f(q, k, v):
        out = j_sdpa(q, k, v, mask=None if mask is None
                     else jnp.asarray(mask))
        return jnp.sum(out * g)
    return [np.asarray(t) for t in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _bias(mask):
    return None if mask is None else torch.from_numpy(mask).reshape(
        1, *mask.shape[-2:])


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_jax_grad(rng, name):
    b, h, sq, sk, d, masked = CASES[name]
    q, k, v, g, mask = _inputs(rng, b, h, sq, sk, d, masked)
    want = _jax_grads(q, k, v, g, mask)
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    bias = _bias(mask)
    out, lse = flash_attention_plain(tq, tk, tv, bias, return_lse=True)
    got = flash_attention_backward_plain(tq, tk, tv, bias, None, out, lse,
                                         torch.from_numpy(g))
    for gt, w in zip(got, want):
        _close(gt, w)


@pytest.mark.parametrize("name", sorted(CASES))
def test_autograd_through_plain_forward_matches_jax_grad(rng, name):
    b, h, sq, sk, d, masked = CASES[name]
    q, k, v, g, mask = _inputs(rng, b, h, sq, sk, d, masked)
    want = _jax_grads(q, k, v, g, mask)
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, bias=_bias(mask))
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for gt, w in zip(got, want):
        _close(gt, w)


@pytest.mark.parametrize("name", ["vit_like_s13_d64", "sq7_sk33",
                                  "additive_mask"])
def test_lse_is_the_log_sum_exp_of_the_jax_scores(rng, name):
    b, h, sq, sk, d, masked = CASES[name]
    q, k, v, _, mask = _inputs(rng, b, h, sq, sk, d, masked)
    scores = jnp.einsum("...qd,...kd->...qk", jnp.asarray(q) * d ** -0.5,
                        jnp.asarray(k))
    if mask is not None:
        scores = scores + jnp.asarray(mask)
    want = np.asarray(jax.nn.logsumexp(scores, axis=-1)).reshape(-1, sq)
    _, lse = flash_attention_plain(*(torch.from_numpy(t) for t in (q, k, v)),
                                   _bias(mask), return_lse=True)
    assert lse.shape == (b * h, sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, rtol=0, atol=1e-5)


def test_fully_masked_row_backward_is_the_gradient_of_the_mean(rng):
    """Row 1 masked at every key: the forward gives mean(v), so dv takes
    dout / Sk from it and dq of that row is 0 (its scores are clamped
    constants); the plain backward equals autograd there."""
    q, k, v, g, _ = _inputs(rng, 1, 2, 5, 8, 32, False)
    bias = torch.from_numpy(rng.normal(size=(1, 5, 8)).astype(np.float32))
    bias[:, 1] = -float("inf")
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out, lse = flash_attention_plain(*leaves, bias, return_lse=True)
    want = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    assert (lse[:, 1] == NEG).all()
    got = flash_attention_backward_plain(
        *(t.detach() for t in leaves), bias, None, out.detach(),
        lse.detach(), torch.from_numpy(g))
    for gt, w in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), w.numpy(), rtol=0,
                                   atol=TOL * w.abs().max().item())
    assert (got[0][:, :, 1] == 0).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_backward_matches_autograd_in_the_working_dtype(rng, dtype):
    """In bf16 the forward rounds P before P·V and autograd passes the
    gradient through that cast; the plain backward rounds P for dv: within
    2e-2 of the largest magnitude in bf16 (the kernel's bound), 1e-5 in
    f32."""
    q, k, v, g, mask = _inputs(rng, 2, 3, 13, 21, 64, True)
    leaves = [torch.from_numpy(t).to(dtype).requires_grad_()
              for t in (q, k, v)]
    bias = _bias(mask)
    out, lse = flash_attention_plain(*leaves, bias, return_lse=True)
    gt = torch.from_numpy(g).to(dtype)
    want = torch.autograd.grad(out, leaves, gt)
    got = flash_attention_backward_plain(*(t.detach() for t in leaves),
                                         bias, None, out.detach(),
                                         lse.detach(), gt)
    tol = 2e-2 if dtype == torch.bfloat16 else TOL
    for a, w in zip(got, want):
        assert a.dtype == dtype
        w = w.float()
        assert (a.float() - w).abs().max() <= tol * w.abs().max()


EDGE_SIZES = (1, 63, 64, 65, 127, 128, 129, 197)
EDGE_BIASES = (None, "broadcast", "per_bh")
EDGE_CASES = [  # (Sq, Sk, D, bias), the bias kinds in turn
    (sq, EDGE_SIZES[(i + step) % 8], d,
     EDGE_BIASES[(2 * i + (step > 0) + d // 32) % 3])
    for d in (32, 64, 96, 128) for i, sq in enumerate(EDGE_SIZES)
    for step in (1, -1)]


def _edge_inputs(rng, sq, sk, d, bias_kind, b=1, h=2):
    """q, k, v, the output's gradient and an additive mask ([1, 1, Sq, Sk]
    broadcast over the heads, or [B, H, Sq, Sk]) with -inf at every fourth
    key from the second: no row is masked entirely."""
    q = rng.normal(size=(b, h, sq, d)).astype(np.float32)
    k = rng.normal(size=(b, h, sk, d)).astype(np.float32)
    v = rng.normal(size=(b, h, sk, d)).astype(np.float32)
    g = rng.normal(size=(b, h, sq, d)).astype(np.float32)
    mask = None
    if bias_kind is not None:
        lead = (1, 1) if bias_kind == "broadcast" else (b, h)
        mask = (rng.normal(size=(*lead, sq, sk)) * 2).astype(np.float32)
        mask[..., 1::4] = -np.inf
    return q, k, v, g, mask


@pytest.mark.parametrize(
    "sq,sk,d,bias_kind", EDGE_CASES,
    ids=[f"sq{sq}-sk{sk}-d{d}-{b or 'nobias'}" for sq, sk, d, b in EDGE_CASES])
def test_plain_backward_matches_jax_grad_at_kernel_edges(rng, sq, sk, d,
                                                         bias_kind):
    q, k, v, g, mask = _edge_inputs(rng, sq, sk, d, bias_kind)
    want = _jax_grads(q, k, v, g, mask)
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    bias = None if mask is None else torch.from_numpy(mask).reshape(
        -1, sq, sk)
    out, lse = flash_attention_plain(tq, tk, tv, bias, return_lse=True)
    got = flash_attention_backward_plain(tq, tk, tv, bias, None, out, lse,
                                         torch.from_numpy(g))
    _close_all(got, want)


def _close_all(got, want):
    """Each gradient within 1e-5 of the largest magnitude of the three."""
    want = [w.detach().numpy() if isinstance(w, torch.Tensor) else w
            for w in want]
    scale = max(np.abs(w).max() for w in want)
    for gt, w in zip(got, want):
        assert gt.shape == w.shape
        np.testing.assert_allclose(gt.detach().numpy(), w, rtol=0,
                                   atol=TOL * scale)


@pytest.mark.parametrize("sq,sk,d", [(1, 63, 32), (65, 1, 64),
                                     (128, 129, 96), (197, 64, 128)])
def test_fully_masked_row_at_kernel_edges(rng, sq, sk, d):
    """Query row 0 masked at every key, the other rows at every fourth key
    from the second: the plain backward equals autograd through the plain
    forward (which averages v on row 0) in every gradient, and the JAX
    package's dq on the other rows (the JAX path gives NaN on row 0, and
    through it on every key's dk and dv), within 1e-5 of the largest
    magnitude of the three gradients."""
    q, k, v, g, _ = _inputs(rng, 1, 2, sq, sk, d, False)
    bias = torch.from_numpy((rng.normal(size=(2, sq, sk)) * 2).astype(
        np.float32))
    bias[:, :, 1::4] = -float("inf")
    bias[:, 0] = -float("inf")
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out, lse = flash_attention_plain(*leaves, bias, return_lse=True)
    want = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    assert (lse[:, 0] == NEG).all()
    got = flash_attention_backward_plain(
        *(t.detach() for t in leaves), bias, None, out.detach(),
        lse.detach(), torch.from_numpy(g))
    _close_all(got, want)
    if sq > 1:
        jax_dq = _jax_grads(q, k, v, g, bias.numpy().reshape(1, 2, sq, sk))[0]
        scale = max(w.abs().max().item() for w in want)
        np.testing.assert_allclose(got[0][:, :, 1:].numpy(),
                                   jax_dq[:, :, 1:], rtol=0,
                                   atol=TOL * scale)
