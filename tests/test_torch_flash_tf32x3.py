"""The split-TF32 ("3xTF32") arithmetic of the f32 flash-attention kernels,
emulated on the CPU and held against the JAX package.

The card's f32 kernels (``csrc/flash_attention.cu`` and
``csrc/flash_attention_bwd.cu``, their scheme in ``csrc/flash_attention.cuh``)
run every product on the tensor cores as three TF32 products: each f32
operand x is split into big = x rounded to TF32 (round to nearest, ties
away from zero: ``cvt.rna.tf32.f32``) and small = x - big, exact in f32; the
tensor core reads the top 19 bits of each (sign, exponent and 10 mantissa
bits: the low 13 are dropped), and a.b is summed in f32 as a_small.b_big +
a_big.b_small + a_big.b_big.  This file emulates that arithmetic in plain
torch (the emulation lives here, not in the package) and pins the argument
for it:

- the split is exact: big + small == x, bitwise but for the sign of a zero,
  big holds 10 mantissa bits and |small| <= 2^-11 |x|;
- the kernels' forward (the output and the rows' log-sum-exp) and backward
  (dq, dk and dv from the saved log-sum-exp) formulas, every product
  emulated, agree with JAX's f32 results within 1e-4 of their largest
  magnitude, the card kernels' bound, at small grids shaped like TrOCR's
  (head dims 32 and 64, Sq != Sk, a causal and a per-head bias).  JAX's
  forward is the Pallas kernel ``tlxcv_tpu.ops.pallas.attention.
  flash_attention`` in interpret mode where it takes the grid (one length
  for queries and keys), else the einsum path of ``tlxcv_tpu.nn.attention``;
  its gradients are ``jax.grad`` of that einsum path, which the JAX package
  trains on (the Pallas kernel has no VJP);
- one TF32 pass (big.big alone) misses that bound at the same grids: three
  digits are not enough, which is why the kernels split.

Inputs come from numpy with a seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlxcv_tpu.nn.attention import scaled_dot_product_attention as j_sdpa
from tlxcv_tpu.ops.pallas.attention import flash_attention as j_flash
from tlxcv_tpu_torch.ops.cuda.attention import NEG

BOUND = 1e-4  # the card kernels' f32 bound, of the largest magnitude

GRIDS = {
    # name: (batch, heads, Sq, Sk, D, bias)
    "cross_d32": (2, 2, 8, 61, 32, None),        # decoder over the memory
    "causal_d32": (2, 2, 16, 16, 32, "causal"),  # teacher-forced self
    "encoder_d64": (1, 2, 37, 37, 64, None),
    "per_head_d64": (2, 2, 24, 40, 64, "per_head"),
    "per_head_square_d32": (1, 2, 20, 20, 32, "per_head"),
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: these micro grids gain nothing from more, and
    several test processes share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def tf32_rna(x):
    """f32 rounded to TF32 as ``cvt.rna.tf32.f32``: to 10 mantissa bits,
    to nearest, ties away from zero (the low 13 bits of the result 0)."""
    u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    mag = ((u & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    r = (u & 0x80000000) | mag
    return torch.where(r >= 2 ** 31, r - 2 ** 32, r).to(torch.int32).view(
        torch.float32)


def tensor_core_reads(x):
    """What the tensor core reads of an f32 word as a TF32 operand: its top
    19 bits."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x):
    big = tf32_rna(x)
    return big, x - big


def mm3(a, b):
    """a @ b as the kernels take it: three TF32 products summed in f32,
    the small terms first."""
    (ab, asm), (bb, bsm) = split(a), split(b)
    asm, bsm = tensor_core_reads(asm), tensor_core_reads(bsm)
    return asm @ bb + ab @ bsm + ab @ bb


def mm1(a, b):
    """One TF32 pass: both operands rounded to TF32, summed in f32."""
    return tf32_rna(a) @ tf32_rna(b)


def forward(q, k, v, bias, scale, mm):
    """The forward kernel's formulas: scores in f32, the bias added and
    clamped at ``NEG``, f32 softmax statistics, normalised at the end; the
    rows' log-sum-exp m + log(l)."""
    x = mm(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        x = torch.clamp_min(x + bias, NEG)
    m = x.amax(-1, keepdim=True)
    p = torch.exp(x - m)
    l = p.sum(-1, keepdim=True)
    return mm(p, v) / l, (m + torch.log(l))[..., 0]


def backward(q, k, v, bias, scale, out, lse, dout, mm):
    """The backward kernels' formulas: P = exp(x - lse), delta =
    rowsum(dO * O), dV = P^T dO, dS = P (dO V^T - delta) (0 where the clamp
    took the score), dQ = scale dS K, dK = scale dS^T Q."""
    x = mm(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        x = x + bias
    p = torch.exp(torch.clamp_min(x, NEG) - lse[..., None])
    delta = (dout * out).sum(-1, keepdim=True)
    ds = p * (mm(dout, v.transpose(-1, -2)) - delta)
    if bias is not None:
        ds = torch.where(x >= NEG, ds, 0.0)
    return (mm(ds, k) * scale, mm(ds.transpose(-1, -2), q) * scale,
            mm(p.transpose(-1, -2), dout))


def _inputs(rng, b, h, sq, sk, d, kind):
    q, k, v, g = (rng.normal(size=(b, h, n, d)).astype(np.float32)
                  for n in (sq, sk, sk, sq))
    bias = None
    if kind == "causal":
        bias = np.triu(np.full((1, 1, sq, sk), -1e9, np.float32), 1)
    elif kind == "per_head":
        bias = (rng.normal(size=(b, h, sq, sk)) * 2).astype(np.float32)
    return q, k, v, g, bias


def _jax_forward(q, k, v, bias):
    """JAX's f32 output: the Pallas kernel (interpret mode) when queries and
    keys have one length, else the einsum path."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if sq != sk:
        return np.asarray(j_sdpa(q, k, v, mask=None if bias is None
                                 else jnp.asarray(bias)))
    flat = [jnp.asarray(t.reshape(b * h, -1, d)) for t in (q, k, v)]
    jb = None if bias is None else jnp.asarray(
        bias.reshape(-1, sq, sk))
    out = j_flash(*flat, bias=jb, interpret=True)
    return np.asarray(out).reshape(b, h, sq, d)


def _jax_lse(q, k, bias):
    scores = jnp.einsum("...qd,...kd->...qk", jnp.asarray(q) * q.shape[-1]
                        ** -0.5, jnp.asarray(k))
    if bias is not None:
        scores = scores + jnp.asarray(bias)
    return np.asarray(jax.nn.logsumexp(scores, axis=-1))


def _jax_grads(q, k, v, g, bias):
    def f(q, k, v):
        out = j_sdpa(q, k, v, mask=None if bias is None
                     else jnp.asarray(bias))
        return jnp.sum(out * g)
    return [np.asarray(t) for t in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _emulated(name, rng, mm):
    """The inputs, JAX's results and the emulated kernels' at one grid."""
    b, h, sq, sk, d, kind = GRIDS[name]
    q, k, v, g, bias = _inputs(rng, b, h, sq, sk, d, kind)
    tq, tk, tv, tg = (torch.from_numpy(t) for t in (q, k, v, g))
    tb = None if bias is None else torch.from_numpy(bias)
    out, lse = forward(tq, tk, tv, tb, d ** -0.5, mm)
    grads = backward(tq, tk, tv, tb, d ** -0.5, out, lse, tg, mm)
    return (q, k, v, g, bias), out, lse, grads


def _rel(got, want):
    return float(np.abs(got.detach().numpy() - want).max()
                 / np.abs(want).max())


def test_split_is_exact_and_small_is_small(rng):
    x = (rng.normal(size=200_000) * 10.0 ** rng.uniform(-30, 30, 200_000)
         ).astype(np.float32)
    x[:4] = (0.0, -0.0, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11))  # ties
    t = torch.from_numpy(x)
    big, small = split(t)
    assert torch.equal(big + small, t)
    nonzero = t != 0  # -0.0 splits into -0.0 and +0.0, whose sum is +0.0
    assert torch.equal((big + small)[nonzero].view(torch.int32),
                       t[nonzero].view(torch.int32))
    assert not (big.view(torch.int32) & 0x1FFF).any()
    assert (small.abs() <= t.abs() * 2.0 ** -11).all()
    # ties round away from zero
    assert big[2].item() == 1.0 + 2.0 ** -10
    assert big[3].item() == -(1.0 + 2.0 ** -10)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_split_tf32_forward_matches_jax(rng, name):
    (q, k, v, _, bias), out, lse, _ = _emulated(name, rng, mm3)
    assert _rel(out, _jax_forward(q, k, v, bias)) <= BOUND
    want_lse = _jax_lse(q, k, bias)
    assert _rel(lse, want_lse) <= BOUND


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_split_tf32_backward_matches_jax_grad(rng, name):
    (q, k, v, g, bias), _, _, grads = _emulated(name, rng, mm3)
    for got, want in zip(grads, _jax_grads(q, k, v, g, bias)):
        assert _rel(got, want) <= BOUND


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_one_tf32_pass_misses_the_bound(rng, name):
    """With big.big alone the output or a gradient lies past 1e-4 of its
    largest magnitude from JAX's: TF32 keeps about three digits."""
    (q, k, v, g, bias), out, _, grads = _emulated(name, rng, mm1)
    errs = [_rel(out, _jax_forward(q, k, v, bias))] + [
        _rel(got, want)
        for got, want in zip(grads, _jax_grads(q, k, v, g, bias))]
    assert max(errs) > BOUND, errs
