"""The port's BIT change detector and remote-sensing blocks against the JAX
package on the CPU, and the flash-attention plain path at head dims the
card pads (BIT's D = 4, and D = 2).

BIT runs at micro size: 64 px pairs (an 8 x 8 token grid at stride 8),
one encoder and two decoder layers, its full-width ResNet-18; width 32
over 8 heads (D = 4) and 16 over 8 (D = 2).  Weights are the JAX model's,
copied by the bridge; BatchNorm statistics from a numpy seed.  The torch
twin of ``tests/test_parity_zoo2.py`` (``TBIT``) is a second oracle: its
weights go into the JAX model, and from there into the port's.

Tolerances: f32 within 2e-4 of the largest magnitude
(``tests/test_parity_resnet.py:91``); against ``TBIT`` within its own
test's 5e-4 (it takes the exact GELU where both packages take the tanh
one); the flash plain path against the Pallas kernel in interpret mode
within 2e-5, as ``tests/test_torch_attention.py`` holds it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlxcv_tpu import nn as jnn
from tlxcv_tpu.core import pure, split
from tlxcv_tpu.models.rs import cd as JCD
from tlxcv_tpu.models.rs import layers as JL
from tlxcv_tpu.ops.pallas.attention import flash_attention as jax_flash
from tlxcv_tpu_torch import create_model
from tlxcv_tpu_torch.models.rs import cd as TCD
from tlxcv_tpu_torch.models.rs import layers as TL
from tlxcv_tpu_torch.ops.cuda.attention import (flash_attention,
                                                flash_attention_plain,
                                                padded_head_dim)
from tlxcv_tpu_torch.utils import load_jax_params


def _flat(jax_module):
    params, state = split(jax_module)
    return {k: np.asarray(v) for k, v in {**params, **state}.items()}


def _random_bn(jm, rng):
    for _, mod in jm.modules():
        if isinstance(mod, jnn.BatchNorm):
            c = mod.running_mean.value.shape[0]
            mod.running_mean.value = jnp.asarray(
                rng.normal(scale=0.2, size=(c,)), jnp.float32)
            mod.running_var.value = jnp.asarray(
                rng.uniform(0.5, 2.0, size=(c,)), jnp.float32)
            mod.weight.value = jnp.asarray(
                rng.uniform(0.5, 1.5, size=(c,)), jnp.float32)
            mod.bias.value = jnp.asarray(
                rng.normal(scale=0.1, size=(c,)), jnp.float32)


def _close(got, want, bound=2e-4):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=bound * np.abs(want).max())


def _x(rng, hw=64, c=3, n=2):
    return rng.normal(size=(n, hw, hw, c)).astype(np.float32)


# ------------------------------------------------------ rs/layers blocks
BLOCKS = [
    ("Conv1x1", lambda L, **k: L.Conv1x1(6, 5, **k)),
    ("Conv3x3_norm_act", lambda L, **k: L.Conv3x3(6, 5, norm=True, act=True,
                                                  **k)),
    ("Conv7x7_norm", lambda L, **k: L.Conv7x7(6, 4, norm=True, **k)),
    ("Conv3x3_bias_and_norm", lambda L, **k: L.Conv3x3(6, 5, norm=True,
                                                       bias=True, **k)),
    ("ConvTransposed3x3", lambda L, **k: L.ConvTransposed3x3(6, 4, **k)),
    ("ConvTransposed3x3_norm_act",
     lambda L, **k: L.ConvTransposed3x3(6, 4, norm=True, act=True, **k)),
    ("ChannelAttention", lambda L, **k: L.ChannelAttention(16, ratio=4, **k)),
    ("SpatialAttention", lambda L, **k: L.SpatialAttention(7, **k)),
    ("CBAM", lambda L, **k: L.CBAM(16, ratio=8, kernel_size=5, **k)),
]


@pytest.mark.parametrize("name,build", BLOCKS, ids=[b[0] for b in BLOCKS])
def test_rs_blocks_match_jax(rng, name, build):
    jm = build(JL)
    _random_bn(jm, rng)
    tm = build(TL, device="cpu")
    load_jax_params(tm, _flat(jm))
    c = 16 if "Attention" in name or name == "CBAM" else 6
    x = _x(rng, 9, c)
    want = jm(jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    _close(got, want)


def test_maxpool2x2_matches_jax(rng):
    x = _x(rng, 9, 4)
    want = JL.MaxPool2x2()(jnp.asarray(x))
    got = TL.MaxPool2x2()(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -------------------------------------------------------------------- BIT
def _bit_pair(rng, dim, heads=8, dec_depth=2):
    kw = dict(token_len=4, dim=dim, enc_depth=1, dec_depth=dec_depth,
              heads=heads)
    jm = JCD.BIT(3, 2, **kw)
    _random_bn(jm, rng)
    tm = TCD.BIT(3, 2, device="cpu", **kw)
    load_jax_params(tm, _flat(jm))
    return jm, tm.eval()


@pytest.mark.parametrize("dim", [32, 16], ids=["d4", "d2"])
def test_bit_matches_jax(rng, dim):
    """At D = 4 (BIT's published width) and D = 2: the CPU takes the flash
    wrapper's plain version at any head dim."""
    jm, tm = _bit_pair(rng, dim)
    x1, x2 = _x(rng), _x(rng)
    want = jm(jnp.asarray(x1), jnp.asarray(x2))
    with torch.no_grad():
        got = tm(torch.from_numpy(x1), torch.from_numpy(x2))
    assert got.shape == (2, 64, 64, 2)
    _close(got, want)


def test_bit_stages_match_jax(rng):
    """The stride-8 features, the semantic tokens (a softmax over the
    pixels) and one encoder layer, each on the same input."""
    jm, tm = _bit_pair(rng, 32)
    x = _x(rng)
    jf = jm._features(jnp.asarray(x))
    with torch.no_grad():
        tf = tm._features(torch.from_numpy(x))
        _close(tf, jf)
        f = np.array(jf)
        _close(tm._tokens(torch.from_numpy(f)), jm._tokens(jf))
        tok = rng.normal(size=(2, 8, 32)).astype(np.float32)
        _close(tm.encoder[0](torch.from_numpy(tok)),
               jm.encoder[0](jnp.asarray(tok)))
        seq = rng.normal(size=(2, 64, 32)).astype(np.float32)
        _close(tm.decoder[1](torch.from_numpy(seq), torch.from_numpy(tok)),
               jm.decoder[1](jnp.asarray(seq), jnp.asarray(tok)))


def test_bit_matches_the_torch_twin(rng):
    """``TBIT`` (a torch twin of the reference, width 16) through the JAX
    model into the port."""
    from tests.test_parity_zoo import _randomize_bn
    from tests.test_parity_zoo2 import TBIT
    from tlxcv_tpu.utils.convert import convert_by_order

    jm = JCD.BIT(3, 2, token_len=4, dim=16, enc_depth=1, dec_depth=2)
    twin = TBIT().eval()
    _randomize_bn(twin)
    assert not convert_by_order(
        {k: v.detach().numpy() for k, v in twin.state_dict().items()}, jm,
        source="torch")
    tm = TCD.BIT(3, 2, token_len=4, dim=16, enc_depth=1, dec_depth=2,
                 device="cpu")
    load_jax_params(tm, _flat(jm))
    x1, x2 = _x(rng), _x(rng)
    with torch.no_grad():
        want = twin(torch.from_numpy(x1).permute(0, 3, 1, 2),
                    torch.from_numpy(x2).permute(0, 3, 1, 2))
        got = tm.eval()(torch.from_numpy(x1), torch.from_numpy(x2))
    np.testing.assert_allclose(got.numpy(), want.permute(0, 2, 3, 1).numpy(),
                               atol=5e-4, rtol=5e-4)
    out, _ = pure(jm)(*split(jm), jnp.asarray(x1), jnp.asarray(x2))
    _close(got, out)


def test_bit_from_the_registry(rng):
    tm = create_model("bit", device="cpu").eval()
    assert type(tm).__name__ == "BIT" and len(tm.decoder) == 8
    assert tm.encoder[0].attn.head_dim == 4
    assert tm.decoder[0].attn.head_dim == 4
    with torch.no_grad():
        out = tm(torch.randn(1, 32, 32, 3), torch.randn(1, 32, 32, 3))
    assert out.shape == (1, 32, 32, 2) and bool(torch.isfinite(out).all())


# ------------------------------------------- flash attention at small D
@pytest.mark.parametrize("d", [2, 4, 6, 24])
def test_flash_plain_matches_pallas_at_padded_head_dims(rng, d):
    """Head dims the card pads: the plain path, which CPU tensors take,
    against the TPU kernel (which pads D to 128 lanes itself)."""
    q, k, v = (rng.normal(size=(6, 40, d)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), block_q=32, block_k=32,
                                interpret=True))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("d", [2, 4, 6])
def test_zero_padding_the_head_dim_is_exact_in_the_plain_path(rng, d):
    """What the card's wrapper does (zero columns up to the kernel's head
    dim, the scale of the real D, the output sliced back) computes the
    same function: checked in float64 with the plain version."""
    q, k, v = (torch.from_numpy(rng.normal(size=(4, 2, 33, d)))
               for _ in range(3))
    k, v = k[:, :, :7], v[:, :, :7]
    dp = padded_head_dim(d)
    pad = [torch.nn.functional.pad(t, (0, dp - d)) for t in (q, k, v)]
    want = flash_attention_plain(q, k, v)
    got = flash_attention_plain(*pad, scale=d ** -0.5)[..., :d]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


def test_padded_head_dims():
    assert [padded_head_dim(d) for d in (1, 2, 4, 31, 32, 33, 64, 65, 96,
                                         97, 128)] == [
        32, 32, 32, 32, 32, 64, 64, 96, 96, 128, 128]
    with pytest.raises(ValueError, match="128"):
        padded_head_dim(129)
