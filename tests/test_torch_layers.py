"""Port layers (tlxcv_tpu_torch.nn.layers, core.init, utils.bridge) against
the JAX package on the CPU, with weights copied across by the bridge."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlxcv_tpu import nn as jnn
from tlxcv_tpu.core import init as JI
from tlxcv_tpu_torch.core import init as TI
from tlxcv_tpu_torch.nn import layers as T
from tlxcv_tpu_torch.utils import load_jax_params


def _flat(jax_module):
    return {k: np.asarray(v) for k, v in jax_module.state_dict().items()}


def _run_both(jax_layer, torch_layer, x):
    load_jax_params(torch_layer, _flat(jax_layer))
    want = np.asarray(jax_layer(jnp.asarray(x)))
    with torch.no_grad():
        got = torch_layer(torch.from_numpy(x)).numpy()
    return got, want


def test_linear_matches_jax(rng):
    x = rng.normal(size=(3, 5, 24)).astype(np.float32)
    got, want = _run_both(jnn.Linear(24, 40, b_init=lambda s: JI.normal(s)),
                          T.Linear(24, 40, device="cpu"), x)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_linear_bf16_keeps_dtype(rng):
    """bf16 in, bf16 out, bias added after the product in bf16."""
    x = rng.normal(size=(4, 16)).astype(np.float32)
    jl = jnn.Linear(16, 8, b_init=lambda s: JI.normal(s, std=0.5))
    tl = T.Linear(16, 8, device="cpu")
    load_jax_params(tl, _flat(jl))
    want = jl(jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        got = tl(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=3e-2)


@pytest.mark.parametrize("cin,cout,k,stride,pad,hw", [
    (3, 32, 16, 16, 0, 32),       # ViT patch embedding
    (8, 16, 3, 1, 1, 13),         # 3x3, padded
    (4, 8, 3, 2, "SAME", 9),      # lax SAME, odd pixel after
])
def test_conv2d_matches_jax(rng, cin, cout, k, stride, pad, hw):
    x = rng.normal(size=(2, hw, hw, cin)).astype(np.float32)
    got, want = _run_both(
        jnn.Conv2d(cin, cout, k, stride=stride, padding=pad,
                   b_init=lambda s: JI.normal(s)),
        T.Conv2d(cin, cout, k, stride=stride, padding=pad, device="cpu"), x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_layernorm_matches_jax(rng, eps):
    x = (rng.normal(size=(2, 7, 48)) * 3 + 1.5).astype(np.float32)
    jl = jnn.LayerNorm(48, eps=eps)
    jl.weight.value = jnp.asarray(rng.normal(size=48), jnp.float32)
    jl.bias.value = jnp.asarray(rng.normal(size=48), jnp.float32)
    got, want = _run_both(jl, T.LayerNorm(48, eps=eps, device="cpu"), x)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("weights", ["float32", "bfloat16"])
def test_layernorm_bf16_matches_jax(rng, weights):
    """bf16 input: statistics and affine in f32, output in bf16, with f32
    weights or with weights cast to bf16 (the serving policy)."""
    x = (rng.normal(size=(3, 9, 64)) * 4 + 2).astype(np.float32)
    jl = jnn.LayerNorm(64, eps=1e-6)
    jl.weight.value = jnp.asarray(rng.normal(size=64), weights)
    jl.bias.value = jnp.asarray(rng.normal(size=64), weights)
    tl = T.LayerNorm(64, eps=1e-6, device="cpu").to(getattr(torch, weights))
    load_jax_params(tl, {k: np.asarray(v, np.float32)
                         for k, v in jl.state_dict().items()})
    want = jl(jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        got = tl(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    # the f32 results differ in their last bits, so the bf16 outputs may
    # round apart by one bf16 ulp: at most 2**-7 relative
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2 ** -7,
                               atol=1e-6)


@pytest.mark.parametrize("name", sorted(T._ACTS))
def test_activations_match_jax(name):
    x = np.linspace(-6, 6, 241, dtype=np.float32)
    want = np.asarray(jnn.get_activation(name)(jnp.asarray(x)))
    got = T.get_activation(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_gelu_is_the_tanh_approximation():
    """jax.nn.gelu defaults to approximate=True; torch's default is exact
    and differs by more than the tolerance above."""
    x = torch.linspace(-6, 6, 241)
    exact = torch.nn.functional.gelu(x)
    assert (T.get_activation("gelu")(x) - exact).abs().max() > 1e-4
    with pytest.raises(ValueError):
        T.get_activation("no_such_act")


@pytest.mark.parametrize("cls", [T.Dropout, T.DropPath])
def test_dropout_identity_in_eval(cls):
    layer = cls(0.5).eval()
    x = torch.randn(4, 6, 8)
    assert layer(x) is x


@pytest.mark.parametrize("cls", [T.Dropout, T.DropPath])
def test_dropout_deterministic_under_generator(cls):
    x = torch.randn(16, 6, 8) + 3.0
    outs = []
    for seed in (7, 7, 8):
        layer = cls(0.5, generator=torch.Generator().manual_seed(seed))
        outs.append(layer.train()(x))
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    kept = outs[0] != 0
    torch.testing.assert_close(outs[0][kept], (x / 0.5)[kept])
    assert 0 < kept.float().mean() < 1
    if cls is T.DropPath:  # whole samples are kept or dropped
        assert all(k.all() or not k.any() for k in kept)


def test_int8_weight_not_ported():
    """int8 Linear and Conv2d run (tests/test_torch_quant.py), and so does
    a grouped int8 conv (ResNeXt) on the full-int8 path (the name is kept
    from when this test checked its refusal): with all-one codes and inputs each output counts the taps of
    its group's window that lie inside the image."""
    layer = T.Linear(4, 4, device="cpu")
    layer.load_int8(torch.ones(4, 4, dtype=torch.int8), torch.ones(4))
    assert layer(torch.ones(2, 4)).tolist() == [[4.0] * 4] * 2
    conv = T.Conv2d(8, 8, 3, padding=1, groups=2, bias=False, device="cpu")
    conv.load_int8(torch.ones(8, 4, 3, 3, dtype=torch.int8), torch.ones(8))
    T.set_quant_attr(conv, "a_scale", 1.0)
    y = conv(torch.ones(1, 5, 5, 8))
    inside = torch.tensor([2.0, 3, 3, 3, 2])
    want = 4 * inside[:, None] * inside[None, :]
    assert torch.equal(y, want[None, :, :, None].expand(1, 5, 5, 8))


def test_bridge_raises_on_unmatched_key():
    jl = jnn.Linear(4, 3)
    flat = _flat(jl)
    flat["extra/weight"] = np.zeros((4, 3), np.float32)
    with pytest.raises(KeyError):
        load_jax_params(T.Linear(4, 3, device="cpu"), flat)


def test_bridge_raises_on_uncovered_parameter():
    flat = _flat(jnn.Linear(4, 3))
    del flat["bias"]
    with pytest.raises(KeyError):
        load_jax_params(T.Linear(4, 3, device="cpu"), flat)
    with pytest.raises(ValueError):  # a shape that does not fit
        load_jax_params(T.Linear(4, 5, device="cpu"), _flat(jnn.Linear(4, 3)))


@pytest.mark.parametrize("port_shape,jax_shape", [
    ((40, 24), (24, 40)),               # dense: (out, in) vs (in, out)
    ((32, 3, 16, 16), (16, 16, 3, 32)), # conv: OIHW vs HWIO
])
def test_init_fan_rules_follow_layout(port_shape, jax_shape):
    assert TI._fan(port_shape) == JI._fan(jax_shape)


def test_truncated_normal_resamples_at_two_std():
    g = torch.Generator().manual_seed(0)
    x = TI.truncated_normal((200, 300), std=0.5, mean=1.0, generator=g)
    assert (x - 1.0).abs().max() <= 1.0
    assert abs(float(x.std()) - 0.5 * 0.8796) < 0.01  # std of N(0,1) | <2
    again = TI.truncated_normal((200, 300), std=0.5, mean=1.0,
                                generator=torch.Generator().manual_seed(0))
    assert torch.equal(x, again)


def test_initial_weights_follow_the_generator():
    def build(seed):
        return T.Linear(8, 8, device="cpu",
                        generator=torch.Generator().manual_seed(seed)
                        ).weight.detach()

    assert torch.equal(build(1), build(1))
    assert not torch.equal(build(1), build(2))
    bound = np.sqrt(3.0 / 8)  # kaiming_uniform, nonlinearity="linear"
    assert float(build(1).abs().max()) <= bound
    assert jax.default_backend() == "cpu"
