"""The port's grouped full-int8 Conv2d and int8 ViT against the JAX package
on the CPU.

Tolerances: the grouped conv is bitwise, as
``tests/test_torch_quant.py::test_int8_conv_matches_jax`` holds the
ungrouped one (exact int32 sums per group, the epilogue's f32 ops one by
one in the same order).  The int8 ViT runs float LayerNorm, GELU and
attention between its int8 layers, whose f32 sums the two frameworks
order differently: logits within 2e-4 of their largest magnitude, as
``tests/test_parity_resnet.py`` bounds f32 modules (measured: about 1e-7
of it).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from tlxcv_tpu import nn as jnn
from tlxcv_tpu.core import pure, split
from tlxcv_tpu.core.module import Param
from tlxcv_tpu.models.classification import vision_transformer as JV
from tlxcv_tpu.ops import quant as JQ
from tlxcv_tpu_torch.models.classification import vision_transformer as TV
from tlxcv_tpu_torch.nn import layers as T
from tlxcv_tpu_torch.ops import quant as TQ
from tlxcv_tpu_torch.ops.cuda.matmul import int8_matmul
from tlxcv_tpu_torch.utils import load_jax_params


def _flat(jax_module):
    params, state = split(jax_module)
    return {k: np.asarray(v) for k, v in {**params, **state}.items()}


def _codes(rng, *shape):
    return rng.integers(-127, 128, size=shape).astype(np.int8)


# ------------------------------------------------------- grouped int8 conv
def _grouped_pair(rng, cin, cout, k, stride, groups, fused):
    jc = jnn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                    groups=groups, bias=True)
    jc.weight.value = jnp.asarray(_codes(rng, k, k, cin // groups, cout))
    jc.bias.value = jnp.asarray(rng.normal(size=cout), jnp.float32)
    jc.w_scale = Param(jnp.asarray(rng.uniform(1e-3, 1e-2, cout),
                                   jnp.float32))
    jc.a_scale = Param(jnp.asarray(0.031, jnp.float32))
    marks = {}
    if fused:
        jc.out_scale = Param(jnp.asarray(0.057, jnp.float32))
        jc.relu_fused = True
        marks = {"": {"relu_fused": True}}
    tc = T.Conv2d(cin, cout, k, stride=stride, padding=k // 2, groups=groups,
                  device="cpu")
    load_jax_params(tc, _flat(jc), marks=marks)
    return jc, tc


@pytest.mark.parametrize("groups,cin,cout,k,stride", [
    (2, 8, 12, 3, 1),
    (4, 16, 8, 3, 2),
    (4, 16, 16, 1, 1),       # 1x1: K = 4 per group, padded to 16
    (32, 128, 128, 3, 1),    # ResNeXt-50's conv2 width, 4 channels a group
])
@pytest.mark.parametrize("fused", [False, True])
def test_grouped_int8_conv_matches_jax(rng, groups, cin, cout, k, stride,
                                       fused):
    """f32 in: quantize, int32 sums per group, f32 out.  int8 in (a fused
    producer's codes), out_scale and a fused ReLU: int8 codes out.  The
    int32 sums of each group and the outputs are bitwise equal; one GEMM
    call per group (counted on the card only)."""
    jc, tc = _grouped_pair(rng, cin, cout, k, stride, groups, fused)
    hw = 7
    if fused:
        x = _codes(rng, 2, hw, hw, cin)
        xq = x
    else:
        x = rng.normal(size=(2, hw, hw, cin)).astype(np.float32)
        xq = np.array(jnp.clip(jnp.round(jnp.asarray(x) / 0.031), -127,
                               127).astype(jnp.int8))
    acc_jax = np.asarray(lax.conv_general_dilated(
        jnp.asarray(xq), jc.weight.value, window_strides=jc.stride,
        padding=jc.padding, dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups, preferred_element_type=jnp.int32))
    cols, (n, ho, wo) = tc._group_patches(torch.from_numpy(xq))
    og = cout // groups
    assert cols.shape[0] == groups and cols.shape[2] % 16 == 0
    for j in range(groups):
        acc = int8_matmul(cols[j], tc.weight[j * og:(j + 1) * og].t())
        np.testing.assert_array_equal(
            acc.reshape(n, ho, wo, og).numpy(),
            acc_jax[..., j * og:(j + 1) * og])

    want = np.asarray(jc(jnp.asarray(x)))
    before = int8_matmul.launches
    with torch.no_grad():
        got = tc(torch.from_numpy(x))
    assert int8_matmul.launches == before  # CPU tensors launch nothing
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))


def test_grouped_int8_conv_weight_only_matches_jax(rng):
    """Without a_scale the grouped int8 weight is dequantized and the conv
    runs in float, as in the reference."""
    jc, tc = _grouped_pair(rng, 8, 8, 3, 1, 4, False)
    del jc.a_scale
    del tc.a_scale
    x = rng.normal(size=(2, 6, 6, 8)).astype(np.float32)
    want = np.asarray(jc(jnp.asarray(x)))
    with torch.no_grad():
        got = tc(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-4 * np.abs(want).max())


# ----------------------------------------------------------------- int8 ViT
CFG = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4,
           num_classes=10, qkv_bias=True)


def _int8_pair(rng):
    """A micro ViT in both packages with the same float weights, each
    quantized by its own package as ``bench.py``'s ViT-B/16 int8 leg does
    (quantize_weights, then calibrate_activations on 4 images)."""
    jm = JV.VisionTransformer(**CFG)
    tm = TV.VisionTransformer(**CFG, device="cpu")
    load_jax_params(tm, _flat(jm))
    tm.eval()
    calib = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    assert JQ.quantize_weights(jm) == TQ.quantize_weights(tm) == 10
    assert JQ.calibrate_activations(jm, [calib]) == \
        TQ.calibrate_activations(tm, [calib]) == 10
    return jm, tm


def _logits(jm, x):
    out, _ = pure(jm)(*split(jm), jnp.asarray(x))
    return np.asarray(out)


def test_int8_vit_matches_jax(rng):
    """10 int8 layers (2 x 4 block Linears, the head, the patch conv), the
    same codes and scales in both, the logits within the bound."""
    jm, tm = _int8_pair(rng)
    jlayers = {p: m for p, m in jm.modules()
               if getattr(getattr(m, "weight", None), "value", None)
               is not None and m.weight.value.dtype == jnp.int8}
    tlayers = {p.replace(".", "/"): m for p, m in tm.named_modules()
               if isinstance(m, (T.Conv2d, T.Linear))}
    assert sorted(jlayers) == sorted(tlayers)
    for path, jmod in jlayers.items():
        for name in ("w_scale", "a_scale"):
            np.testing.assert_allclose(
                getattr(tlayers[path], name).numpy(),
                np.asarray(getattr(jmod, name).value), rtol=1e-6,
                err_msg=f"{path}.{name}")
    x = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
    want = _logits(jm, x)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-4 * np.abs(want).max())


def test_jax_quantized_vit_carried_across(rng):
    """The micro ViT quantized and calibrated by the JAX package, copied
    into a fresh float port model by the bridge (int8 weights packed,
    w_scale and a_scale attached): the logits within the bound, and with
    the reference's int8 attention switched on in both too."""
    jm, _ = _int8_pair(rng)
    tm = TV.VisionTransformer(**CFG, device="cpu").eval()
    load_jax_params(tm, _flat(jm))
    assert sum(m.weight.dtype == torch.int8 for m in tm.modules()
               if isinstance(m, (T.Conv2d, T.Linear))) == 10
    x = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
    want = _logits(jm, x)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-4 * np.abs(want).max())

    from tlxcv_tpu.nn import attention as JA
    from tlxcv_tpu_torch.nn import attention as TA
    try:
        JA.use_int8_attention(True)
        TA.use_int8_attention(True)
        want8 = _logits(jm, x)
        with torch.no_grad():
            got8 = tm(torch.from_numpy(x)).numpy()
    finally:
        JA.use_int8_attention(False)
        TA.use_int8_attention(False)
    assert not np.array_equal(want8, want)
    np.testing.assert_allclose(got8, want8, rtol=0,
                               atol=2e-4 * np.abs(want8).max())
