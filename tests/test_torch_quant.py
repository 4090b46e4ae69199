"""The port's int8 serving slice against the JAX package on the CPU: the
int8 GEMM's plain version against the Pallas kernel in interpret mode, the
int8 Conv2d and Linear against the reference's ``_int8_call`` (int32 sums
exact), and ``ops.quant`` on bridged ResNets."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from tlxcv_tpu import nn as jnn
from tlxcv_tpu.core import pure, split
from tlxcv_tpu.core.module import Param
from tlxcv_tpu.models.classification import resnet as JR
from tlxcv_tpu.ops import quant as JQ
from tlxcv_tpu.ops.pallas.matmul import int8_matmul as jax_int8_matmul
from tlxcv_tpu_torch import create_model
from tlxcv_tpu_torch.nn import layers as T
from tlxcv_tpu_torch.ops import quant as TQ
from tlxcv_tpu_torch.ops.cuda.matmul import (int8_matmul, int8_matmul_nt,
                                             int8_matmul_plain, pad_k)
from tlxcv_tpu_torch.utils import load_jax_params


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: these micro models' small ops gain nothing
    from more, and several test processes share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _flat(jax_module):
    params, state = split(jax_module)
    return {k: np.asarray(v) for k, v in {**params, **state}.items()}


def _marks(jax_model):
    """The quantization marks that split() does not carry."""
    out = {}
    for path, mod in jax_model.modules():
        attrs = {k: getattr(mod, k) for k in ("relu_fused", "_folded")
                 if hasattr(mod, k)}
        if attrs:
            out[path] = attrs
    return out


def _codes(rng, *shape):
    return rng.integers(-127, 128, size=shape).astype(np.int8)


# ------------------------------------------------------------ the kernel
@pytest.mark.parametrize("m,k,n,bm,bn,bk", [
    (256, 256, 256, 128, 128, 128),
    (300, 200, 130, 128, 128, 128),   # padded, uneven
    (512, 1024, 384, 256, 128, 512),  # rectangular blocks
])
def test_int8_matmul_matches_the_pallas_kernel(rng, m, k, n, bm, bn, bk):
    """The reference's own cases (tests/test_pallas_matmul.py), exactly."""
    a, b = _codes(rng, m, k), _codes(rng, k, n)
    want = np.asarray(jax_int8_matmul(jnp.asarray(a), jnp.asarray(b),
                                      block_m=bm, block_n=bn, block_k=bk,
                                      interpret=True))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for got in (int8_matmul_plain(ta, tb), int8_matmul(ta, tb),
                int8_matmul_nt(pad_k(ta), pad_k(tb.t().contiguous()))):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_int8_matmul_extremes_are_exact():
    """K = 4096 at +-127: the largest sums, 4096 * 127**2."""
    a = torch.full((3, 4096), 127, dtype=torch.int8)
    b = torch.full((4096, 5), -127, dtype=torch.int8)
    assert (int8_matmul(a, b) == -4096 * 127 ** 2).all()


@pytest.mark.parametrize("fn", [int8_matmul, int8_matmul_plain])
def test_int8_matmul_rejects_what_the_reference_rejects(fn):
    a = torch.zeros(8, 16, dtype=torch.int8)
    with pytest.raises(TypeError):
        fn(a.float(), a.t())
    with pytest.raises(TypeError):
        fn(a, a.t().to(torch.int32))
    with pytest.raises(ValueError):
        fn(a, torch.zeros(15, 4, dtype=torch.int8))
    with pytest.raises(ValueError):
        int8_matmul_nt(a, torch.zeros(4, 15, dtype=torch.int8))


# --------------------------------------------------------- int8 layers
def _int8_conv_pair(rng, cin, cout, k, stride, pad, dil, fused):
    jc = jnn.Conv2d(cin, cout, k, stride=stride, padding=pad, dilation=dil,
                    bias=True)
    jc.weight.value = jnp.asarray(_codes(rng, k, k, cin, cout))
    jc.bias.value = jnp.asarray(rng.normal(size=cout), jnp.float32)
    jc.w_scale = Param(jnp.asarray(rng.uniform(1e-3, 1e-2, cout),
                                   jnp.float32))
    jc.a_scale = Param(jnp.asarray(0.031, jnp.float32))
    if fused:
        jc.out_scale = Param(jnp.asarray(0.057, jnp.float32))
        jc.relu_fused = True
    tc = T.Conv2d(cin, cout, k, stride=stride, padding=pad, dilation=dil,
                  device="cpu")
    load_jax_params(tc, _flat(jc), marks=_marks(jc))
    return jc, tc


@pytest.mark.parametrize("cin,cout,k,stride,pad,dil,hw", [
    (64, 32, 1, 1, 0, 1, 8),          # 1x1: the input is the patch matrix
    (32, 48, 1, 2, 0, 1, 9),          # 1x1 stride 2 (downsample)
    (16, 24, 3, 2, 1, 1, 9),          # 3x3 stride 2
    (3, 16, 7, 2, 3, 1, 16),          # the 7x7 stem, K = 147 padded
    (8, 8, 3, 2, "SAME", 1, 10),      # lax SAME, odd pixel after
    (8, 16, 3, 1, 2, 2, 9),           # dilation 2
])
@pytest.mark.parametrize("fused", [False, True])
def test_int8_conv_matches_jax(rng, cin, cout, k, stride, pad, dil, hw,
                               fused):
    """f32 in: quantize, int32 sums, f32 out.  int8 in (a fused
    producer's codes), out_scale and a fused ReLU: int8 codes out.  The
    int32 sums are bitwise equal; so are the outputs, since both packages
    run the epilogue's f32 ops one by one in the same order."""
    jc, tc = _int8_conv_pair(rng, cin, cout, k, stride, pad, dil, fused)
    if fused:
        x = _codes(rng, 2, hw, hw, cin)
        xq = x
    else:
        x = rng.normal(size=(2, hw, hw, cin)).astype(np.float32)
        xq = np.array(jnp.clip(jnp.round(jnp.asarray(x) / 0.031), -127,
                               127).astype(jnp.int8))
    acc_jax = lax.conv_general_dilated(
        jnp.asarray(xq), jc.weight.value, window_strides=jc.stride,
        padding=jc.padding, rhs_dilation=jc.dilation,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    cols, (n, ho, wo) = tc._patches(torch.from_numpy(xq))
    acc = int8_matmul_nt(cols, tc.weight).reshape(n, ho, wo, cout)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_jax))

    want = np.asarray(jc(jnp.asarray(x)))
    with torch.no_grad():
        got = tc(torch.from_numpy(x))
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))


@pytest.mark.parametrize("fin,fout", [(64, 10), (40, 24)])  # K padded: 40
def test_int8_linear_matches_jax(rng, fin, fout):
    jl = jnn.Linear(fin, fout)
    jl.weight.value = jnp.asarray(_codes(rng, fin, fout))
    jl.bias.value = jnp.asarray(rng.normal(size=fout), jnp.float32)
    jl.w_scale = Param(jnp.asarray(rng.uniform(1e-3, 1e-2, fout),
                                   jnp.float32))
    jl.a_scale = Param(jnp.asarray(0.02, jnp.float32))
    tl = T.Linear(fin, fout, device="cpu")
    load_jax_params(tl, _flat(jl))
    x = rng.normal(size=(6, fin)).astype(np.float32)
    xq = np.array(jnp.clip(jnp.round(jnp.asarray(x) / 0.02), -127,
                           127).astype(jnp.int8))
    acc_jax = jnp.dot(jnp.asarray(xq), jl.weight.value,
                      preferred_element_type=jnp.int32)
    acc = int8_matmul_nt(pad_k(torch.from_numpy(xq)), tl.weight)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_jax))
    for dtype, tdtype in ((jnp.float32, torch.float32),
                          (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jl(jnp.asarray(x, dtype)), np.float32)
        with torch.no_grad():
            got = tl(torch.from_numpy(x).to(tdtype))
        assert got.dtype == tdtype
        np.testing.assert_array_equal(got.float().numpy(), want)


# ----------------------------------------------------------- ops.quant
def _bridged_resnet(name, rng, **kw):
    jm = getattr(JR, name)(**kw)
    for _, mod in jm.modules():
        if isinstance(mod, jnn.BatchNorm):
            c = mod.running_mean.value.shape[0]
            mod.running_mean.value = jnp.asarray(
                rng.normal(scale=0.2, size=(c,)), jnp.float32)
            mod.running_var.value = jnp.asarray(
                rng.uniform(0.5, 2.0, size=(c,)), jnp.float32)
    tm = create_model(name, device="cpu", **kw)
    load_jax_params(tm, _flat(jm))
    return jm, tm.eval()


def _int8_layers(model, sep):
    for path, mod in (model.modules() if sep == "/"
                      else model.named_modules()):
        w = getattr(mod, "weight", None)
        w = getattr(w, "value", w)
        if w is not None and w.dtype in (jnp.int8, torch.int8):
            yield path.replace(sep, "/"), mod


def test_weight_only_int8_matches_jax(rng):
    jm, tm = _bridged_resnet("resnet18", rng, num_classes=10)
    assert JQ.quantize_weights(jm) == TQ.quantize_weights(tm) == 21
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    want, _ = pure(jm)(*split(jm), jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-4)
    want_check = JQ.dequantize_check(jm)
    got_check = {p.replace(".", "/"): v
                 for p, v in TQ.dequantize_check(tm).items()}
    assert got_check == pytest.approx(want_check, rel=1e-6)


def test_quantize_for_serving_matches_jax(rng):
    """The same bridged resnet18 through both pipelines: the reference's
    counts and fused edges (tests/test_quant.py), identical int8 codes,
    and scales within 1e-5 relative: the calibration forwards run float
    convs whose sums XLA and torch order differently, and that f32 noise
    compounds through the net (2.1e-6 measured at layer4's input)."""
    jm, tm = _bridged_resnet("resnet18", rng, num_classes=10)
    x = rng.normal(size=(4, 64, 64, 3)).astype(np.float32)
    counts = JQ.quantize_for_serving(jm, [x[:2]])
    assert counts == TQ.quantize_for_serving(tm, [x[:2]]) == (20, 21, 21, 8)
    fused = {p for p, m in _int8_layers(jm, "/")
             if getattr(m, "out_scale", None) is not None}
    assert fused == {p for p, m in _int8_layers(tm, ".")
                     if getattr(m, "out_scale", None) is not None}
    assert len(fused) == 8
    jlayers = dict(_int8_layers(jm, "/"))
    for path, tmod in _int8_layers(tm, "."):
        jmod = jlayers[path]
        if isinstance(tmod, T.Conv2d):
            codes = tmod._unpacked().permute(2, 3, 1, 0)  # -> HWIO
        else:
            codes = tmod.weight[:, :tmod.in_features].t()
        np.testing.assert_array_equal(codes.numpy(),
                                      np.asarray(jmod.weight.value), path)
        assert getattr(tmod, "relu_fused", False) == \
            getattr(jmod, "relu_fused", False)
        for name in ("w_scale", "a_scale", "out_scale"):
            if getattr(jmod, name, None) is None:
                assert getattr(tmod, name, None) is None
                continue
            np.testing.assert_allclose(getattr(tmod, name).numpy(),
                                       np.asarray(getattr(jmod, name).value),
                                       rtol=1e-5, err_msg=f"{path}.{name}")


def test_jax_quantized_resnet50_carried_across(rng):
    """resnet50 at full width, quantized by the JAX package and copied by
    the bridge with its marks.  Every int32 sum and every elementwise op
    of the two graphs agree bitwise up to the global pool; the pool's f32
    mean is summed in another order, which can move the fc's input across
    a rounding boundary of its quantizer.  Each such code changes a logit
    by at most a_scale * max|w_scale * w| = a_scale * 127 * max w_scale;
    the bound allows four of them."""
    jm, _ = _bridged_resnet("resnet50", rng)
    calib = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    assert JQ.quantize_for_serving(jm, [calib]) == (53, 54, 54, 32)
    tm = create_model("resnet50", device="cpu").eval()
    load_jax_params(tm, _flat(jm), marks=_marks(jm))
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    want, _ = pure(jm)(*split(jm), jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    fc = tm.fc
    step = float(fc.a_scale * 127 * fc.w_scale.max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=4 * step)


def test_fold_batchnorm_rolls_back_on_failure(rng):
    """A failed check leaves the model exactly as it was; a second fold
    then succeeds and keeps the float output within 1e-3 relative."""
    _, tm = _bridged_resnet("resnet18", rng, num_classes=10)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    with torch.no_grad():
        ref = tm(torch.from_numpy(x))
    with pytest.raises(ValueError, match="model restored"):
        TQ.fold_batchnorm(tm, x, tol=-1.0)
    after = tm.state_dict()
    assert set(after) == set(before)
    for k in before:
        torch.testing.assert_close(after[k], before[k], rtol=0, atol=0)
    assert TQ.fold_batchnorm(tm, x) == 20
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert float((out - ref).abs().max()) < 1e-3 * float(ref.abs().max())
