"""The int8 GEMM's fused epilogue on the CPU: ``int8_matmul_requant_plain``
(the int32 product followed by ``requantize``, the reference's epilogue in
its op order) against the JAX package's int8 ``Conv2d`` and ``Linear``
(``tlxcv_tpu/nn/layers.py:220-262``, ``:363``), with the weights carried
across by ``utils.bridge``; and the wrapper's contract.  The int8 codes and
the float outputs are held bitwise, as ``tests/test_torch_quant.py`` holds
the int8 layers: both packages run the epilogue's f32 operations one by one
in the same order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlxcv_tpu import nn as jnn
from tlxcv_tpu.core import split
from tlxcv_tpu.core.module import Param
from tlxcv_tpu_torch.nn import layers as T
from tlxcv_tpu_torch.ops.cuda.matmul import (int8_matmul_requant,
                                             int8_matmul_requant_plain, pad_k)
from tlxcv_tpu_torch.utils import load_jax_params

A_SCALE, OUT_SCALE = 0.031, 0.057


def _flat(jax_module):
    params, state = split(jax_module)
    return {k: np.asarray(v) for k, v in {**params, **state}.items()}


def _codes(rng, *shape):
    return rng.integers(-127, 128, size=shape).astype(np.int8)


def _conv_pair(rng, cin, cout, k, stride, pad, bias, out_scale, relu):
    jc = jnn.Conv2d(cin, cout, k, stride=stride, padding=pad, bias=bias)
    jc.weight.value = jnp.asarray(_codes(rng, k, k, cin, cout))
    if bias:
        jc.bias.value = jnp.asarray(rng.normal(size=cout), jnp.float32)
    jc.w_scale = Param(jnp.asarray(rng.uniform(1e-3, 1e-2, cout),
                                   jnp.float32))
    jc.a_scale = Param(jnp.asarray(A_SCALE, jnp.float32))
    marks = {}
    if out_scale:
        jc.out_scale = Param(jnp.asarray(OUT_SCALE, jnp.float32))
        jc.relu_fused = relu
        marks = {"": {"relu_fused": relu}}
    tc = T.Conv2d(cin, cout, k, stride=stride, padding=pad, bias=bias,
                  device="cpu")
    load_jax_params(tc, _flat(jc), marks=marks)
    return jc, tc


def _epilogue(mod, out_dtype):
    out_scale = getattr(mod, "out_scale", None)
    return {"scale": mod.a_scale * mod.w_scale, "bias": mod.bias,
            "relu": out_scale is not None and getattr(mod, "relu_fused",
                                                      False),
            "out_scale": out_scale, "out_dtype": out_dtype}


# (name, cin, cout, k, stride, pad, hw, batch): M = batch * Ho * Wo is
# ragged against the kernel's 128-row tiles in every case
_CONVS = [
    ("3x3_cout15", 8, 15, 3, 1, 1, 7, 3),         # M = 147, odd N
    ("3x3_s2_cout15", 16, 15, 3, 2, 1, 9, 2),     # M = 50
    ("1x1_cout33", 32, 33, 1, 1, 0, 5, 3),        # M = 75, Kp = K
    ("7x7_s2_cout17", 3, 17, 7, 2, 3, 11, 1),     # K = 147 padded to 160
]
# (input, out_scale, relu_fused): int8 codes in (a fused producer's) with
# out_scale, with and without the fused ReLU; float in without out_scale,
# f32 and bf16; int8 in without out_scale (bf16 out)
_MODES = [("int8", True, True), ("int8", True, False), ("f32", True, True),
          ("f32", False, False), ("bf16", False, False),
          ("int8", False, False)]


@pytest.mark.parametrize("name,cin,cout,k,stride,pad,hw,batch", _CONVS,
                         ids=[c[0] for c in _CONVS])
@pytest.mark.parametrize("inp,out_scale,relu", _MODES,
                         ids=["_".join(map(str, m)) for m in _MODES])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_requant_plain_matches_the_jax_int8_conv(
        rng, name, cin, cout, k, stride, pad, hw, batch, inp, out_scale,
        relu, bias):
    jc, tc = _conv_pair(rng, cin, cout, k, stride, pad, bias, out_scale,
                        relu)
    if inp == "int8":
        x = _codes(rng, batch, hw, hw, cin)
        xq = torch.from_numpy(x)
        jx, tx = jnp.asarray(x), xq
    else:
        x = rng.normal(size=(batch, hw, hw, cin)).astype(np.float32)
        jdt = jnp.float32 if inp == "f32" else jnp.bfloat16
        tdt = torch.float32 if inp == "f32" else torch.bfloat16
        jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
        xq = T._quantize_input(tx, tc.a_scale)
    want = np.asarray(jc(jx))
    out_dtype = tx.dtype if tx.is_floating_point() else torch.bfloat16
    cols, (n, ho, wo) = tc._patches(xq)
    with torch.no_grad():
        ep = _epilogue(tc, out_dtype)
        got = int8_matmul_requant_plain(cols, tc.weight, **ep)
        wrapped = int8_matmul_requant(cols, tc.weight, **ep)
        layer = tc(tx)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    assert torch.equal(got, wrapped)
    got = got.reshape(n, ho, wo, cout)
    assert torch.equal(got, layer)
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))


@pytest.mark.parametrize("fin,fout,rows", [(64, 10, 6), (40, 25, 129)])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_requant_plain_matches_the_jax_int8_linear(rng, fin, fout, rows,
                                                   bias):
    jl = jnn.Linear(fin, fout, bias=bias)
    jl.weight.value = jnp.asarray(_codes(rng, fin, fout))
    if bias:
        jl.bias.value = jnp.asarray(rng.normal(size=fout), jnp.float32)
    jl.w_scale = Param(jnp.asarray(rng.uniform(1e-3, 1e-2, fout),
                                   jnp.float32))
    jl.a_scale = Param(jnp.asarray(0.02, jnp.float32))
    tl = T.Linear(fin, fout, bias=bias, device="cpu")
    load_jax_params(tl, _flat(jl))
    x = rng.normal(size=(rows, fin)).astype(np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jl(jnp.asarray(x, jdt)), np.float32)
        tx = torch.from_numpy(x).to(tdt)
        xq = pad_k(T._quantize_input(tx, tl.a_scale))
        with torch.no_grad():
            got = int8_matmul_requant_plain(xq, tl.weight,
                                            **_epilogue(tl, tdt))
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), want)


def _operands(n=5, k=32, m=3):
    g = torch.Generator().manual_seed(0)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    return a, w, torch.rand(n, generator=g) * 1e-3


@pytest.mark.parametrize("fn", [int8_matmul_requant,
                                int8_matmul_requant_plain])
def test_requant_rejects_what_it_does_not_take(fn):
    a, w, scale = _operands()
    with pytest.raises(TypeError):  # float operands
        fn(a.float(), w, scale)
    with pytest.raises(ValueError):  # K mismatch
        fn(a, w[:, :16], scale)
    with pytest.raises(TypeError):  # scale not f32
        fn(a, w, scale.double())
    with pytest.raises(TypeError):  # scale not [N]
        fn(a, w, scale[:4])
    with pytest.raises(TypeError):  # bias not [N]
        fn(a, w, scale, bias=torch.zeros(4))
    with pytest.raises(TypeError):  # out_scale not one f32
        fn(a, w, scale, out_scale=torch.ones(2))
    with pytest.raises(TypeError):  # no float output dtype
        fn(a, w, scale, out_dtype=torch.int32)


@pytest.mark.parametrize("fn", [int8_matmul_requant,
                                int8_matmul_requant_plain])
def test_requant_on_the_cpu_is_differentiable(fn):
    """On the CPU both run the plain arithmetic, which autograd records:
    the f32 output's gradient reaches ``scale`` (the column sums of the
    int32 product) and ``bias`` (one per row).  Only the card's kernel,
    which has no backward, refuses such inputs (tests/test_torch_cuda.py)."""
    a, w, scale = _operands()
    scale = scale.clone().requires_grad_()
    bias = torch.nn.Parameter(torch.zeros(5))
    fn(a, w, scale, bias=bias).sum().backward()
    acc = a.int() @ w.int().t()
    assert torch.equal(scale.grad, acc.sum(0).float())
    assert torch.equal(bias.grad, torch.full((5,), float(a.shape[0])))
    with torch.inference_mode():
        y = fn(a, w, scale.detach(), bias=bias)
    assert torch.equal(y, acc.float() * scale.detach())


def test_requant_int8_out_rounds_half_to_even_and_clamps():
    """Quotients halfway between integers round to the even one, as
    jnp.round; codes beyond +-127 clamp; the fused ReLU comes before the
    division."""
    a = torch.tensor([[1, 0], [2, 0], [-3, 0], [100, 0], [-100, 0]],
                     dtype=torch.int8)
    w = torch.tensor([[1, 0]], dtype=torch.int8)
    scale = torch.tensor([1.0])
    bias = torch.tensor([0.5])
    half = torch.tensor(1.0)
    got = int8_matmul_requant(pad_k(a), pad_k(w), scale, bias,
                              out_scale=half)
    assert got.flatten().tolist() == [2, 2, -2, 100, -100]
    got = int8_matmul_requant(pad_k(a), pad_k(w), scale * 2, None,
                              relu=True, out_scale=torch.tensor(1.5))
    assert got.flatten().tolist() == [1, 3, 0, 127, 0]
