"""The port's bf16 GEMM against the JAX package's on the CPU: the demo
probe's Pallas ``bf16_matmul`` (demo/image_classification/
probe_int8_pallas.py:86) run in TPU interpret mode against
``bf16_matmul_plain``, the wrapper's contract, and the port of the probe
at a reduced size."""
import importlib.util
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tlxcv_tpu_torch.demo.image_classification import probe_int8_gemm
from tlxcv_tpu_torch.ops.cuda.matmul import (bf16_matmul, bf16_matmul_plain,
                                             int8_matmul)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def reference():
    """The reference probe, loaded from its file (demo/ is no package)."""
    path = ROOT / "demo" / "image_classification" / "probe_int8_pallas.py"
    spec = importlib.util.spec_from_file_location("probe_int8_pallas", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_bf16(reference, a, b, block=128):
    with pltpu.force_tpu_interpret_mode():
        out = reference.bf16_matmul(jnp.asarray(a, jnp.bfloat16),
                                    jnp.asarray(b, jnp.bfloat16),
                                    block_m=block, block_n=block,
                                    block_k=block)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


def bf16_ulp(x):
    """The spacing of bf16 values at |x| (8 significant bits)."""
    x = x.abs().float().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(x)) - 7)


def reorder_bound(a, b):
    """How far two f32 sums of the same K products may lie apart when they
    are taken in different orders: 2 (K - 1) 2^-24 sum_k |a_ik b_kj|."""
    k = a.shape[1]
    return 2 * (k - 1) * 2.0 ** -24 * (a.float().abs() @ b.float().abs())


@pytest.mark.parametrize("m,k,n", [(512, 1024, 512), (256, 384, 128)])
def test_plain_matches_the_pallas_kernel_in_interpret_mode(reference, m, k,
                                                           n):
    """Blocks of 128, so 512 x 1024 x 512 runs a 4 x 4 x 8 grid.  Both sum
    the products in f32 and round to bf16 once, in other orders: each
    element within one bf16 ulp of the larger of the two results, plus how
    far the two f32 sums may lie apart (``reorder_bound``, a few 1e-5 of a
    result here, which exceeds one ulp only for results near zero)."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(
        torch.bfloat16)
    b = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)).to(
        torch.bfloat16)
    want = _reference_bf16(reference, a.float().numpy(), b.float().numpy())
    got = bf16_matmul_plain(a, b)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    got = got.float()
    tol = bf16_ulp(torch.maximum(got.abs(), want.abs())) + reorder_bound(a, b)
    assert bool(((got - want).abs() <= tol).all())
    assert float((got - want).abs().max()) <= \
        float(bf16_ulp(want.abs().max()))


def test_plain_equals_the_pallas_kernel_on_exact_sums(reference):
    """Integer operands in [-8, 8]: every product and partial sum is an
    integer below 2^24, exact in f32 in any order, so the two agree
    bitwise."""
    rng = np.random.default_rng(1)
    a = rng.integers(-8, 9, size=(256, 512)).astype(np.float32)
    b = rng.integers(-8, 9, size=(512, 256)).astype(np.float32)
    want = _reference_bf16(reference, a, b)
    got = bf16_matmul_plain(torch.from_numpy(a).to(torch.bfloat16),
                            torch.from_numpy(b).to(torch.bfloat16))
    torch.testing.assert_close(got.float(), want, rtol=0, atol=0)


@pytest.mark.parametrize("fn", [bf16_matmul, bf16_matmul_plain])
def test_bf16_matmul_rejects_what_its_reference_rejects(fn):
    a = torch.zeros(8, 16, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        fn(a.float(), a.t())
    with pytest.raises(TypeError):
        fn(a, a.t().half())
    with pytest.raises(ValueError):
        fn(a, torch.zeros(15, 4, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        fn(a[0], a.t())


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper is its plain version, ragged shapes included,
    and counts no kernel launch."""
    g = torch.Generator().manual_seed(0)
    before = bf16_matmul.launches
    for m, k, n in ((1000, 520, 1000), (1, 37, 9), (33, 7, 1)):
        a = torch.randn(m, k, generator=g).to(torch.bfloat16)
        b = torch.randn(k, n, generator=g).to(torch.bfloat16)
        torch.testing.assert_close(bf16_matmul(a, b), bf16_matmul_plain(a, b),
                                   rtol=0, atol=0)
    assert bf16_matmul.launches == before


def test_probe_runs_end_to_end_on_the_cpu(tmp_path):
    """The GEMM probe at a reduced size: every rate present and positive,
    its JSON line written to --out, no launch counted on the CPU."""
    before = (bf16_matmul.launches, int8_matmul.launches)
    out = tmp_path / "probe.json"
    result = probe_int8_gemm.main(["--device", "cpu", "--n", "256",
                                   "--m-1x1", "512", "--reps", "1",
                                   "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(result))
    assert result["device"] == "cpu"
    keys = ("cuda_dot_int8", "torch_int_mm_dot_int8", "cuda_dot_bf16",
            "torch_matmul_bf16", "cuda_1x1dot_int8",
            "torch_int_mm_1x1dot_int8")
    assert all(result[k] > 0 for k in keys)
    assert set(result["ms"]) == set(keys)
    assert (bf16_matmul.launches, int8_matmul.launches) == before
    direct = probe_int8_gemm.run(device="cpu", n=256, m_1x1=512, reps=1)
    assert set(keys) <= set(direct)
