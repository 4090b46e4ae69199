"""``utils.export`` and the ``tlxcv`` operators on the CPU.

``export_model`` -> ``save_exported`` -> ``load_exported`` of a micro CNN
in f32, the same network fully int8 (``quantize_weights`` and
``calibrate_activations``: its GEMMs are ``tlxcv::int8_matmul_requant``),
and a micro SSD's ``predict`` (the fixed-trip NMS loop unrolled): exported
at a symbolic batch, served at batches 1, 2 and 3, bitwise equal to the
eager model (on the CPU each operator runs its plain version, as the eager
wrapper does).  A micro ViT's exported graph holds ``tlxcv::flash_attention``
where the card would launch the kernel.  Each operator's fake function
gives the shape, strides and dtype its plain version returns.  The
reference's exports are StableHLO; the port's semantics are its own
(``torch.export``), with the divergences raising.
"""
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from tlxcv_tpu_torch import create_model
from tlxcv_tpu_torch import nn as tnn
from tlxcv_tpu_torch.models.classification import vision_transformer as TV
from tlxcv_tpu_torch.ops.cuda import attention as A
from tlxcv_tpu_torch.ops.cuda import gather as G
from tlxcv_tpu_torch.ops.cuda import matmul as M
from tlxcv_tpu_torch.ops.cuda import upsample as U
from tlxcv_tpu_torch.ops.quant import calibrate_activations, quantize_weights
from tlxcv_tpu_torch.tasks import ImageClassification, ObjectDetection
from tlxcv_tpu_torch.utils.export import (export_model, load_exported,
                                          save_exported)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _MicroNet(torch.nn.Module):
    """Two strided convs (one with a BatchNorm), ReLUs, a mean pool and a
    Linear: each layer kind an exported CNN holds, NHWC."""

    def __init__(self):
        super().__init__()
        self.conv1 = tnn.Conv2d(3, 8, 3, stride=2, padding=1, device="cpu")
        self.bn1 = tnn.BatchNorm(8, device="cpu")
        self.conv2 = tnn.Conv2d(8, 16, 3, stride=2, padding=1, device="cpu")
        self.fc = tnn.Linear(16, 10, device="cpu")

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        return self.fc(torch.relu(self.conv2(x)).mean((1, 2)))


def _micro(int8):
    torch.manual_seed(0)
    m = _MicroNet().eval()
    if int8:
        assert quantize_weights(m) == 3
        calibrate_activations(m, [torch.randn(2, 16, 16, 3)])
    return m, (16, 16, 3), "__call__"


def _ssd():
    torch.manual_seed(0)
    m = ObjectDetection(create_model("ssd", device="cpu", num_classes=5,
                                     image_size=(96, 96), keep_top_k=10))
    return m.eval(), (96, 96, 3), "predict"


MODELS = {"micro_f32": lambda: _micro(False),
          "micro_int8": lambda: _micro(True), "ssd_predict": _ssd}


def _graph_ops(art):
    return {str(n.target) for n in art.graph.nodes
            if str(n.target).startswith("tlxcv.")}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_round_trip_serves_batches_1_2_3_bitwise(name, tmp_path):
    model, shape, method = MODELS[name]()
    art = export_model(model, shape, method=method)
    if name == "micro_int8":
        assert _graph_ops(art) == {"tlxcv.int8_matmul_requant.default"}
    path = str(tmp_path / f"{name}.pt2")
    size = save_exported(path, art)
    assert size > 0
    serve = load_exported(path)
    eager = getattr(model, "forward" if method == "__call__" else method)
    gen = torch.Generator().manual_seed(1)
    for b in (1, 2, 3):
        x = torch.randn(b, *shape, generator=gen)
        with torch.no_grad():
            want = eager(x)
        got = serve(x)
        if isinstance(want, torch.Tensor):
            got, want = (got,), (want,)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), (name, b)


def test_vit_graph_holds_the_flash_operator(tmp_path):
    torch.manual_seed(0)
    vit = ImageClassification(TV.VisionTransformer(
        img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4,
        num_classes=10, qkv_bias=True, device="cpu")).eval()
    art = export_model(vit, (32, 32, 3), platforms=("cpu",))
    n_flash = sum(str(n.target) == "tlxcv.flash_attention.default"
                  for n in art.graph.nodes)
    assert n_flash == 2  # one a block
    save_exported(str(tmp_path / "vit.pt2"), art)
    serve = load_exported(str(tmp_path / "vit.pt2"))
    x = torch.randn(3, 32, 32, 3)
    with torch.no_grad():
        assert torch.equal(serve(x), vit(x))
    # with a fixed batch the artifact takes that batch
    fixed = export_model(vit, (32, 32, 3), batch=3)
    assert torch.equal(fixed.module()(x), serve(x))


def test_divergences_raise():
    model, shape, _ = _micro(False)
    with pytest.raises(NotImplementedError, match="platforms"):
        export_model(model, shape, platforms=("tpu", "cpu"))
    with pytest.raises(NotImplementedError, match="item 15"):
        export_model(model, shape, batch=2, sharding=object())
    with pytest.raises(ValueError, match="lies on"):
        export_model(model, shape, platforms=("cuda",))


def _q8(rng, *shape):
    return torch.from_numpy(rng.integers(-100, 100, shape).astype(np.int8))


def _f(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        dtype)


def _op_cases(rng):
    """(operator, arguments); on the CPU the operator runs its plain
    version."""
    q4, k4, v4 = (_f(rng, 2, 3, n, 32) for n in (5, 7, 7))
    bias = _f(rng, 1, 5, 7)
    a, w = _q8(rng, 6, 32), _q8(rng, 4, 32)
    scale, b = _f(rng, 4).abs(), _f(rng, 4)
    x, skip = _f(rng, 2, 3, 4, 8), _f(rng, 2, 6, 8, 8)
    table, idx = _f(rng, 9, 5), torch.tensor([3, 0, 8, 3], dtype=torch.int32)
    return {
        "flash_attention_4d": (A.flash_attention_op, (q4, k4, v4, bias, 0.2)),
        "flash_attention_3d": (A.flash_attention_op,
                               (q4[0], k4[0], v4[0], None, 0.2)),
        "flash_attention_lse": (A.flash_attention_lse_op,
                                (q4, k4, v4, None, 0.2)),
        "int8_matmul_nt": (M.int8_matmul_nt_op, (a, w)),
        "int8_matmul_requant_int8": (
            M.int8_matmul_requant_op,
            (a, w, scale, b, True, torch.tensor(0.5), torch.float32)),
        "int8_matmul_requant_bf16": (
            M.int8_matmul_requant_op,
            (a, w, scale, None, False, None, torch.bfloat16)),
        "bf16_matmul": (M.bf16_matmul_op,
                        (_f(rng, 5, 12, dtype=torch.bfloat16),
                         _f(rng, 12, 3, dtype=torch.bfloat16))),
        "gather_rows": (G.gather_rows_op, (table, idx)),
        "upsample_add": (U.upsample_add_op, (x, skip, "bilinear")),
        "upsample2x": (U.upsample2x_op, (x,)),
    }


CASES = sorted(_op_cases(np.random.default_rng(0)))


@pytest.mark.parametrize("case", CASES)
def test_fake_function_matches_the_plain_version(case, rng):
    op, args = _op_cases(rng)[case]
    real = op(*args)
    mode = FakeTensorMode()
    fake_args = [mode.from_tensor(t) if isinstance(t, torch.Tensor) else t
                 for t in args]
    with mode:
        fake = op(*fake_args)
    real = real if isinstance(real, tuple) else (real,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    for r, f in zip(real, fake, strict=True):
        assert (f.shape, f.stride(), f.dtype) == (r.shape, r.stride(),
                                                  r.dtype), case
