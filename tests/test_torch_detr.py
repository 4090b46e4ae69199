"""The port's DETR against the JAX package on the CPU: the reference's own
micro detector of tests/test_detr.py (``Detr(num_classes=5,
num_queries=8, dim=32, heads=2, enc_layers=1, dec_layers=2, ffn=64,
dropout=0.0)``) on a ResNet-18 backbone at 64^2, its frozen BatchNorms
given random statistics, its weights and statistics carried across by
``load_jax_params(strict=True)``.  Every stage is compared on the same
seeded f32 input, within 2e-4 of the stage's largest value (f32, other
summation orders through 20 convolutions and 3 attention layers)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlxcv_tpu import nn as jnn
from tlxcv_tpu.core import pure, split
from tlxcv_tpu.models.detection import detr as jdetr
from tlxcv_tpu_torch import create_model
from tlxcv_tpu_torch.models.detection import detr as tdetr
from tlxcv_tpu_torch.tasks import ObjectDetection
from tlxcv_tpu_torch.utils import load_jax_params

MICRO = dict(num_classes=5, num_queries=8, dim=32, heads=2, enc_layers=1,
             dec_layers=2, ffn=64, dropout=0.0, backbone_depth=18)
HW = (64, 64)
REL = 2e-4


def _flat(jax_module):
    params, state = split(jax_module)
    return {k: np.asarray(v) for k, v in {**params, **state}.items()}


def _assert_rel(got, want, rel=REL, what=""):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (what, err)


def _jax_memory(m, v):
    """The JAX model's encoder output (detr.py:158-166)."""
    x = m.input_proj(m.backbone.features(v)[-1])
    b, h, w, c = x.shape
    pos = jnp.asarray(jdetr.sine_position_embedding(h, w, m.dim)).reshape(
        1, h * w, m.dim)
    src = x.reshape(b, h * w, c)
    for layer in m.encoder:
        src = layer(src, pos)
    return src


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    jm = jdetr.Detr(**MICRO)
    for _, mod in jm.modules():  # frozen, and the downsample branches' BNs
        if isinstance(mod, (jdetr.FrozenBatchNorm, jnn.BatchNorm)):
            c = mod.running_mean.value.shape[0]
            for name, val in (
                    ("weight", rng.uniform(0.5, 1.5, c)),
                    ("bias", rng.normal(scale=0.1, size=c)),
                    ("running_mean", rng.normal(scale=0.2, size=c)),
                    ("running_var", rng.uniform(0.5, 2.0, c))):
                getattr(mod, name).value = jnp.asarray(val, jnp.float32)
    tm = tdetr.Detr(**MICRO, device="cpu")
    load_jax_params(tm, _flat(jm), strict=True)
    tm.eval()
    x = rng.normal(size=(2, *HW, 3)).astype(np.float32)
    run = lambda fn: jax.jit(  # noqa: E731
        lambda p, s, v: pure(jm, fn)(p, s, v)[0])(*split(jm), jnp.asarray(x))
    want = {"c5": run(lambda m, v: m.backbone.features(v)[-1]),
            "memory": run(_jax_memory),
            "out": run(lambda m, v: m(v))}
    train, _ = jax.jit(lambda p, s, v: pure(jm)(p, s, v, training=True))(
        *split(jm), jnp.asarray(x))
    want["train"] = train
    return jm, tm, torch.from_numpy(x), want


def test_bridge_carries_every_tensor(pair):
    """Every JAX leaf lands, the frozen BatchNorms' four tensors and
    ``query_embed`` among them; the frozen statistics are buffers."""
    jm, tm = pair[:2]
    flat = _flat(jm)
    assert sorted(k.replace(".", "/") for k in tm.state_dict()) == \
        sorted(flat)
    assert "query_embed" in flat
    buffers = dict(tm.named_buffers())
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        key = f"backbone.layer4.layers.1.bn2.{leaf}"
        assert key in buffers
        np.testing.assert_array_equal(buffers[key].numpy(),
                                      flat[key.replace(".", "/")])
    assert not any("bn" in n for n, _ in tm.backbone.named_parameters())
    # the reference's swap leaves the downsample branches' BatchNorms
    down = tm.backbone.layer2[0].downsample[1]
    assert type(down).__name__ == "BatchNorm"
    assert isinstance(tm.backbone.layer2[0].bn1, tdetr.FrozenBatchNorm)


def test_frozen_statistics_stay_f32_when_parameters_go_bf16():
    tm = tdetr.Detr(**MICRO, device="cpu")
    for p in tm.parameters():
        p.data = p.data.to(torch.bfloat16)
    fbn = tm.backbone.layer1[0].bn1
    assert isinstance(fbn, tdetr.FrozenBatchNorm)
    assert all(t.dtype == torch.float32 for t in fbn.buffers())
    with torch.no_grad():
        out = tm.eval()(torch.zeros(1, *HW, 3, dtype=torch.bfloat16))
    assert out["logits"].dtype == torch.bfloat16


def test_backbone_c5_matches_jax(pair):
    _, tm, x, want = pair
    with torch.no_grad():
        _assert_rel(tm.backbone.features(x)[-1], want["c5"], what="C5")


def test_encoder_memory_matches_jax(pair):
    _, tm, x, want = pair
    with torch.no_grad():
        memory, pos = tm.encode(x)
    _assert_rel(memory, want["memory"], what="memory")
    assert pos.shape == (1, 4, 32)


def test_logits_and_boxes_match_jax(pair):
    _, tm, x, want = pair
    with torch.no_grad():
        got = ObjectDetection(tm).predict(x)
    assert set(got) == {"logits", "boxes"}
    _assert_rel(got["logits"], want["out"]["logits"], what="logits")
    _assert_rel(got["boxes"], want["out"]["boxes"], what="boxes")


def test_train_mode_returns_every_decoder_layer(pair):
    """With ``aux_loss`` a train-mode forward returns both decoder layers'
    heads, as the JAX model's training call does (the downsample
    branches' BatchNorms on batch statistics in both)."""
    _, tm, x, want = pair
    tm.train()
    try:
        with torch.no_grad():
            got = tm(x)
    finally:
        tm.eval()
    assert len(got) == len(want["train"]) == 2
    for g, w in zip(got, want["train"]):
        for key in ("logits", "boxes"):
            _assert_rel(g[key], w[key], what=key)


def test_predict_boxes_matches_jax(pair):
    """On the same outputs, the labels are equal, scores within 1e-6 and
    boxes within 1e-4 px."""
    jm, tm, _, want = pair
    out = want["out"]
    wl, ws, wb = jm.predict_boxes(out, HW)
    gl, gs, gb = tm.predict_boxes(
        {k: torch.from_numpy(np.array(v)) for k, v in out.items()}, HW)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("h,w,dim", [(2, 2, 32), (25, 42, 256)])
def test_position_embedding_is_the_reference_and_cached(h, w, dim):
    np.testing.assert_array_equal(tdetr.sine_position_embedding(h, w, dim),
                                  jdetr.sine_position_embedding(h, w, dim))
    a = tdetr._position_embedding(h, w, dim, torch.device("cpu"),
                                  torch.bfloat16)
    assert a.shape == (1, h * w, dim) and a.dtype == torch.bfloat16
    assert a is tdetr._position_embedding(h, w, dim, torch.device("cpu"),
                                          torch.bfloat16)


def test_attention_reads_strided_head_views(pair, monkeypatch):
    """Each attention hands q, k, v to the kernel boundary as [B, H, S, D]
    views into the projections' outputs, not copies: 1 encoder call
    (4 x 4 tokens) and per decoder layer a self (8 x 8) and a cross
    (8 x 4) call."""
    from tlxcv_tpu_torch.nn import attention

    seen = []
    real = attention.flash_attention

    def spy(q, k, v, **kw):
        seen.append((tuple(q.shape), tuple(k.shape), q.stride(), k.stride()))
        return real(q, k, v, **kw)

    monkeypatch.setattr(attention, "flash_attention", spy)
    tm, x = pair[1], pair[2]
    with torch.no_grad():
        tm(x)
    assert [(q, k) for q, k, _, _ in seen] == [
        ((2, 2, 4, 16), (2, 2, 4, 16)),
        ((2, 2, 8, 16), (2, 2, 8, 16)), ((2, 2, 8, 16), (2, 2, 4, 16)),
        ((2, 2, 8, 16), (2, 2, 8, 16)), ((2, 2, 8, 16), (2, 2, 4, 16))]
    for (q, k, qs, ks) in seen:
        assert qs == (q[2] * 32, 16, 32, 1) and ks == (k[2] * 32, 16, 32, 1)


def test_loss_fn_raises_until_training_is_ported(pair):
    """Training is ported: ``loss_fn`` (DetrLoss, tests/test_torch_detr_
    train.py) takes the eval output and returns a finite loss."""
    _, tm, x, _ = pair
    boxes = torch.tensor([[[0.5, 0.5, 0.2, 0.3]], [[0.3, 0.6, 0.1, 0.2]]])
    with torch.no_grad():
        loss = tm.loss_fn(tm(x), {"boxes": boxes,
                                  "class_labels": torch.tensor([[1], [4]]),
                                  "mask": torch.ones(2, 1)})
    assert loss.ndim == 0 and torch.isfinite(loss)


def test_registry_builds_detr_r50():
    """``create_model("detr")`` is DETR-R50: 91 classes, 100 queries,
    width 256 over 8 heads, 6 + 6 layers, FFN 2048, frozen BatchNorms."""
    m = create_model("detr", device="cpu")
    assert (m.num_classes, m.num_queries, m.dim) == (91, 100, 256)
    assert len(m.encoder) == len(m.decoder) == 6
    assert m.encoder[0].attn.num_heads == 8
    assert m.encoder[0].fc1.weight.shape == (2048, 256)
    assert m.input_proj.weight.shape == (256, 2048, 1, 1)
    assert isinstance(m.backbone.bn1, tdetr.FrozenBatchNorm)
