"""The port's FCOS (with and without its deformable head), its FPN, the
deformable conv and its sampler, and GroupNorm against the JAX package on
the CPU: the head outputs and detections at 64 px and at 80 x 104 (a frame
whose pyramid levels are not in 2:1 ratios, where the FPN's half-pixel
nearest resize and the legacy nearest rule part), ``fcos_targets`` and
``loss_fn``.

Micro size, the JAX package's own (``tests/test_det_zoo2.py:13``): a
ResNet-18 trunk, 5 classes, the published head (256 wide, 4 convs a
tower, GroupNorm(32)).  Weights are the JAX model's, copied by the bridge
(the per-level 0-d scales, towers mixing convs and GroupNorms in one list,
the deformable conv's two convs); BatchNorm statistics are drawn from a
numpy seed.  The classifier, centerness and distance convs are drawn at
std 0.1, 0.1 and 0.05 (at their normal(0.01) init every score is about
0.005, under the 0.025 threshold, and no box would be kept).  The JAX side
runs under ``jax.jit``.

Tolerance: f32 within 2e-4 of the largest magnitude
(``tests/test_parity_resnet.py:91``); detections' labels and counts
equal; the targets' classes and positives equal; GroupNorm in bf16 within
one bf16 ulp (both round the same f32 result).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_seg_zoo import _close, _flat, _random_bn
from tlxcv_tpu import nn as jnn
from tlxcv_tpu.core import pure, split
from tlxcv_tpu.models.classification.resnet import ResNet as JResNet
from tlxcv_tpu.models.detection import deform as JDF
from tlxcv_tpu.models.detection import fcos as JF
from tlxcv_tpu.models.detection import tood as JT
from tlxcv_tpu_torch import create_model
from tlxcv_tpu_torch.models.classification.resnet import ResNet
from tlxcv_tpu_torch.models.detection import deform as TDF
from tlxcv_tpu_torch.models.detection import fcos as TF
from tlxcv_tpu_torch.models.detection import tood as TT
from tlxcv_tpu_torch.nn import layers as T
from tlxcv_tpu_torch.ops.image import interpolate
from tlxcv_tpu_torch.utils import load_jax_params

FRAMES = [(64, 64), (80, 104)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: these micro models' small ops gain nothing
    from more, and several test processes share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _images(rng, hw, n=2):
    return rng.normal(size=(n, *hw, 3)).astype(np.float32)


def _draw(conv, std, rng):
    conv.weight.value = jnp.asarray(
        rng.normal(scale=std, size=conv.weight.value.shape), jnp.float32)


def _fcos_pair(dcn, seed):
    rng = np.random.default_rng(seed)
    jm = JF.FCOS(num_classes=5, dcn_last=dcn, backbone=JResNet(
        depth=18, num_classes=0, with_pool=False))
    _random_bn(jm, rng)
    for conv, std in ((jm.head.cls_pred, 0.1), (jm.head.ctr_pred, 0.1),
                      (jm.head.reg_pred, 0.05)):
        _draw(conv, std, rng)
    if dcn:  # offsets of a few pixels, so that the sampling is exercised
        for tower in (jm.head.cls_tower, jm.head.reg_tower):
            _draw(tower[6].offset_conv, 0.01, rng)
    tm = TF.FCOS(num_classes=5, dcn_last=dcn, device="cpu", backbone=ResNet(
        depth=18, num_classes=0, with_pool=False, device="cpu"))
    load_jax_params(tm, _flat(jm))
    return jm, tm.eval()


@pytest.fixture(scope="module")
def fcos_pairs():
    """The plain (False) and deformable (True) pair, each built once."""
    cache = {}

    def get(dcn):
        if dcn not in cache:
            cache[dcn] = _fcos_pair(dcn, 7 + dcn)
        return cache[dcn]
    return get


def _targets(rng, n=2, m=3, hw=(64, 64), nc=5):
    """Two boxes an image and a padding row (the JAX package's own
    ``tests/test_det_zoo2.py::_targets``, at any frame)."""
    img = np.array([hw[1], hw[0]], np.float32)
    boxes = np.zeros((n, m, 4), np.float32)
    xy = rng.uniform(2, img / 2, size=(n, 2, 2)).astype(np.float32)
    wh = rng.uniform(img / 4, img / 2, size=(n, 2, 2)).astype(np.float32)
    boxes[:, :2, :2] = xy
    boxes[:, :2, 2:] = np.minimum(xy + wh, img - 1)
    mask = np.zeros((n, m), np.float32)
    mask[:, :2] = 1.0
    return {"boxes": boxes,
            "class_labels": rng.integers(0, nc, size=(n, m)).astype(np.int32),
            "mask": mask}


def _stages(m, x, tg, hw):
    """Head outputs, detections and the loss on the eval-mode outputs."""
    outs, hws = m.head_outputs(x)
    dets = m.post_process(outs, hws, hw)
    return outs, hws, dets, m.loss_fn(
        {"outs": outs, "feat_hws": hws, "image_hw": hw}, tg)


@pytest.mark.parametrize("dcn,hw", [(False, FRAMES[0]), (False, FRAMES[1]),
                                    (True, FRAMES[1])],
                         ids=["fcos-64x64", "fcos-80x104", "dcn-80x104"])
def test_fcos_matches_jax(rng, fcos_pairs, dcn, hw):
    """Every level's head outputs, the detections and ``loss_fn``; the
    deformable head at the frame of non-integer ratios."""
    jm, tm = fcos_pairs(dcn)
    x = _images(rng, hw)
    tg = _targets(rng, hw=hw)
    (jouts, jhws, (jdets, jcounts), jloss), _ = jax.jit(
        lambda p, s, v, t: pure(jm, lambda m, v, t: _stages(m, v, t, hw))(
            p, s, v, t))(*split(jm), jnp.asarray(x),
                         {k: jnp.asarray(v) for k, v in tg.items()})
    with torch.no_grad():
        touts, thws, (tdets, tcounts), tloss = _stages(
            tm, torch.from_numpy(x),
            {k: torch.from_numpy(v) for k, v in tg.items()}, hw)
    assert thws == tuple(tuple(h) for h in jhws)
    for tl, jl in zip(touts, jouts):
        for t, j in zip(tl, jl):
            _close(t, j)
    assert tcounts.tolist() == np.asarray(jcounts).tolist()
    assert min(tcounts.tolist()) > 0
    jdets = np.asarray(jdets)
    np.testing.assert_array_equal(tdets[..., 0].numpy(), jdets[..., 0])
    _close(tdets[..., 1], jdets[..., 1])
    _close(tdets[..., 2:], jdets[..., 2:])
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=2e-4)


def test_fcos_train_mode_returns_the_head_outputs(fcos_pairs):
    _, tm = fcos_pairs(True)
    tm.train()
    try:
        with torch.no_grad():
            out = tm(torch.randn(1, 64, 96, 3))
    finally:
        tm.eval()
    assert set(out) == {"outs", "feat_hws", "image_hw"}
    assert out["image_hw"] == (64, 96) and len(out["outs"]) == 5
    assert out["feat_hws"][0] == (8, 12)
    assert [t.shape[-1] for t in out["outs"][0]] == [5, 4, 1]


@pytest.mark.parametrize("hw", FRAMES, ids=["64x64", "80x104"])
def test_fcos_targets_match_jax(rng, hw):
    """``fcos_targets`` per image on the model's points."""
    tg = _targets(rng, hw=hw)
    hws = tuple((-(-hw[0] // s), -(-hw[1] // s)) for s in TF.STRIDES)
    jp = JF._level_points(hws)
    tp = TF._level_points(hws)
    for j, t in zip(jp, tp):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    strides = np.concatenate([np.full(len(p), s, np.float32)
                              for p, s in zip(jp, TF.STRIDES)])
    ranges = np.concatenate([np.broadcast_to(np.float32(r), (len(p), 2))
                             for p, r in zip(jp, TF.LEVEL_RANGES)])
    pts = np.concatenate([np.asarray(p) for p in jp])
    targets = jax.jit(JF.fcos_targets, static_argnums=6)
    for i in range(2):
        args = (pts, strides, ranges, tg["boxes"][i], tg["class_labels"][i],
                tg["mask"][i])
        jc, jl, jctr, jpos = targets(*map(jnp.asarray, args), 5)
        tc, tl, tctr, tpos = TF.fcos_targets(
            *(torch.from_numpy(np.ascontiguousarray(a)) for a in args), 5)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
        assert tpos.any()
        _close(tl, jl)
        _close(tctr, jctr)


@pytest.mark.parametrize("src,dst", [((50, 84), (100, 167)),
                                     ((3, 4), (5, 7)), ((5, 7), (10, 13)),
                                     ((7, 9), (7, 18)), ((4, 4), (8, 8))])
def test_fpn_nearest_is_jax_image_resize(rng, src, dst):
    """``_resize_nearest`` picks jax.image.resize's rows, bitwise; at a
    ratio that is not an integer it is not the legacy nearest rule."""
    x = rng.normal(size=(1, *src, 2)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (1, *dst, 2), "nearest")
    got = TF._resize_nearest(torch.from_numpy(x), dst)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    legacy = interpolate(torch.from_numpy(x), size=dst, mode="nearest")
    exact_ratio = all(b % a == 0 for a, b in zip(src, dst))
    assert torch.equal(legacy, got) == exact_ratio


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_matches_jax(rng, dtype):
    jm = jnn.GroupNorm(8, 32)
    jm.weight.value = jnp.asarray(rng.uniform(0.5, 1.5, 32), jnp.float32)
    jm.bias.value = jnp.asarray(rng.normal(size=32), jnp.float32)
    tm = T.GroupNorm(8, 32, device="cpu")
    load_jax_params(tm, _flat(jm))
    x = (rng.normal(size=(2, 5, 6, 32)) * 3 + 1).astype(np.float32)
    want = np.asarray(jm(jnp.asarray(x, dtype)).astype(jnp.float32))
    got = tm(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    ulp = 2.0 ** -7 if dtype == "bfloat16" else 0.0
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               atol=2e-6 * np.abs(want).max(),
                               rtol=ulp)


def test_bilinear_sample_matches_jax(rng):
    """Coordinates inside, on the border and outside the map (clamped)."""
    feat = rng.normal(size=(2, 6, 7, 4)).astype(np.float32)
    xs = rng.uniform(-3, 10, size=(2, 6, 7)).astype(np.float32)
    ys = rng.uniform(-3, 9, size=(2, 6, 7)).astype(np.float32)
    xs[0, 0, :3] = [0.0, 6.0, 2.0]
    want = JT._bilinear_sample(*map(jnp.asarray, (feat, xs, ys)))
    got = TT._bilinear_sample(*map(torch.from_numpy, (feat, xs, ys)))
    _close(got, want)


def test_deform_conv_zero_offsets_equal_the_dense_conv():
    """At its zero init every tap samples its own pixel with mask
    sigmoid(0) = 1/2: inside the border, a dense 3x3 conv with the tap
    weights halved."""
    gen = torch.Generator().manual_seed(3)
    dc = TDF.DeformConv2d(4, 6, device="cpu", generator=gen)
    x = torch.randn(1, 8, 8, 4, generator=gen)
    with torch.no_grad():
        out = dc(x)
        w = dc.proj.weight.reshape(6, 3, 3, 4).permute(0, 3, 1, 2)
        dense = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), 0.5 * w,
                                           dc.proj.bias, padding=1)
    torch.testing.assert_close(out[0, 1:-1, 1:-1],
                               dense.permute(0, 2, 3, 1)[0, 1:-1, 1:-1],
                               atol=1e-5, rtol=0)


def test_deform_conv_matches_jax_at_random_offsets(rng):
    """Offsets of up to several pixels, some past the border; the mask
    logits away from 0."""
    jm = JDF.DeformConv2d(8, 6)
    _draw(jm.offset_conv, 0.3, rng)
    jm.offset_conv.bias.value = jnp.asarray(
        rng.normal(scale=2.0, size=27), jnp.float32)
    tm = TDF.DeformConv2d(8, 6, device="cpu")
    load_jax_params(tm, _flat(jm))
    x = rng.normal(size=(2, 7, 9, 8)).astype(np.float32)
    with torch.no_grad():
        off = tm.offset_conv(torch.from_numpy(x))
    assert off[..., :18].abs().max() > 5
    want = jm(jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(got, want)


def test_registry_builds_both_fcos():
    plain = create_model("fcos_r50", device="cpu")
    dcn = create_model("fcos_dcn_r50", device="cpu")
    assert plain.backbone.feat_channels == [256, 512, 1024, 2048]
    assert plain.head.cls_pred.weight.shape[0] == 80
    assert type(plain.head.cls_tower[6]).__name__ == "Conv2d"
    assert type(dcn.head.cls_tower[6]).__name__ == "DeformConv2d"
    assert type(dcn.head.reg_tower[7]).__name__ == "GroupNorm"
    assert dcn.head.scales[4].scale.shape == ()
    assert not dcn.head.cls_tower[6].offset_conv.weight.any()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_model("fcos_r50")
