"""The port's HRNet segmentation slice against the JAX package on the CPU:
the space-to-depth rewrites, the HRNet backbone converted and not, the FCN
head through ``ImageSegmentation``, and the segmentation metrics, with the
JAX model's weights copied across by the bridge.

Tolerances: the weight remaps are numpy and bitwise.  f32 modules within
2e-4 of the largest magnitude (``tests/test_parity_resnet.py:91``); the
converted graph against the unconverted one within 5e-4 absolute, 1e-3
relative, as ``tests/test_hrnet_s2d.py`` holds the reference's (the blocked
3x3 convs sum structural zeros in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tlxcv_tpu import nn as jnn
from tlxcv_tpu.core import pure, split
from tlxcv_tpu.models.backbones import hrnet as JH
from tlxcv_tpu.models.segmentation import hrnet_seg as JS
from tlxcv_tpu.ops import space_to_depth as JD
from tlxcv_tpu.tasks import image_segmentation as JT
from tlxcv_tpu_torch import create_model, list_models
from tlxcv_tpu_torch.models.backbones import hrnet as TH
from tlxcv_tpu_torch.models.segmentation import hrnet_seg as TS
from tlxcv_tpu_torch.nn import layers as T
from tlxcv_tpu_torch.ops import space_to_depth as TD
from tlxcv_tpu_torch.tasks import image_segmentation as TT
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
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=bound * np.abs(want).max())


# ------------------------------------------------------- space to depth
@pytest.mark.parametrize("ph,pw,c", [(2, 2, 5), (2, 1, 6), (4, 2, 3)])
def test_remap_conv3x3_matches_jax(rng, ph, pw, c):
    """The reference's pack variants (tests/test_hrnet_s2d.py): the same
    remapped kernel, and the blocked conv reproduces the pixel-space conv
    in torch too."""
    w = rng.normal(size=(3, 3, c, c)).astype(np.float32) * 0.2
    wb = TD.remap_conv3x3_s1(w, ph, pw)
    np.testing.assert_array_equal(wb, JD.remap_conv3x3_s1(w, ph, pw))
    x = torch.from_numpy(rng.normal(size=(2, 8 * ph, 8 * pw, c))
                         .astype(np.float32))

    def conv(t, k):  # NHWC, HWIO, SAME
        k = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
        return F.conv2d(t.permute(0, 3, 1, 2), k, padding=1) \
            .permute(0, 2, 3, 1)

    want = conv(x, w)
    z = TD.block_space_to_depth(x, ph, pw)
    np.testing.assert_array_equal(
        z.numpy(), np.asarray(JD.block_space_to_depth(jnp.asarray(x.numpy()),
                                                      ph, pw)))
    got = TD.unblock_space_to_depth(conv(z, wb), ph, pw, c)
    _close(got, want)
    assert torch.equal(TD.unblock_space_to_depth(z, ph, pw, c), x)


@pytest.mark.parametrize("hw", [32, 33])
def test_space_to_depth_stem_matches_jax(rng, hw):
    jc = jnn.Conv2d(3, 16, 7, stride=2, padding=3, bias=True)
    jc.bias.value = jnp.asarray(rng.normal(size=16), jnp.float32)
    tc = T.Conv2d(3, 16, 7, stride=2, padding=3, device="cpu")
    load_jax_params(tc, _flat(jc))
    x = rng.normal(size=(2, hw, hw, 3)).astype(np.float32)
    with torch.no_grad():
        plain = tc(torch.from_numpy(x))
    state = torch.random.get_rng_state()
    stem = TD.SpaceToDepthStem(tc)
    assert torch.equal(torch.random.get_rng_state(), state)  # no draw
    assert tuple(stem.conv.weight.shape) == (16, 12, 4, 4)
    want = JD.SpaceToDepthStem(jc)(jnp.asarray(x))
    with torch.no_grad():
        got = stem(torch.from_numpy(x))
    assert got.shape == plain.shape == (2, -(-hw // 2), -(-hw // 2), 16)
    _close(got, want)
    _close(got, plain.numpy())
    holder = torch.nn.Module()
    holder.conv1 = tc
    TD.convert_stem_to_space_to_depth(holder)
    assert isinstance(holder.conv1, TD.SpaceToDepthStem)
    with pytest.raises(ValueError):
        TD.SpaceToDepthStem(T.Conv2d(3, 8, 7, stride=1, padding=3,
                                     device="cpu"))
    with pytest.raises(ValueError):
        TD.SpaceToDepthStem(T.Conv2d(3, 8, 7, stride=2, padding=3,
                                     dilation=2, device="cpu"))


# --------------------------------------------------------------- HRNet
def _hrnet_pair(rng):
    jm = JH.hrnet_w18_small_v1()
    _random_bn(jm, rng)
    tm = TH.hrnet_w18_small_v1(device="cpu")
    load_jax_params(tm, _flat(jm))
    return jm, tm.eval()


def test_hrnet_matches_jax_converted_and_not(rng):
    """hrnet_w18_small_v1 at 64 px (all four pack choices: 2x2 on 16 and
    32 channels, 2x1 on 64, none at 128), mirroring
    tests/test_hrnet_s2d.py."""
    jm, tm = _hrnet_pair(rng)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    want = [np.asarray(o) for o in jm(jnp.asarray(x))]
    with torch.no_grad():
        plain = [o.numpy() for o in tm(torch.from_numpy(x))]
    for g, w in zip(plain, want):
        _close(g, w)
    n = TH.convert_hrnet_branches_to_s2d(tm)
    assert n == JH.convert_hrnet_branches_to_s2d(jm) > 0
    packs = sorted({(b.ph, b.pw) for m in tm.modules()
                    if isinstance(m, TH.HighResolutionModule)
                    for b in m.branches
                    if isinstance(b, TH.SpaceToDepthBranch)})
    assert packs == [(2, 1), (2, 2)]
    want_s2d = [np.asarray(o) for o in jm(jnp.asarray(x))]
    with torch.no_grad():
        got = [o.numpy() for o in tm(torch.from_numpy(x))]
    for g, w, p in zip(got, want_s2d, plain):
        _close(g, w)
        np.testing.assert_allclose(g, p, atol=5e-4, rtol=1e-3)


def test_s2d_branch_draws_no_random_numbers(rng):
    _, tm = _hrnet_pair(rng)
    state = torch.random.get_rng_state()
    TH.convert_hrnet_branches_to_s2d(tm)
    assert torch.equal(torch.random.get_rng_state(), state)


@pytest.mark.parametrize("kw", [dict(dilation=2, padding=2),
                                dict(groups=2, padding=1)])
def test_s2d_guard_refuses_dilated_and_grouped_convs(kw):
    branch = TH.Branch(16, 16, 1, device="cpu")
    branch.blocks[0].conv1.conv = T.Conv2d(16, 16, 3, bias=False,
                                           device="cpu", **kw)
    with pytest.raises(ValueError, match="dilation"):
        TH.SpaceToDepthBranch(branch, 2, 2)
    TH.SpaceToDepthBranch(TH.Branch(16, 16, 1, device="cpu"), 2, 2)


def test_s2d_branch_refuses_training(rng):
    _, tm = _hrnet_pair(rng)
    TH.convert_hrnet_branches_to_s2d(tm)
    tm.train()
    with pytest.raises(RuntimeError, match="serving"):
        tm(torch.zeros(1, 64, 64, 3))


# --------------------------------------------------- FCN and its task
def _fcn_pair(rng, num_classes=5):
    jm = JS.FCN(num_classes, JH.hrnet_w18_small_v1())
    _random_bn(jm, rng)
    tm = TS.FCN(num_classes, TH.hrnet_w18_small_v1(device="cpu"),
                device="cpu")
    load_jax_params(tm, _flat(jm))
    return jm, TT.ImageSegmentation(tm).eval()


def test_fcn_predict_and_metrics_match_jax(rng):
    jm, task = _fcn_pair(rng)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    jtask = JT.ImageSegmentation(jm)
    want, _ = pure(jtask, "predict")(*split(jtask), jnp.asarray(x))
    want = np.array(want)
    with torch.no_grad():
        got = task.predict(torch.from_numpy(x))
    assert got.shape == (2, 64, 64, 5)
    _close(got.numpy(), want)

    labels = rng.integers(0, 5, size=(2, 64, 64))
    onehot = np.eye(5, dtype=np.float32)[labels]
    for target in (labels, onehot):
        jloss = jtask.loss_fn(jnp.asarray(want), jnp.asarray(target))
        tloss = task.loss_fn(torch.from_numpy(want), torch.from_numpy(target))
        np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-6)

    for target in (labels, onehot):
        jacc, tacc = JT.Accuracy(), TT.Accuracy()
        jacc.update(want, target)
        tacc.update(torch.from_numpy(want), torch.from_numpy(target))
        assert tacc.result() == jacc.result() > 0
        tacc.reset()
        assert tacc.result() == 0

    probs = np.asarray(torch.softmax(torch.from_numpy(want), -1))
    np.testing.assert_allclose(
        TT.mean_iou(onehot, probs).item(),
        float(JT.mean_iou(onehot, probs)), rtol=1e-6)
    np.testing.assert_allclose(
        TT.dice_coefficient(torch.from_numpy(onehot),
                            torch.from_numpy(probs)).item(),
        float(JT.dice_coefficient(jnp.asarray(onehot), jnp.asarray(probs))),
        rtol=1e-6)


def test_fcn_converted_predict_matches_jax(rng):
    jm, task = _fcn_pair(rng)
    JH.convert_hrnet_branches_to_s2d(jm)
    TH.convert_hrnet_branches_to_s2d(task)
    x = rng.normal(size=(1, 64, 64, 3)).astype(np.float32)
    want, _ = pure(jm)(*split(jm), jnp.asarray(x))
    with torch.no_grad():
        got = task.predict(torch.from_numpy(x))
    _close(got.numpy(), want)


def test_contrast_head_trains_and_serves(rng):
    jm = JS.HRNetW48Contrast(4, proj_dim=8, backbone=JH.hrnet_w18_small_v1())
    tm = TS.HRNetW48Contrast(4, proj_dim=8,
                             backbone=TH.hrnet_w18_small_v1(device="cpu"),
                             device="cpu")
    load_jax_params(tm, _flat(jm))
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    params, state = split(jm)
    want_train, _ = pure(jm)(params, state, jnp.asarray(x), training=True)
    want_eval, _ = pure(jm)(params, state, jnp.asarray(x))
    tm.eval()
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)).numpy(), want_eval)
    tm.train()  # batch statistics, and the running ones updated
    got = tm(torch.from_numpy(x))
    _close(got["seg"].detach().numpy(), want_train["seg"])
    _close(got["embed"].detach().numpy(), want_train["embed"])


def test_registry_builds_the_segmentation_models():
    assert {"hrnet_seg_w18", "hrnet_seg_w48"} <= set(list_models("hrnet"))
    model = create_model("hrnet_seg_w18", device="cpu", num_classes=19)
    assert model.head.cls.weight.shape[0] == 19
    assert model.backbone.branch_channels == [18, 36, 72, 144]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            create_model("hrnet_seg_w18")


def test_jax_grouped_float_layers_match(rng):
    """The segmentation layers' float grouped convs (depthwise and
    separable) against the reference's ``feature_group_count`` convs."""
    from tlxcv_tpu.models.segmentation import layers as JL
    from tlxcv_tpu_torch.models.segmentation import layers as TL

    for jmod, tmod in (
            (JL.DepthwiseConvBN(8, 3), TL.DepthwiseConvBN(8, 3,
                                                          device="cpu")),
            (JL.SeparableConvBNReLU(8, 12, 3, dilation=2),
             TL.SeparableConvBNReLU(8, 12, 3, dilation=2, device="cpu")),
            (JL.ASPPModule((1, 2), 8, 6, use_sep_conv=True),
             TL.ASPPModule((1, 2), 8, 6, use_sep_conv=True, device="cpu")),
            (JL.PPModule(8, 6, bin_sizes=(1, 2)),
             TL.PPModule(8, 6, bin_sizes=(1, 2), device="cpu")),
            (JL.AuxLayer(8, 6, 3), TL.AuxLayer(8, 6, 3, device="cpu"))):
        _random_bn(jmod, rng)
        load_jax_params(tmod, _flat(jmod))
        tmod.eval()
        x = rng.normal(size=(2, 8, 8, 8)).astype(np.float32)
        want, _ = pure(jmod)(*split(jmod), jnp.asarray(x))
        with torch.no_grad():
            got = tmod(torch.from_numpy(x))
        _close(got.numpy(), want)
