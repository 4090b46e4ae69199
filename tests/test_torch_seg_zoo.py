"""The port's segmentation zoo against the JAX package on the CPU: the
ResNet-vD backbone, BiSeNetV2, UNet, Fast-SCNN, DeepLabV3 and V3+, FastFCN
(with its Encoding), EncNet and ENet, in eval and, where the reference has
them, with the training outputs; and ``build_seg_model`` on every in-repo
segmentation YAML.  Weights are the JAX model's, copied by the bridge;
BatchNorm statistics are drawn from a numpy seed.

Micro size: 64 px inputs (UNet 92 px, its valid convs take 40), the
ResNet-vD models on resnet18_vd, UNet at 8 root filters.  Widths the
reference fixes (BiSeNetV2, Fast-SCNN, ENet, JPU and the encoding head's
512) stay as they are.

Tolerances: f32 outputs within 2e-4 of their largest magnitude
(``tests/test_parity_resnet.py:91``); in training mode dropout is set to 0
in both, and BatchNorm uses the batch's statistics in both.  ``Encoding``
alone within 2e-5 of its largest magnitude: the port's expanded form
(|x|^2 - 2x.c + |c|^2, then A^T x - (sum A) c) rounds in other places than
the reference's residual tensor, and |x|^2 grows with C (512 at EncNet's
head), so f32 cancellation in d^2 takes a few more ulps than the direct
form.  ENet's argmax indices are bitwise.
"""
import glob
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlxcv_tpu import config as JC
from tlxcv_tpu import nn as jnn
from tlxcv_tpu.core import split
from tlxcv_tpu.models.backbones import resnet_vd as JR
from tlxcv_tpu_torch import build_seg_model, create_model, list_models
from tlxcv_tpu_torch.models.backbones import resnet_vd as TR
from tlxcv_tpu_torch.nn import layers as T
from tlxcv_tpu_torch.ops import image as TI
from tlxcv_tpu_torch.tasks import ImageSegmentation
from tlxcv_tpu_torch.utils import load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: these micro models' small ops gain nothing
    from more, and several test processes share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _mods(name):
    """The JAX and the port's module ``models.segmentation.<name>`` (the
    packages export factories that shadow some module names)."""
    return (importlib.import_module(f"tlxcv_tpu.models.segmentation.{name}"),
            importlib.import_module(
                f"tlxcv_tpu_torch.models.segmentation.{name}"))


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


def _pair(jm, tm, rng):
    _random_bn(jm, rng)
    load_jax_params(tm, _flat(jm))
    return jm, tm.eval()


def _no_dropout(jm, tm):
    for _, mod in jm.modules():
        if isinstance(mod, jnn.Dropout):
            mod.p = 0.0
    for mod in tm.modules():
        if isinstance(mod, T.Dropout):
            mod.p = 0.0


def _close(got, want, bound=2e-4):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=bound * np.abs(want).max())


def _run(jm, tm, x, training=False):
    """Both models on ``x``: eval, or train mode with dropout off."""
    if training:
        _no_dropout(jm, tm)
        tm.train()
        with jm.train():
            want = jm(jnp.asarray(x))
    else:
        want = jm(jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    return got, want


def _check(got, want):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
    else:
        _close(got, want)


def _image(rng, hw=64, c=3, n=2):
    return rng.normal(size=(n, hw, hw, c)).astype(np.float32)


# ------------------------------------------------------------- ResNet-vD
@pytest.mark.parametrize("layers,os_", [(18, 8), (18, 32), (50, 8),
                                        (50, 16)])
def test_resnet_vd_matches_jax(rng, layers, os_):
    """Basic and bottleneck blocks, the avg-pool-first shortcut, and the
    output-stride dilations (the first block of a dilated stage at half
    its dilation)."""
    jm, tm = _pair(JR.ResNetVD(layers, output_stride=os_),
                   TR.ResNetVD(layers, output_stride=os_, device="cpu"), rng)
    got, want = _run(jm, tm, _image(rng, 32))
    strides = {8: (4, 8, 8, 8), 16: (4, 8, 16, 16), 32: (4, 8, 16, 32)}[os_]
    for g, w, s, c in zip(got, want, strides, tm.feat_channels):
        assert g.shape == (2, 32 // s, 32 // s, c)
        _close(g, w)


def test_resnet_vd_dilations_follow_the_reference():
    tm = TR.ResNetVD(50, output_stride=8, device="cpu")
    firsts = [stage[0].conv1.conv.dilation[0] for stage in tm.stages]
    rest = [stage[1].conv1.conv.dilation[0] for stage in tm.stages]
    assert firsts == [1, 1, 1, 2] and rest == [1, 1, 2, 4]
    assert tm.stages[1][0].short.avg is not None  # vD: pool, then 1x1
    assert tm.stages[0][0].short.avg is None      # the first stage: none


# ------------------------------------------------------------- BiSeNetV2
@pytest.mark.parametrize("training", [False, True])
def test_bisenetv2_matches_jax(rng, training):
    jb, tb = _mods("bisenet")
    jm, tm = _pair(jb.BiSeNetV2(num_classes=5),
                   tb.BiSeNetV2(num_classes=5, device="cpu"), rng)
    got, want = _run(jm, tm, _image(rng), training)
    if training:  # the logits and the four auxiliary heads'
        assert len(want) == 5
    else:
        assert got.shape == (2, 64, 64, 5)
    _check(got, want)


# ------------------------------------------------------------------ UNet
def test_unet_matches_jax(rng):
    ju, tu = _mods("unet")
    kw = dict(channels=1, num_classes=3, layer_depth=3, filters_root=8)
    jm, tm = _pair(ju.Unet(**kw), tu.Unet(**kw, device="cpu"), rng)
    got, want = _run(jm, tm, _image(rng, 92, c=1))
    assert got.shape == (2, 52, 52, 3)  # valid padding: 40 px smaller
    _check(got, want)


def test_unet_depth4_and_crop_concat(rng):
    ju, tu = _mods("unet")
    kw = dict(channels=2, num_classes=2, layer_depth=4, filters_root=4,
              padding="SAME")
    jm, tm = _pair(ju.Unet(**kw), tu.Unet(**kw, device="cpu"), rng)
    got, want = _run(jm, tm, _image(rng, 32, c=2))
    _check(got, want)
    a = rng.normal(size=(1, 6, 4, 2)).astype(np.float32)
    b = rng.normal(size=(1, 11, 9, 3)).astype(np.float32)
    _close(tu.crop_concat(torch.from_numpy(a), torch.from_numpy(b)),
           ju.crop_concat(jnp.asarray(a), jnp.asarray(b)), 0)


# -------------------------------------------------------------- Fast-SCNN
@pytest.mark.parametrize("aux", [False, True])
def test_fast_scnn_matches_jax(rng, aux):
    """With ``enable_auxiliary_loss`` the reference returns [logits, aux]
    in eval too."""
    jf, tf = _mods("fast_scnn")
    jm, tm = _pair(jf.FastSCNN(4, enable_auxiliary_loss=aux),
                   tf.FastSCNN(4, enable_auxiliary_loss=aux, device="cpu"),
                   rng)
    got, want = _run(jm, tm, _image(rng, 96))
    _check(got, want)


# ----------------------------------------------------------- DeepLabV3(+)
def test_deeplabv3p_matches_jax(rng):
    jd, td = _mods("deeplab")
    jm, tm = _pair(
        jd.DeepLabV3P(5, backbone=JR.resnet18_vd()),
        td.DeepLabV3P(5, backbone=TR.resnet18_vd(device="cpu"),
                      device="cpu"), rng)
    got, want = _run(jm, tm, _image(rng))
    assert got.shape == (2, 64, 64, 5)
    _check(got, want)


def test_deeplabv3_matches_jax(rng):
    jd, td = _mods("deeplab")
    jm, tm = _pair(
        jd.DeepLabV3(4, backbone=JR.resnet18_vd(output_stride=16)),
        td.DeepLabV3(4, backbone=TR.resnet18_vd(output_stride=16,
                                                device="cpu"),
                     device="cpu"), rng)
    got, want = _run(jm, tm, _image(rng))
    _check(got, want)


# ------------------------------------------------- FastFCN, EncNet, Encoding
@pytest.mark.parametrize("c,scale", [(64, 1.0), (512, 1.0), (512, 3.0)])
def test_encoding_expanded_form_matches_the_residual_form(rng, c, scale):
    jf, tf = _mods("fastfcn")
    je = jf.Encoding(c, 32)
    te = tf.Encoding(c, 32, device="cpu")
    load_jax_params(te, _flat(je))
    x = np.maximum(rng.normal(size=(2, 16, 16, c)) * scale, 0) \
        .astype(np.float32)
    want = np.asarray(je(jnp.asarray(x)))
    with torch.no_grad():
        got = te(torch.from_numpy(x))
    assert got.shape == (2, 32, c) and got.dtype == torch.float32
    _close(got, want, 2e-5)


def test_encoding_takes_bf16_and_keeps_f32_statistics(rng):
    _, tf = _mods("fastfcn")
    te = tf.Encoding(64, 32, device="cpu")
    x = torch.from_numpy(np.maximum(rng.normal(size=(1, 8, 8, 64)), 0)
                         .astype(np.float32))
    with torch.no_grad():
        want = te(x)
        te.to(torch.bfloat16)
        got = te(x.to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(got.float(), want.numpy(), 3e-2)


@pytest.mark.parametrize("os_,training", [(8, False), (32, False),
                                          (8, True)])
def test_fastfcn_matches_jax(rng, os_, training):
    """os8: JPU's resizes of C4 and C5 are identities; os32: real
    resizes.  In training with the auxiliary loss: logits, the auxiliary
    head's and the semantic-encoding logits."""
    jf, tf = _mods("fastfcn")
    kw = dict(enable_auxiliary_loss=training)
    jm, tm = _pair(
        jf.FastFCN(6, backbone=JR.resnet18_vd(output_stride=os_), **kw),
        tf.FastFCN(6, backbone=TR.resnet18_vd(output_stride=os_,
                                              device="cpu"),
                   device="cpu", **kw), rng)
    got, want = _run(jm, tm, _image(rng), training)
    if training:
        assert [tuple(g.shape) for g in got] == [(2, 64, 64, 6)] * 2 + [
            (2, 6)]
    _check(got, want)


def test_jpu_resize_is_an_identity_at_one_stride(rng):
    _, tf = _mods("fastfcn")
    x = torch.randn(1, 8, 8, 4)
    assert TI.interpolate(x, size=(8, 8), mode="bilinear") is x
    jpu = tf.JPU((4, 4, 4), width=8, device="cpu").eval()
    with torch.no_grad():
        assert jpu([x, x, x]).shape == (1, 8, 8, 32)


@pytest.mark.parametrize("training", [False, True])
def test_encnet_matches_jax(rng, training):
    je, te = _mods("encnet")
    kw = dict(enable_auxiliary_loss=training)
    jm, tm = _pair(je.ENCNet(5, backbone=JR.resnet18_vd(), **kw),
                   te.ENCNet(5, backbone=TR.resnet18_vd(device="cpu"),
                             device="cpu", **kw), rng)
    got, want = _run(jm, tm, _image(rng), training)
    _check(got, want)


# ------------------------------------------------------------------ ENet
def test_enet_matches_jax(rng):
    je, te = _mods("enet")
    jm, tm = _pair(je.ENet(num_classes=5), te.ENet(num_classes=5,
                                                   device="cpu"), rng)
    got, want = _run(jm, tm, _image(rng))
    assert got.shape == (2, 64, 64, 5)
    _check(got, want)


def test_enet_down_block_indices_are_bitwise(rng):
    """The down block's pool indices (which the up block scatters through)
    on an input with ties, and its zero-padded channels."""
    je, te = _mods("enet")
    jm, tm = _pair(je.Bottleneck(16, 64, kind="down"),
                   te.Bottleneck(16, 64, kind="down", device="cpu"), rng)
    x = np.maximum(rng.integers(-2, 3, size=(2, 16, 16, 16)), 0) \
        .astype(np.float32)
    want, want_idx = jm(jnp.asarray(x))
    with torch.no_grad():
        got, got_idx = tm(torch.from_numpy(x))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    _close(got, want)


@pytest.mark.parametrize("kind,kw", [("up", {}), ("asymmetric",
                                                 {"kernel_size": 5}),
                                     ("dilated", {"dilation": 2})])
def test_enet_bottlenecks_match_jax(rng, kind, kw):
    je, te = _mods("enet")
    cout = 8 if kind == "up" else 16
    jm, tm = _pair(je.Bottleneck(16, cout, kind=kind, **kw),
                   te.Bottleneck(16, cout, kind=kind, device="cpu", **kw),
                   rng)
    x = _image(rng, 8, c=16)
    if kind == "up":
        _, idx = je.Bottleneck(cout, cout, kind="down").__call__(
            jnp.asarray(_image(rng, 16, c=cout)))
        want = jm(jnp.asarray(x), indices=idx, output_hw=(16, 16))
        with torch.no_grad():
            got = tm(torch.from_numpy(x), indices=torch.from_numpy(
                np.array(idx)), output_hw=(16, 16))
    else:
        want = jm(jnp.asarray(x))
        with torch.no_grad():
            got = tm(torch.from_numpy(x))
    _close(got, want)


# --------------------------------------------------- task, registry, YAMLs
def test_task_predict_and_registry(rng):
    """``create_model("deeplabv3p")`` builds the reference factory's model
    (resnet50_vd at output stride 8), served through the task."""
    jd, _ = _mods("deeplab")
    assert {"deeplabv3", "deeplabv3p", "fastfcn", "unet", "bit",
            "hrnet_seg_w18", "hrnet_seg_w48"} <= set(list_models())
    jm = jd.deeplabv3p(3)
    _random_bn(jm, rng)
    tm = create_model("deeplabv3p", device="cpu", num_classes=3)
    assert type(tm).__name__ == "DeepLabV3P"
    load_jax_params(tm, _flat(jm))
    x = _image(rng, 32)
    with torch.no_grad():
        got = ImageSegmentation(tm).eval().predict(torch.from_numpy(x))
    _close(got, jm(jnp.asarray(x)))


YAMLS = sorted(p for p in glob.glob(os.path.join(
    ROOT, "configs", "segmentation", "*", "*.yml")) if "_base_" not in p)


@pytest.mark.parametrize("path", YAMLS,
                         ids=[os.path.basename(p) for p in YAMLS])
def test_build_seg_model_builds_what_the_reference_builds(path):
    """The model type, and every parameter and statistic by path and
    shape (the bridge's strict load), so the head's width too."""
    jm = JC.build_seg_model(path)
    tm = build_seg_model(path, device="cpu")
    assert type(tm).__name__ == type(jm).__name__
    load_jax_params(tm, _flat(jm))


def test_load_seg_config_follows_base(tmp_path):
    path = os.path.join(ROOT, "configs", "segmentation", "fastfcn",
                        "fastfcn_resnet50_os8_ade20k_480x480_120k.yml")
    from tlxcv_tpu_torch import load_seg_config

    cfg = load_seg_config(path)
    assert cfg == JC.load_seg_config(path)
    assert cfg["num_classes"] == 150 and "_base_" not in cfg
