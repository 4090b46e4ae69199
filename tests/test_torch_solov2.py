"""The port's SOLOv2 against the JAX package on the CPU: every level's
category and kernel maps, the mask feature, the eval output (the matrix
NMS's labels, scores, masks and counts) and both loss terms at 64 px and
at 80 x 104 (a frame whose pyramid levels are not in 2:1 ratios); the
matrix NMS and masks on their own inputs; and ``ops.image.resize_linear``
against ``jax.image.resize(..., "bilinear")`` at integer and non-integer
factors up and down, antialiased when it shrinks as ``F.interpolate``'s
bilinear is not.

Micro size, the JAX package's own (``tests/test_det_zoo4.py:120-130``): a
ResNet-18 trunk, 5 classes, 32 candidates, 10 kept, 16 dice slots.
Weights are the JAX model's, copied by the bridge; BatchNorm statistics
are drawn from a numpy seed.  The category classifier is redrawn at std
0.3 with its bias at -1 (at the 0.01 prior no score passes the 0.1
threshold) and the kernels at 0.1, so that masks differ.  The JAX side
runs under ``jax.jit``, one build per frame.

Tolerance: f32 within 2e-4 of the largest magnitude
(``tests/test_parity_resnet.py:91``); each loss term within 2e-4
relative; labels and counts equal; the resize in bf16 within half a
bf16 ulp of the reference's f32 resize of the same input.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_det_anchor import bridged, leaves, run_jax, run_port
from tests.test_torch_fcos import _images, _targets
from tests.test_torch_seg_zoo import _close
from tlxcv_tpu.models.classification.resnet import ResNet as JResNet
from tlxcv_tpu.models.detection import solov2 as JS
from tlxcv_tpu_torch import create_model
from tlxcv_tpu_torch.models.classification.resnet import ResNet
from tlxcv_tpu_torch.models.detection import solov2 as TS
from tlxcv_tpu_torch.ops.image import resize_linear

FRAMES = [(64, 64), (80, 104)]
MICRO = dict(num_classes=5, pre_top_k=32, keep_top_k=10, max_pos=16)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: these micro models' small ops gain nothing
    from more, and several test processes share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _draws(m):
    pred = m.head.cate_pred
    pred.bias.value = jnp.full(pred.bias.value.shape, -1.0, jnp.float32)
    return ((pred, 0.3), (m.head.kernel_pred, 0.1))


@pytest.fixture(scope="module")
def pair():
    return bridged(
        JS.SOLOv2(**MICRO, backbone=JResNet(depth=18, num_classes=0,
                                            with_pool=False)),
        TS.SOLOv2(**MICRO, device="cpu", backbone=ResNet(
            depth=18, num_classes=0, with_pool=False, device="cpu")),
        np.random.default_rng(51), _draws)


def _with_masks(rng, hw):
    """Two boxes an image, a padded row, and each box's mask: its
    rectangle, with a corner cut."""
    tg = _targets(rng, hw=hw)
    ys, xs = np.mgrid[:hw[0], :hw[1]]
    b = tg["boxes"][..., None, None]
    masks = ((xs >= b[..., 0, :, :]) & (xs < b[..., 2, :, :])
             & (ys >= b[..., 1, :, :]) & (ys < b[..., 3, :, :])
             & ~((xs < b[..., 0, :, :] + 3) & (ys < b[..., 1, :, :] + 3)))
    tg["masks"] = (masks & (tg["mask"][..., None, None] > 0)).astype(
        np.float32)
    return tg


def _stages(m, x, tg):
    outs, mfeat = m.head_outputs(x)
    out = {"outs": outs, "mask_feat": mfeat, "image_hw": tuple(x.shape[1:3])}
    parts = m.loss_parts(out, tg)
    return (outs, mfeat), m.post_process(outs, mfeat), \
        (parts["cate"], parts["dice"], m.loss_fn(out, tg))


def _check_eval(got, want, min_count=1):
    (tl, ts, tm_, tc), (jl, js, jm_, jc) = got, want
    assert tc.tolist() == np.asarray(jc).tolist()
    assert min(tc.tolist()) >= min_count
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    _close(ts, js)
    _close(tm_, jm_)


@pytest.mark.parametrize("hw", FRAMES, ids=["64x64", "80x104"])
def test_solov2_matches_jax(rng, pair, hw):
    jm, tm = pair
    x = _images(rng, hw)
    tg = _with_masks(rng, hw)
    (th, tev, tloss) = run_port(tm, _stages, x, tg)
    (jh, jev, jloss) = run_jax(jm, _stages, x, tg)
    th, jh = leaves(th), leaves(jh)
    assert len(th) == 11
    for t, j in zip(th, jh):
        _close(t, j)
    _check_eval(tev, jev)
    for t, j in zip(tloss, jloss):
        np.testing.assert_allclose(t.item(), float(j), rtol=2e-4)
    assert tloss[1].item() > 0  # positive cells reached the dice


def test_matrix_nms_and_masks_match_jax(rng, pair):
    """``post_process`` alone on drawn category logits, kernels and mask
    feature: masks overlapping within a class, so that the decay acts."""
    jm, tm = pair
    outs = [(rng.normal(scale=2.0, size=(2, s, s, 5)).astype(np.float32) - 1,
             rng.normal(size=(2, s, s, 128)).astype(np.float32))
            for s in TS.GRID_NUMS]
    feat = rng.normal(scale=0.3, size=(2, 20, 26, 128)).astype(np.float32)
    feat[..., :8] += 1.0  # shared structure: overlapping masks
    want = jax.jit(jm.post_process)(
        [tuple(map(jnp.asarray, o)) for o in outs], jnp.asarray(feat))
    got = tm.post_process([tuple(map(torch.from_numpy, o)) for o in outs],
                          torch.from_numpy(feat))
    _check_eval(got, want, min_count=3)


def test_assignment_matches_jax(pair):
    """The dense cell-to-GT map: GTs of every level's scale range, two
    contesting cells, one padded, and cell centres exactly on a centre
    region's edge (the large GT's, at 24 cells).  Against the reference
    run eagerly: under ``jax.jit`` XLA rounds the centres' arithmetic
    otherwise and moves those 4 edge cells out."""
    jm, tm = pair
    boxes = np.array([[10, 10, 60, 50], [20, 20, 40, 35], [0, 0, 300, 200],
                      [100, 30, 160, 120], [0, 0, 0, 0]], np.float32)
    labels = np.array([1, 2, 3, 4, 0], np.int32)
    valid = np.array([1, 1, 1, 1, 0], np.float32)
    jm._img_hw = (240, 320)  # the reference reads the frame off the model
    want = jm._assign(*map(jnp.asarray, (boxes, labels, valid)))
    got = tm._assign(torch.from_numpy(boxes), torch.from_numpy(labels).long(),
                     torch.from_numpy(valid), (240, 320))
    for t, j in zip(got, want):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assigned = got[0].numpy()
    assert set(assigned[assigned >= 0]) == {1, 2, 3}  # 1 takes 0's cells


@pytest.mark.parametrize("src,dst", [((336, 200), (40, 40)),
                                     ((100, 84), (36, 36)),
                                     ((16, 16), (40, 24)),
                                     ((13, 17), (26, 34)),
                                     ((50, 84), (200, 336)),
                                     ((7, 9), (12, 5))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resize_linear_is_jax_bilinear(rng, src, dst, dtype):
    """In bf16 against the reference's f32 resize of the same bf16 input:
    the port rounds its weights to bf16, as the reference does, and the
    whole product once, where the reference's einsum also rounds its
    intermediate pass."""
    x = torch.from_numpy(rng.normal(size=(2, *src, 3)).astype(np.float32)
                         ).to(getattr(torch, dtype))
    xf = x.float().numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(xf), (2, *dst, 3),
                                       "bilinear"))
    got = resize_linear(x, dst)
    assert got.dtype == x.dtype
    got = got.float().numpy()
    if dtype == "float32":
        _close(got, want, bound=2e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -8,
                                   atol=2e-3 * np.abs(want).max())
    if dst[0] < src[0]:  # shrinking: antialiased, unlike torch's default
        plain = F.interpolate(torch.from_numpy(xf).permute(0, 3, 1, 2),
                              size=dst, mode="bilinear").permute(0, 2, 3, 1)
        assert np.abs(plain.numpy() - want).max() > 1e-2


def test_resize_linear_takes_other_axes(rng):
    """SOLOv2's GT masks [B, M, H, W], resized over the last two axes."""
    x = (rng.uniform(size=(2, 3, 64, 80)) > 0.5).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, 3, 16, 20), "bilinear")
    _close(resize_linear(torch.from_numpy(x), (16, 20), axes=(2, 3)), want,
           bound=2e-6)


def test_registry_builds_solov2():
    m = create_model("solov2_r50", device="cpu", num_classes=3)
    assert m.head.cate_pred.weight.shape[0] == 3
    assert m.head.kernel_convs[0].weight.shape[1] == 256 + 2   # CoordConv
    assert m.mask_feat.convs[3].weight.shape[1] == 256 + 2
