"""The port's RetinaNet, GFL and TOOD against the JAX package on the CPU:
the head outputs, the detections and ``loss_fn`` at 64 px and at 80 x 104
(a frame whose pyramid levels are not in 2:1 ratios), and the helpers
each on its own: the anchors, ``retina_match``'s IoU bands, GFL's
``integral`` and TOOD's task decomposition.

Micro size, the JAX package's own (``tests/test_det_zoo2.py:12-16``): a
ResNet-18 trunk and 5 classes, the published heads (256 wide).  Weights
are the JAX model's, copied by the bridge; BatchNorm statistics are drawn
from a numpy seed.  The score-bearing convs are redrawn (at their
normal(0.01) init every score sits at the 0.01 prior, under the 0.025 and
0.05 thresholds, and no box would be kept); the box convs too, so that
boxes differ from their anchors.  The JAX side runs under ``jax.jit``,
one build per model and frame.

Tolerance: f32 within 2e-4 of the largest magnitude
(``tests/test_parity_resnet.py:91``); the loss within 2e-4 relative;
detections' labels and counts equal; matches and integer maps equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_fcos import _draw, _images, _targets
from tests.test_torch_seg_zoo import _close, _flat, _random_bn
from tlxcv_tpu.core import pure, split
from tlxcv_tpu.models.classification.resnet import ResNet as JResNet
from tlxcv_tpu.models.detection import gfl as JG
from tlxcv_tpu.models.detection import retinanet as JR
from tlxcv_tpu.models.detection import tood as JT
from tlxcv_tpu_torch import create_model, list_models
from tlxcv_tpu_torch.models.classification.resnet import ResNet
from tlxcv_tpu_torch.models.detection import gfl as TG
from tlxcv_tpu_torch.models.detection import retinanet as TR
from tlxcv_tpu_torch.models.detection import tood as TT
from tlxcv_tpu_torch.utils import load_jax_params

FRAMES = [(64, 64), (80, 104)]
FRAME_IDS = ["64x64", "80x104"]
# the detection zoo's registry names (``tlxcv_tpu/config.py:65-80``)
REGISTERED = ["retinanet", "faster_rcnn", "cascade_rcnn", "gfl_r50",
              "yolox_nano", "yolox_tiny", "yolox_s", "yolox_m", "yolox_l",
              "yolox_x", "tood_r50", "centernet", "ttfnet", "picodet_lcnet",
              "solov2_r50"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: these micro models' small ops gain nothing
    from more, and several test processes share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _trunks():
    return (JResNet(depth=18, num_classes=0, with_pool=False),
            ResNet(depth=18, num_classes=0, with_pool=False, device="cpu"))


def bridged(jm, tm, rng, draws):
    """BatchNorm statistics and the listed convs drawn on the JAX model,
    every weight copied into the port's; the port in eval mode."""
    _random_bn(jm, rng)
    for conv, std in draws(jm):
        _draw(conv, std, rng)
    load_jax_params(tm, _flat(jm))
    return jm, tm.eval()


def leaves(tree):
    """The tensors of nested tuples and lists, depth first."""
    if isinstance(tree, (tuple, list)):
        return [t for sub in tree for t in leaves(sub)]
    return [tree]


def run_jax(jm, fn, x, tg):
    """``fn(model, images, targets)`` of the JAX model under ``jax.jit``."""
    out, _ = jax.jit(lambda p, s, v, t: pure(jm, fn)(p, s, v, t))(
        *split(jm), jnp.asarray(x), {k: jnp.asarray(v) for k, v in tg.items()})
    return out


def run_port(tm, fn, x, tg):
    with torch.no_grad():
        return fn(tm, torch.from_numpy(x),
                  {k: torch.from_numpy(v) for k, v in tg.items()})


def check_dets(got, want, min_count=1):
    """(dets [B, K, 6], counts [B]): counts and labels equal, scores and
    boxes within the bound."""
    (tdets, tcounts), (jdets, jcounts) = got, want
    assert tcounts.tolist() == np.asarray(jcounts).tolist()
    assert min(tcounts.tolist()) >= min_count
    jdets = np.asarray(jdets)
    np.testing.assert_array_equal(tdets[..., 0].numpy(), jdets[..., 0])
    _close(tdets[..., 1], jdets[..., 1])
    _close(tdets[..., 2:], jdets[..., 2:])


def check_stages(got, want):
    """(head tensors, detections, loss) of the port against the JAX
    model's."""
    (th, tdets, tloss), (jh, jdets, jloss) = got, want
    th, jh = leaves(th), leaves(jh)
    assert len(th) == len(jh)
    for t, j in zip(th, jh):
        _close(t, j)
    check_dets(tdets, jdets)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=2e-4)


# -------------------------------------------------------------- the models
def _retina_draws(m):
    return ((m.head.cls_pred, 0.3), (m.head.reg_pred, 0.05))


def _gfl_draws(m):
    return ((m.head.cls_pred, 0.1), (m.head.reg_pred, 0.05))


def _tood_draws(m):
    return ((m.head.cls_pred, 0.1), (m.head.cls_prob_conv2, 0.1),
            (m.head.reg_pred, 0.05), (m.head.reg_offset_conv2, 0.02))


def _j_retina(m, x, tg):
    cls, reg, hws = m.head_outputs(x)
    out = {"cls_logits": cls, "deltas": reg,
           "anchors": jnp.asarray(m._anchors(hws))}
    return (cls, reg), m(x), m.loss_fn(out, tg)


def _t_retina(m, x, tg):
    cls, reg, hws = m.head_outputs(x)
    anchors = m.anchors(hws, x.device)
    dets = m.nms(*m.decode(cls, reg, anchors, tuple(x.shape[1:3])))
    out = {"cls_logits": cls, "deltas": reg, "anchors": anchors}
    return (cls, reg), dets, m.loss_fn(out, tg)


def _j_dense(m, x, tg):
    outs, hws = m.head_outputs(x)
    return outs, m(x), m.loss_fn({"outs": outs, "feat_hws": hws}, tg)


def _t_dense(m, x, tg):
    outs, hws = m.head_outputs(x)
    dets = m.nms(*m.decode(outs, hws, tuple(x.shape[1:3])))
    return outs, dets, m.loss_fn({"outs": outs, "feat_hws": hws}, tg)


MODELS = {
    "retinanet": (JR.RetinaNet, TR.RetinaNet, _retina_draws, _j_retina,
                  _t_retina),
    "gfl": (JG.GFL, TG.GFL, _gfl_draws, _j_dense, _t_dense),
    "tood": (JT.TOOD, TT.TOOD, _tood_draws, _j_dense, _t_dense),
}


@pytest.fixture(scope="module")
def pairs():
    """Each model's (JAX, port) pair, built once."""
    cache = {}

    def get(name):
        if name not in cache:
            jcls, tcls, draws = MODELS[name][:3]
            jb, tb = _trunks()
            cache[name] = bridged(
                jcls(num_classes=5, backbone=jb),
                tcls(num_classes=5, backbone=tb, device="cpu"),
                np.random.default_rng(len(cache) + 11), draws)
        return cache[name]
    return get


@pytest.mark.parametrize("hw", FRAMES, ids=FRAME_IDS)
@pytest.mark.parametrize("name", list(MODELS))
def test_detector_matches_jax(rng, pairs, name, hw):
    """Every head output, the detections and ``loss_fn``."""
    jm, tm = pairs(name)
    jfn, tfn = MODELS[name][3:]
    x = _images(rng, hw)
    tg = _targets(rng, hw=hw)
    check_stages(run_port(tm, tfn, x, tg), run_jax(jm, jfn, x, tg))


@pytest.mark.parametrize("name", list(MODELS))
def test_train_mode_returns_what_loss_fn_takes(pairs, name):
    _, tm = pairs(name)
    tm.train()
    try:
        with torch.no_grad():
            out = tm(torch.randn(1, 64, 96, 3))
    finally:
        tm.eval()
    assert out["image_hw"] == (64, 96)
    keys = {"cls_logits", "deltas", "anchors"} if name == "retinanet" \
        else {"outs", "feat_hws"}
    assert keys <= set(out)


# ------------------------------------------------------------- the helpers
@pytest.mark.parametrize("hw", FRAMES, ids=FRAME_IDS)
def test_anchors_are_the_references(hw):
    hws = tuple((-(-hw[0] // s), -(-hw[1] // s)) for s in TR.STRIDES)
    np.testing.assert_array_equal(TR._retina_anchors(hws),
                                  JR._retina_anchors(hws))
    ta, tc = TG._cell_anchors(hws)
    ja, jc = JG._cell_anchors(hws)
    np.testing.assert_array_equal(ta, ja)
    assert tc == jc
    for t, j in zip(TT._points(hws), JT._points(hws)):
        np.testing.assert_array_equal(t, j)


def test_retina_match_bands_match_jax(rng):
    """Anchors at IoUs across the 0.4 / 0.5 bands of three GTs and a
    padded row; one GT whose best anchor is under 0.4, forced positive."""
    gts = np.array([[10, 10, 50, 50], [60, 20, 90, 40], [5, 60, 12, 66],
                    [0, 0, 0, 0]], np.float32)
    valid = np.array([1, 1, 1, 0], np.float32)
    shifts = np.linspace(0, 30, 16, dtype=np.float32)
    slid = gts[:2, None] + np.stack([shifts, shifts * 0.3, shifts,
                                     shifts * 0.3], -1)[None]    # [2, 16, 4]
    corner = rng.uniform(0, 90, size=(24, 2)).astype(np.float32)
    anchors = np.concatenate([slid.reshape(-1, 4),
                              np.concatenate([corner, corner + 25], -1)])
    labels = np.array([1, 3, 2, 0], np.int32)
    want = jax.jit(JR.retina_match)(*map(jnp.asarray,
                                         (anchors, gts, labels, valid)))
    got = TR.retina_match(*map(torch.from_numpy,
                               (anchors, gts, labels, valid)))
    for t, j in zip(got, want):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    best_gt, pos, ignore = (t.numpy() for t in got)
    assert ignore.any() and (pos & ~ignore).sum() > 2
    assert pos[best_gt == 2].any()  # the small GT's forced best anchor
    assert not (best_gt[pos] == 3).any()


@pytest.mark.parametrize("reg_max", [7, 16])
def test_integral_matches_jax(rng, reg_max):
    logits = rng.normal(scale=3.0, size=(2, 9, 4 * (reg_max + 1))).astype(
        np.float32)
    want = JG.integral(jnp.asarray(logits), reg_max)
    got = TG.integral(torch.from_numpy(logits), reg_max)
    assert got.shape == (2, 9, 4)
    _close(got, want, bound=1e-6)


def test_task_decomposition_matches_jax(rng):
    jm = JT.TaskDecomposition(32, stacked=6, down_rate=8)
    tm = TT.TaskDecomposition(32, stacked=6, down_rate=8, device="cpu")
    load_jax_params(tm, _flat(jm))
    stack = rng.normal(size=(2, 5, 7, 192)).astype(np.float32)
    avg = stack.mean((1, 2), keepdims=True)
    want = jm(jnp.asarray(stack), jnp.asarray(avg))
    with torch.no_grad():
        got = tm(torch.from_numpy(stack), torch.from_numpy(avg))
    _close(got, want)


@pytest.mark.parametrize("name", REGISTERED)
def test_registry_builds_every_detector(name):
    """As ``tests/test_det_zoo2.py:188`` and ``tests/test_det_zoo3.py:155``
    for the JAX package; without a card, the default device raises."""
    assert name in list_models()
    m = create_model(name, device="cpu", num_classes=3)
    assert m.num_classes == 3
    assert next(m.parameters()).device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_model(name)
