"""The port's face models and face-detection utilities against the JAX
package on the CPU: RetinaFace-R50 (its FPN merging through the
upsample-add at 2x and at other ratios), its ``multi_box_loss`` with tied
hard negatives, ArcFace on a ResNet-18 with its margin head, the priors,
the ``Encoder``/``Decoder`` pair, the numpy NMS, the post-process and
``detect_faces``.

Micro size: RetinaFace at its full width (ResNet-50, FPN 256) on 64 px
and 72 px frames (levels 8, 4, 2 and 9, 5, 3: at 72 px neither merge is
2x), b2; ArcFace on ResNet-18 at 64 px with a 32-wide embedding and 10
classes, as ``tests/test_face_pose_video.py`` builds it, b4.  Weights are
the JAX model's, copied by the bridge, every BatchNorm's statistics and
affine drawn from a numpy seed first; RetinaFace's class convs drawn so
that its scores spread.  The JAX side runs under ``jax.jit``.

Tolerances: model outputs in f32 within 2e-4 of their largest magnitude
(``tests/test_parity_resnet.py:91``); the upsample-add, the priors, the
encoding, NMS, the post-process and the hard-negative choice exactly; the
losses and the margin logits within 1e-5 relative; ``detect_faces``'s
boxes within 1e-3 pixel, its resize within 1e-4 of the image's range of
``cv2.resize``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_cls_attention import _few_threads  # noqa: F401
from tests.test_torch_cls_classic import zero_init  # noqa: F401
from tests.test_torch_seg_zoo import _close, _flat, _random_bn
from tlxcv_tpu.config import create_model as jax_create_model
from tlxcv_tpu.core import pure, split
from tlxcv_tpu.models.classification import resnet18 as jax_resnet18
from tlxcv_tpu.models.face_recognition import ArcFace as JArcFace
from tlxcv_tpu.models.face_recognition import RetinaFace as JRetinaFace
from tlxcv_tpu.models.face_recognition import multi_box_loss as jax_loss
from tlxcv_tpu.ops.image import upsample_add as jax_upsample_add
from tlxcv_tpu.tasks import face_recognition as JT
from tlxcv_tpu_torch import create_model
from tlxcv_tpu_torch.models.classification import resnet18
from tlxcv_tpu_torch.models.face_recognition import (ArcFace, RetinaFace,
                                                     hard_negatives,
                                                     multi_box_loss)
from tlxcv_tpu_torch.models.ocr import resize_linear
from tlxcv_tpu_torch.ops.image import upsample_add
from tlxcv_tpu_torch.tasks import face_recognition as TT
from tlxcv_tpu_torch.utils import load_jax_params


def _jit(jm, method=None):
    fn = pure(jm) if method is None else pure(jm, method)
    return jax.jit(lambda p, s, *a: fn(p, s, *a)[0])


@pytest.fixture(scope="module")
def retinaface():
    """RetinaFace at 64 px and its port, BatchNorm statistics drawn, the
    class convs drawn at std 0.05 (at init every score sits near 1/2) and
    the box convs at 0.002 (so that the decoded boxes stay near their
    priors)."""
    rng = np.random.default_rng(5)
    jm = JRetinaFace(input_size=64)
    _random_bn(jm, rng)
    for heads, std in ((jm.classheads, 0.05), (jm.bboxheads, 0.002)):
        for head in heads:
            head.conv.weight.value = jnp.asarray(
                rng.normal(scale=std, size=head.conv.weight.value.shape),
                jnp.float32)
    tm = RetinaFace(input_size=64, device="cpu")
    load_jax_params(tm, _flat(jm))
    return jm, tm.eval(), _jit(jm)


@pytest.mark.parametrize("size", [64, 72])
def test_retinaface_outputs_match_jax(rng, retinaface, size):
    jm, tm, fwd = retinaface
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    want = fwd(*split(jm), jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    priors = JT.prior_box((size, size))
    for g, w, k in zip(got, want, (4, 10, 2)):
        assert g.shape == (2, priors.shape[0], k)
        _close(g, w)
    np.testing.assert_allclose(got[2].sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("x_hw,out_hw", [((19, 19), (38, 38)),
                                         ((38, 38), (75, 75)),
                                         ((3, 3), (5, 5)), ((5, 5), (9, 9)),
                                         ((4, 7), (8, 13))])
def test_nearest_upsample_add_is_the_references(rng, x_hw, out_hw):
    """The FPN's merge, bitwise: the reference's 2x ``jax.image.resize``
    and its floor rule elsewhere (38 -> 75 at a 600 px frame) against the
    port's one floor rule (the kernel's plain version on the CPU)."""
    x = rng.normal(size=(2, *x_hw, 8)).astype(np.float32)
    skip = rng.normal(size=(2, *out_hw, 8)).astype(np.float32)
    got = upsample_add(torch.from_numpy(x), torch.from_numpy(skip),
                       mode="nearest")
    want = jax_upsample_add(jnp.asarray(x), jnp.asarray(skip),
                            mode="nearest")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _loss_inputs(rng, batch=2, priors=40):
    """Targets with few positives, ignored priors (class -1) and negatives
    whose background probability is exactly 1 (loss 0, tied with every
    prior that is not a negative), so that the hard negatives are chosen
    among ties."""
    y = rng.normal(size=(batch, priors, 16)).astype(np.float32)
    cls = np.zeros((batch, priors), np.float32)
    cls[:, [3, 17]] = 1
    cls[:, [5, 6, 30, 31, 32]] = -1
    y[..., 15] = cls
    y[..., 14] = rng.integers(0, 2, size=(batch, priors))
    p0 = np.ones((batch, priors), np.float32)
    p0[:, [1, 9, 22]] = rng.uniform(0.2, 0.9, size=(batch, 3))
    p0[:, [5, 6, 30, 31, 32]] = rng.uniform(0.1, 0.9, size=(batch, 5))
    p0[:, [12, 13]] = 0.5  # a tie that is not at 0
    probs = np.stack([p0, 1 - p0], -1).astype(np.float32)
    loc = rng.normal(size=(batch, priors, 4)).astype(np.float32)
    landm = rng.normal(size=(batch, priors, 10)).astype(np.float32)
    return y, (loc, landm, probs)


def _jax_hard_negatives(y, probs, ratio=3):
    """The reference's choice (``retinaface.py:108-113``), spelled out."""
    cls = jnp.asarray(y[..., 15])
    mask_pos, mask_neg = cls == 1, cls == 0
    loss_class = jnp.where(mask_neg, 1 - jnp.asarray(probs)[..., 0], 0.0)
    rank = jnp.argsort(jnp.argsort(-loss_class, axis=1), axis=1)
    num_pos = jnp.maximum(mask_pos.sum(axis=1, keepdims=True), 1)
    return np.asarray(rank < jnp.minimum(ratio * num_pos, cls.shape[1] - 1))


@pytest.mark.parametrize("ratio", [1, 3, 7])
def test_multi_box_loss_ties_choose_the_references_negatives(rng, ratio):
    y, pred = _loss_inputs(rng)
    t_pred = tuple(torch.from_numpy(a) for a in pred)
    yt = torch.from_numpy(y)
    chosen = hard_negatives(t_pred[2], yt[..., 15] == 1, yt[..., 15] == 0,
                            ratio)
    np.testing.assert_array_equal(chosen.numpy(),
                                  _jax_hard_negatives(y, pred[2], ratio))
    got = multi_box_loss(yt, t_pred, ratio)
    want = jax_loss(jnp.asarray(y), tuple(jnp.asarray(a) for a in pred),
                    ratio)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-6)


def test_retinaface_loss_fn_matches_jax(rng, retinaface):
    jm, tm, _ = retinaface
    y, pred = _loss_inputs(rng)
    got = tm.loss_fn(tuple(torch.from_numpy(a) for a in pred),
                     torch.from_numpy(y))
    want = jm.loss_fn(tuple(jnp.asarray(a) for a in pred), jnp.asarray(y))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("size", [(64, 64), (72, 72), (600, 600),
                                  (96, 64)])
def test_prior_box_is_the_references(size):
    got, want = TT.prior_box(size), JT.prior_box(size)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TT.prior_box(size, clip=True),
                                  JT.prior_box(size, clip=True))


def _faces(rng, n):
    """``n`` face labels: normalised xyxy boxes, 10 landmark coordinates
    inside them, landmark valid."""
    lt = rng.uniform(0.05, 0.6, size=(n, 2))
    wh = rng.uniform(0.1, 0.35, size=(n, 2))
    pts = lt[:, None] + rng.uniform(0, 1, size=(n, 5, 2)) * wh[:, None]
    return np.concatenate([lt, lt + wh, pts.reshape(n, 10),
                           (rng.uniform(size=(n, 1)) > 0.3)], 1).astype(
        np.float32)


@pytest.mark.parametrize("n", [1, 3, 8])
def test_encoder_decoder_round_trip_matches_jax(rng, n):
    priors = TT.prior_box((128, 128))
    labels = _faces(rng, n)
    got = TT.Encoder(priors)(labels)
    np.testing.assert_array_equal(got, JT.Encoder(priors)(labels))
    pos = got[:, 15] == 1
    assert pos.any()
    dec = TT.Decocder()
    assert isinstance(dec, TT.Decoder)
    back = dec(got, priors)
    np.testing.assert_array_equal(back, JT.Decoder()(got, priors))
    # the matched faces come back on the positive priors
    overlaps = TT._jaccard(labels[:, :4], back[pos, :4])
    np.testing.assert_allclose(overlaps.max(0), 1.0, atol=1e-4)
    np.testing.assert_array_equal(back[:, 14:], got[:, 14:])


@pytest.mark.parametrize("threshold", [0.3, 0.4, 0.7])
def test_nms_np_is_the_references(rng, threshold):
    lt = rng.uniform(0, 80, size=(60, 2))
    boxes = np.concatenate([lt, lt + rng.uniform(5, 40, size=(60, 2))], 1)
    scores = rng.uniform(size=60)
    got = TT.nms_np(boxes, scores, threshold)
    np.testing.assert_array_equal(got, JT.nms_np(boxes, scores, threshold))
    assert list(TT.nms_np(np.asarray([[0, 0, 10, 10], [1, 1, 11, 11],
                                      [50, 50, 60, 60.0]]),
                          np.asarray([0.9, 0.8, 0.7]), 0.4)) == [0, 2]


@pytest.mark.parametrize("score_th", [0.3, 0.5, 1.0])
def test_post_process_is_the_references(rng, score_th):
    """One image's decode, threshold and NMS, bitwise the steps of the
    reference's ``detect_faces`` (``tasks/face_recognition.py``) spelled
    out with its own ``Decoder`` and ``nms_np``; none kept at 1."""
    side = 96
    priors = TT.prior_box((side, side))
    bbox = rng.normal(scale=0.5, size=(len(priors), 4)).astype(np.float32)
    face = rng.uniform(size=len(priors)).astype(np.float32)
    cls = np.stack([1 - face, face], 1)
    boxes, scores = TT.post_process(bbox, cls, priors, side, score_th, 0.4)
    want = JT.Decoder().decode_bbox(bbox, priors)
    m = cls[:, 1] > score_th
    want, want_scores = want[m], cls[m, 1]
    keep = (JT.nms_np(want * side, want_scores, 0.4) if m.any()
            else np.zeros(0, int))
    assert (len(keep) > 0) == (score_th < 1) and boxes.shape[1] == 4
    np.testing.assert_array_equal(boxes, want[keep] * side)
    np.testing.assert_array_equal(scores, want_scores[keep])


@pytest.mark.parametrize("hw,out", [((37, 53), (21, 30)), ((48, 64),
                                                            (48, 64)),
                                    ((30, 20), (96, 64))])
def test_resize_is_cv2_inter_linear(rng, hw, out):
    cv2 = pytest.importorskip("cv2")
    img = rng.uniform(0, 255, size=(*hw, 3)).astype(np.float32)
    got = resize_linear(img, out)
    want = cv2.resize(img, (out[1], out[0]))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * 255)


def test_detect_faces_matches_jax(rng, retinaface):
    pytest.importorskip("cv2")
    jm, tm, fwd = retinaface
    image = rng.uniform(0, 255, size=(48, 40, 3)).astype(np.float32)

    class Jitted:  # the reference's ``trainer.predict`` route, compiled
        @staticmethod
        def predict(x):
            return fwd(*split(jm), jnp.asarray(x))

    want = JT.detect_faces(image, jm, trainer=Jitted, score_th=0.5,
                           input_size=64)
    got = TT.detect_faces(image, tm, score_th=0.5, input_size=64)
    assert len(want) > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.fixture(scope="module")
def arcface():
    rng = np.random.default_rng(6)
    jm = JArcFace(input_size=64, embed_size=32, num_classes=10,
                  backbone=jax_resnet18(num_classes=0, with_pool=False))
    _random_bn(jm, rng)
    tm = ArcFace(input_size=64, embed_size=32, num_classes=10,
                 backbone=resnet18(num_classes=0, with_pool=False,
                                   device="cpu"), device="cpu")
    load_jax_params(tm, _flat(jm))
    return jm, tm.eval(), _jit(jm, lambda m, x: m.embed(x))


def test_arcface_embedding_margin_and_loss_match_jax(rng, arcface):
    jm, tm, embed = arcface
    x = rng.normal(size=(4, 64, 64, 3)).astype(np.float32)
    labels = np.asarray([0, 1, 2, 9], np.int32)
    want = embed(*split(jm), jnp.asarray(x))
    with torch.no_grad():
        got = tm.embed(torch.from_numpy(x))
    _close(got, want)
    np.testing.assert_allclose(got.norm(dim=1).numpy(), 1.0, atol=1e-5)
    # the head and the loss on the same embeddings
    e, lab = np.array(want), torch.from_numpy(labels)
    with torch.no_grad():
        for margin in (None, 0.5, 0.0, 0.3, torch.tensor(0.2)):
            jmargin = (None if margin is None else
                       jnp.float32(float(margin)))
            g = tm.head(torch.from_numpy(e), lab, margin=margin)
            w = jm.head(jnp.asarray(e), jnp.asarray(labels), margin=jmargin)
            _close(g, w, 1e-5)
            gl = tm.loss_fn(torch.from_numpy(e), lab, margin=margin)
            wl = jm.loss_fn(jnp.asarray(e), jnp.asarray(labels),
                            margin=jmargin)
            np.testing.assert_allclose(gl.item(), float(wl), rtol=1e-5)
        # the margin only lowers the labelled class's logit
        plain = tm.head(torch.from_numpy(e), lab, margin=0.0)
        marg = tm.head(torch.from_numpy(e), lab)
        rows = torch.arange(4)
        assert (marg[rows, lab] <= plain[rows, lab] + 1e-3).all()
        off = torch.ones_like(plain, dtype=torch.bool)
        off[rows, lab] = False
        assert torch.equal(marg[off], plain[off])
        logits = tm(torch.from_numpy(x), lab)
    _close(logits, jm.head(want, jnp.asarray(labels)))


def test_arcface_bridge_keeps_the_head_weight_untransposed(arcface):
    jm, tm, _ = arcface
    assert tuple(tm.head.weight.shape) == (32, 10)
    np.testing.assert_array_equal(tm.head.weight.detach().numpy(),
                                  np.asarray(jm.head.weight.value))
    assert set(k.replace("/", ".") for k in _flat(jm)) == set(
        tm.state_dict())


def test_arcface_at_112_fails_as_the_reference_does(rng):
    """A defect of the reference kept on purpose: ``ArcFace()``'s dense
    layer is sized for a 3 x 3 map (``112 // 32``), but ResNet-50 leaves
    4 x 4 at 112 px, so both packages fail at that layer."""
    jm = JArcFace(num_classes=10)
    x = rng.normal(size=(1, 112, 112, 3)).astype(np.float32)
    assert jm.dense.weight.value.shape[0] == 2048 * 9
    with pytest.raises(TypeError, match="32768.*18432"):
        jax.eval_shape(lambda v: pure(jm, lambda m, a: m.embed(a))(
            *split(jm), v), jnp.asarray(x))
    tm = ArcFace(num_classes=10, device="cpu").eval()
    with pytest.raises(RuntimeError, match="1x32768 and 18432x512"):
        with torch.no_grad():
            tm.embed(torch.from_numpy(x))


@pytest.mark.parametrize("name", ["retinaface", "arcface"])
def test_registry_builds(zero_init, name):
    """The face models under the JAX names, with the JAX models'
    parameter counts."""
    model = create_model(name, device="cpu")
    count = sum(a.size for a in _flat(jax_create_model(name)).values())
    assert sum(p.numel() for p in model.state_dict().values()) == count
