"""The port's YOLOv3 against the JAX package on the CPU: ``yolo_box``, and
the reference's own micro detector of tests/test_yolov3.py,
``YOLOv3(num_classes=6, keep_top_k=20)`` (DarkNet-53 and the FPN at full
width), at 64^2 with random BatchNorm statistics, its weights carried
across by ``load_jax_params(strict=True)``.  Every stage is compared on the
same seeded f32 input; int8 YOLOv3 is quantized the way the JAX package's
bench builds it (``quantize_weights``, then ``calibrate_activations`` with
``forward=head_outputs``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from tlxcv_tpu import nn as jnn
from tlxcv_tpu.core import pure, split
from tlxcv_tpu.models.detection import YOLOv3 as JYOLOv3
from tlxcv_tpu.ops import quant as JQ
from tlxcv_tpu.ops.yolo import yolo_box as j_yolo_box
from tlxcv_tpu_torch import create_model
from tlxcv_tpu_torch.models.detection import YOLOv3
from tlxcv_tpu_torch.nn import layers as T
from tlxcv_tpu_torch.ops import quant as TQ
from tlxcv_tpu_torch.ops.cuda.matmul import int8_matmul_plain, requantize
from tlxcv_tpu_torch.ops.yolo import yolo_box
from tlxcv_tpu_torch.tasks import ObjectDetection
from tlxcv_tpu_torch.utils import load_jax_params

MICRO = dict(num_classes=6, keep_top_k=20)
HW = (64, 64)


def _flat(jax_module):
    params, state = split(jax_module)
    return {k: np.asarray(v) for k, v in {**params, **state}.items()}


def _bridged(rng, **kw):
    """A JAX YOLOv3 with random BatchNorm statistics and the port's copy."""
    jm = JYOLOv3(**kw)
    for _, mod in jm.modules():
        if isinstance(mod, jnn.BatchNorm):
            c = mod.running_mean.value.shape[0]
            mod.running_mean.value = jnp.asarray(
                rng.normal(scale=0.2, size=(c,)), jnp.float32)
            mod.running_var.value = jnp.asarray(
                rng.uniform(0.5, 2.0, size=(c,)), jnp.float32)
    tm = YOLOv3(**kw, device="cpu")
    load_jax_params(tm, _flat(jm), strict=True)
    return jm, tm.eval()


def _jax_run(jm, fn, x):
    out, _ = jax.jit(lambda p, s, v: pure(jm, fn)(p, s, v))(
        *split(jm), jnp.asarray(x))
    return out


def _assert_rel(got, want, rel, what=""):
    """max |got - want| <= rel * max |want|."""
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (what, err)


def _jax_decode(jm, outs):
    """The reference's post_process up to NMS (yolov3.py:361-375)."""
    n = outs[0].shape[0]
    img = jnp.broadcast_to(jnp.asarray([HW], jnp.int32), (n, 2))
    boxes, scores = [], []
    for li, (out, anchors, ds) in enumerate(zip(
            outs, jm.yolo_head.mask_anchors, jm.loss.downsamples)):
        out = jm.yolo_head.recombine_iou_aware(out, li)
        b, s = j_yolo_box(out, img, anchors, jm.num_classes,
                          conf_thresh=0.005, downsample_ratio=ds)
        boxes.append(b)
        scores.append(s)
    return jnp.concatenate(boxes, 1), jnp.concatenate(scores, 1)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    jm, tm = _bridged(rng, **MICRO)
    x = rng.normal(size=(2, *HW, 3)).astype(np.float32)
    want_feats = _jax_run(jm, lambda m, v: m.backbone(v), x)
    want_outs = _jax_run(jm, lambda m, v: m.head_outputs(v), x)
    with torch.no_grad():
        got_feats = tm.backbone(torch.from_numpy(x))
        got_outs = tm.head_outputs(torch.from_numpy(x))
    return jm, tm, x, want_feats, want_outs, got_feats, got_outs


# ---------------------------------------------------------------- yolo_box
@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("hw,ds", [((13, 13), 32), ((26, 20), 16)])
def test_yolo_box_matches_jax(rng, clip, hw, ds):
    """Boxes within 1e-3 px and scores within 1e-6 (f32 sigmoid and exp in
    two libraries), the conf_thresh zeros in the same places."""
    nc, anchors = 3, [10, 13, 16, 30, 33, 23]
    x = (2.0 * rng.normal(size=(2, *hw, 3 * (5 + nc)))).astype(np.float32)
    x[0, 0, 0, 4] = -8.0  # an objectness under conf_thresh
    img = np.asarray([[416, 416], [300, 500]], np.int32)
    want = j_yolo_box(jnp.asarray(x), jnp.asarray(img), anchors, nc,
                      downsample_ratio=ds, clip_bbox=clip)
    got = yolo_box(torch.from_numpy(x), torch.from_numpy(img), anchors, nc,
                   downsample_ratio=ds, clip_bbox=clip)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy() == 0,
                                  np.asarray(want[1]) == 0)
    if clip:
        assert float(got[0].min()) >= 0.0


# ------------------------------------------------------------- the model
def test_bridge_carries_every_tensor(pair):
    jm, tm = pair[:2]
    assert sorted(k.replace(".", "/") for k in tm.state_dict()) == \
        sorted(_flat(jm))


def test_darknet_features_match_jax(pair):
    """C3, C4, C5 within 2e-4 of their largest value (f32, summation
    order through 52 convolutions)."""
    want, got = pair[3], pair[5]
    assert [tuple(g.shape) for g in got] == \
        [(2, 8, 8, 256), (2, 4, 4, 512), (2, 2, 2, 1024)]
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_rel(g, w, 2e-4, f"C{i + 3}")


def test_head_outputs_match_jax(pair):
    """The three levels, deepest first, within 2e-4 of their largest
    value; the FPN's nearest upsample and concatenation included."""
    want, got = pair[4], pair[6]
    assert [tuple(g.shape) for g in got] == \
        [(2, 2, 2, 33), (2, 4, 4, 33), (2, 8, 8, 33)]
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_rel(g, w, 2e-4, f"level {i}")


def test_decode_matches_jax(pair):
    """Boxes and scores before NMS from the same head outputs: boxes
    within 1e-3 px, scores within 1e-6."""
    jm, tm, want_outs = pair[0], pair[1], pair[4]
    want = _jax_decode(jm, want_outs)
    got = tm.decode([torch.from_numpy(np.array(o)) for o in want_outs],
                    HW)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=1e-6)


def _assert_same_dets(got, want):
    """Counts and labels equal, scores within 1e-5, boxes within 1e-3 px."""
    (gd, gc), (wd, wc) = got, want
    wd = np.asarray(wd)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gd[..., 0].numpy(), wd[..., 0])
    np.testing.assert_allclose(gd[..., 1].numpy(), wd[..., 1], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(gd[..., 2:].numpy(), wd[..., 2:], rtol=0,
                               atol=1e-3)


@pytest.mark.parametrize("matrix", [True, False],
                         ids=["matrix_nms", "multiclass_nms"])
def test_post_process_matches_jax(pair, matrix):
    """Both NMS routes on the same head outputs give the same detections;
    ``use_matrix_nms=True`` is the bench's."""
    jm, tm, want_outs = pair[0], pair[1], pair[4]
    jm.use_matrix_nms = tm.use_matrix_nms = matrix
    try:
        want = jax.jit(lambda o: jm.post_process(o, HW))(want_outs)
        got = tm.post_process(
            [torch.from_numpy(np.array(o)) for o in want_outs], HW)
    finally:
        jm.use_matrix_nms = tm.use_matrix_nms = False
    assert got[0].shape == (2, 20, 6) and int(got[1].min()) > 0
    _assert_same_dets(got, want)


def test_predict_end_to_end_matches_jax(pair):
    """``ObjectDetection.predict`` against the JAX model's eval call on the
    same image: the same counts, and the JAX detections reproduced (label
    and every coordinate within 0.05 px) at a share of at least 0.9; the
    head outputs differ by f32 noise, which may swap near-equal scores."""
    jm, tm, x = pair[:3]
    want = _jax_run(jm, lambda m, v: m(v), x)
    with torch.no_grad():
        got = ObjectDetection(tm).predict(torch.from_numpy(x))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    wd, gd = np.asarray(want[0]), got[0].numpy()
    hits = total = 0
    for w, g in zip(wd, gd):
        w, g = w[w[:, 0] >= 0], g[g[:, 0] >= 0]
        close = (np.abs(w[:, None, 2:] - g[None, :, 2:]).max(-1) <= 0.05) \
            & (w[:, None, 0] == g[None, :, 0])
        hits += int(close.any(1).sum())
        total += len(w)
    assert total > 0 and hits / total >= 0.9


def test_iou_aware_branch_matches_jax(rng):
    """iou_aware=True (the reference's own case, 3 classes): na extra
    channels per level, the recombined objectness and both NMS routes."""
    jm, tm = _bridged(rng, num_classes=3, iou_aware=True)
    x = rng.normal(size=(1, *HW, 3)).astype(np.float32)
    want = _jax_run(jm, lambda m, v: m.head_outputs(v), x)
    with torch.no_grad():
        got = tm.head_outputs(torch.from_numpy(x))
    assert got[0].shape[-1] == 3 * (5 + 3) + 3
    for g, w in zip(got, want):
        _assert_rel(g, w, 2e-4)
    outs = [torch.from_numpy(np.array(o)) for o in want]
    for li, (o, w) in enumerate(zip(outs, want)):
        np.testing.assert_allclose(
            tm.yolo_head.recombine_iou_aware(o, li).numpy(),
            np.asarray(jm.yolo_head.recombine_iou_aware(w, li)), rtol=1e-5,
            atol=1e-5)
    for matrix in (True, False):
        jm.use_matrix_nms = tm.use_matrix_nms = matrix
        _assert_same_dets(tm.post_process(outs, HW),
                          jax.jit(lambda o: jm.post_process(o, HW))(want))


def test_create_model_yolov3():
    """The registry builds the bench's YOLOv3 (80 classes) with the JAX
    attribute paths; its training loss runs (its parity with the JAX
    package is in tests/test_torch_yolov3_train.py): with no ground truth
    only the objectness term is left, finite and positive."""
    m = create_model("yolov3", device="cpu", use_matrix_nms=True)
    assert isinstance(m, YOLOv3) and m.use_matrix_nms
    assert [c.weight.shape[0] for c in m.yolo_head.yolo_outputs] == \
        [255, 255, 255]
    assert sum(isinstance(mod, T.Conv2d) for mod in m.modules()) == 75
    assert "backbone.stages.4.blocks.3.conv2.bn.running_var" in \
        m.state_dict()
    outs = [torch.zeros(1, s, s, 255) for s in (2, 4, 8)]
    loss = m.loss_fn({"head_outs": outs, "input_hw": HW},
                     {"boxes": torch.zeros(1, 3, 4),
                      "class_labels": torch.zeros(1, 3, dtype=torch.int64)})
    assert loss.ndim == 0 and 0 < loss.item() < float("inf")


def test_training_only_options_are_refused():
    """``gt_iou_thresh`` (the name is kept from when the serving model
    refused it) steers the training loss's target assignment and is
    accepted with it; the model keeps it for ``loss_fn``."""
    m = create_model("yolov3", device="cpu", gt_iou_thresh=0.7)
    assert m.gt_iou_thresh == 0.7
    assert create_model("yolov3", device="cpu").gt_iou_thresh == 1.0


# ------------------------------------------------------------------ int8
def _rms(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float64)
                                  - np.asarray(b, np.float64)) ** 2)))


def test_jax_quantized_yolov3_carried_across(rng, monkeypatch):
    """int8 YOLOv3 as the bench builds it.  The port's own pipeline on the
    float copy agrees with the JAX one: the same layer count, int8 codes
    equal, w_scale within 1e-6 and a_scale within 1e-4 relative (the
    calibration's abs-max is read off an f32 forward 75 layers deep).

    The JAX-quantized model bridged to the port launches the int8 GEMM
    once per quantized layer.  Layer by layer it is exact: each layer's
    int32 sums equal the reference's int8 conv on the same codes, and each
    layer given the reference's own input returns the reference's output
    bitwise.  End to end the two chains drift apart: the float BatchNorm
    and leaky ReLU between the 75 unfolded int8 layers round in two
    libraries (at seed 0 one code of 262,144 differs at the second layer),
    and a flipped code moves the next layer's inputs across further
    rounding boundaries, up to 11 codes apart at the last layer: the drift
    is of the size of quantization noise itself.  So the head outputs are
    held to the reference's own int8 error, the rms difference between its
    int8 and f32 models at each level: the two int8 models differ by less
    than that (measured 0.72-0.77 of it), and the port's int8 model is as
    close to the f32 model, within a factor 1.25 (measured 0.95-1.02)."""
    jm, tm_float = _bridged(rng, **MICRO)
    calib = rng.normal(size=(2, *HW, 3)).astype(np.float32)
    x = rng.normal(size=(2, *HW, 3)).astype(np.float32)
    want_f32 = _jax_run(jm, lambda m, v: m.head_outputs(v), x)
    n_q = JQ.quantize_weights(jm)
    JQ.calibrate_activations(jm, [calib], forward=lambda v: jm.head_outputs(v))
    assert TQ.quantize_weights(tm_float) == n_q
    assert TQ.calibrate_activations(tm_float, [calib],
                                    forward=tm_float.head_outputs) == n_q
    tm = YOLOv3(**MICRO, device="cpu")
    load_jax_params(tm, _flat(jm))
    tm.eval()
    convs = [(p, m) for p, m in tm.named_modules()
             if isinstance(m, T.Conv2d)]
    for path, mod in convs:
        own = tm_float.get_submodule(path)
        assert torch.equal(own.weight, mod.weight), path
        np.testing.assert_allclose(own.w_scale.numpy(), mod.w_scale.numpy(),
                                   rtol=1e-6, err_msg=path)
        np.testing.assert_allclose(own.a_scale.numpy(), mod.a_scale.numpy(),
                                   rtol=1e-4, err_msg=path)

    # the reference's int8 forward, each conv's input and output recorded
    seen = []
    int8_call = jnn.Conv2d._int8_call

    def record_jax(self, x, w):
        y = int8_call(self, x, w)
        seen.append((self, np.asarray(x), np.asarray(y)))
        return y

    monkeypatch.setattr(jnn.Conv2d, "_int8_call", record_jax)
    want, _ = pure(jm, lambda m, v: m.head_outputs(v))(*split(jm),
                                                       jnp.asarray(x))
    monkeypatch.setattr(jnn.Conv2d, "_int8_call", int8_call)

    codes, sums = [], []

    def record(mod, args):
        codes.append((mod, T._quantize_input(args[0], mod.a_scale)))

    def counted(cols, w, *epilogue):
        sums.append(int8_matmul_plain(cols, w.t()))
        return requantize(sums[-1], *epilogue)

    handles = [mod.register_forward_pre_hook(record) for _, mod in convs]
    monkeypatch.setattr(T, "int8_matmul_requant", counted)
    try:
        with torch.no_grad():
            got = tm.head_outputs(torch.from_numpy(x))
    finally:
        for h in handles:
            h.remove()
    assert len(sums) == len(codes) == len(seen) == n_q == 75
    paths = {id(m): p for p, m in convs}
    for (mod, xq), acc, (jmod, jx, jy) in zip(codes, sums, seen):
        path = paths[id(mod)]
        ref = lax.conv_general_dilated(
            jnp.asarray(xq.numpy()), jmod.weight.value,
            window_strides=jmod.stride, padding=jmod.padding,
            rhs_dilation=jmod.dilation,
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32)
        np.testing.assert_array_equal(acc.reshape(ref.shape).numpy(),
                                      np.asarray(ref), err_msg=path)
        with torch.no_grad():
            np.testing.assert_array_equal(mod(torch.from_numpy(jx)).numpy(),
                                          jy, err_msg=path)

    for i, (g, w, f) in enumerate(zip(got, want, want_f32)):
        quant_err = _rms(w, f)
        assert _rms(g.numpy(), w) <= quant_err, f"level {i}"
        assert _rms(g.numpy(), f) <= 1.25 * quant_err, f"level {i}"
