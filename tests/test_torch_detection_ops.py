"""The port's detection ops against the JAX package on the CPU: box
geometry, NMS (greedy, class-aware, matrix), interpolate and upsample_add
(against the reference's default route and its Pallas kernel run
interpreted), the row gather (against both Pallas gathers, interpreted),
RoIAlign (both reference paths), paste, and ConvTranspose2d through the
bridge.  Inputs are made from seeds with numpy and handed to both."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlxcv_tpu import nn as jnn
from tlxcv_tpu.core import split
from tlxcv_tpu.ops.pallas.gather import gather_rows as j_gather_rows
from tlxcv_tpu.ops.pallas.gather import gather_rows_bs as j_gather_rows_bs
from tlxcv_tpu.ops.pallas.upsample import upsample_add_fused as j_up_add
from tlxcv_tpu_torch import nn as tnn
from tlxcv_tpu_torch.ops import boxes as TB
from tlxcv_tpu_torch.ops import image as TI
from tlxcv_tpu_torch.ops import nms as TN
from tlxcv_tpu_torch.ops import roi_align as TR
from tlxcv_tpu_torch.ops.cuda.gather import (gather_rows, gather_rows_bs,
                                             gather_rows_plain)
from tlxcv_tpu_torch.ops.cuda.upsample import (upsample_add_fused,
                                               upsample_add_plain)
from tlxcv_tpu_torch.utils import load_jax_params

# the JAX package's ops/__init__ re-exports functions under these names
JB, JI, JN, JR = (importlib.import_module(f"tlxcv_tpu.ops.{m}")
                  for m in ("boxes", "image", "nms", "roi_align"))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _boxes(rng, shape, lo=0.0, hi=100.0, size=(2.0, 40.0)):
    xy = rng.uniform(lo, hi, size=shape + (2,))
    wh = rng.uniform(*size, size=shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


# ------------------------------------------------------------------ boxes
# f32 elementwise ops in the reference's order: last-bit noise only
_BOX_CASES = {
    "xywh2xyxy": lambda m, a, b: m.xywh2xyxy(a),
    "xyxy2xywh": lambda m, a, b: m.xyxy2xywh(a),
    "box_area": lambda m, a, b: m.box_area(a),
    "pairwise_iou": lambda m, a, b: m.pairwise_iou(a, b),
    "aligned_iou": lambda m, a, b: m.aligned_iou(a, b),
    "giou": lambda m, a, b: m.aligned_iou(a, b, mode="giou"),
    "diou": lambda m, a, b: m.aligned_iou(a, b, mode="diou"),
    "ciou": lambda m, a, b: m.bbox_iou(a, b, mode="ciou"),
    "bbox2delta": lambda m, a, b: m.bbox2delta(a, b, (1.0, 1.0, 5.0, 5.0)),
    "delta2bbox": lambda m, a, b: m.delta2bbox((b - a) / 20.0, a),
    "distance2bbox": lambda m, a, b: m.distance2bbox(a[..., :2], b / 10),
    "distance2bbox_clipped": lambda m, a, b: m.distance2bbox(
        a[..., :2], b / 10, max_shape=(60, 80)),
    "bbox2distance": lambda m, a, b: m.bbox2distance(a[..., :2], b,
                                                     max_dis=50.0),
    "batch_distance2bbox": lambda m, a, b: m.batch_distance2bbox(
        a[..., :2], b / 10, max_shapes=a[:, 0, 2:] * 0 + 70.0),
    "clip_boxes": lambda m, a, b: m.clip_boxes(a, (64, 90)),
}


@pytest.mark.parametrize("name", sorted(_BOX_CASES))
def test_box_ops_match_jax(name):
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, (3, 7)), _boxes(rng, (3, 7))
    fn = _BOX_CASES[name]
    want = np.asarray(fn(JB, jnp.asarray(a), jnp.asarray(b)))
    got = fn(TB, torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# -------------------------------------------------------------------- nms
def _nms_pair(boxes, scores, **kw):
    want = [np.asarray(v) for v in JN.nms(jnp.asarray(boxes),
                                          jnp.asarray(scores), **kw)]
    got = [v.numpy() for v in TN.nms(torch.from_numpy(boxes),
                                     torch.from_numpy(scores), **kw)]
    return want, got


@pytest.mark.parametrize("case", ["ties", "score_threshold", "all_suppressed",
                                  "random"])
def test_nms_matches_jax_exactly(case):
    """Kept indices and masks equal, step by step: ties go to the lower
    index (argmax), a score threshold masks, and a pile of identical boxes
    keeps one."""
    rng = np.random.default_rng(1)
    boxes = _boxes(rng, (40,))
    scores = rng.uniform(size=40).astype(np.float32)
    kw = dict(iou_threshold=0.5, max_outputs=12)
    if case == "ties":
        scores = np.round(scores * 4) / 4          # many equal scores
    elif case == "score_threshold":
        kw["score_threshold"] = 0.6
    elif case == "all_suppressed":
        boxes = np.repeat(boxes[:1], 40, 0)
        scores[:] = 0.5
    want, got = _nms_pair(boxes, scores, **kw)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0][want[1]], want[0][want[1]])
    if case == "all_suppressed":
        assert got[1].sum() == 1 and got[0][0] == 0


def test_batched_nms_is_per_image():
    """A batch gives each image what it gets alone."""
    rng = np.random.default_rng(2)
    boxes = _boxes(rng, (3, 30))
    scores = rng.uniform(size=(3, 30)).astype(np.float32)
    idx, keep = TN.nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                       0.4, 10)
    for i in range(3):
        want, _ = _nms_pair(boxes[i], scores[i], iou_threshold=0.4,
                            max_outputs=10)
        np.testing.assert_array_equal(keep[i].numpy(), want[1])
        np.testing.assert_array_equal(idx[i].numpy()[want[1]],
                                      want[0][want[1]])


def _det_compare(want, got):
    (wd, wc), (gd, gc) = want, got
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gd.numpy()[..., 0], np.asarray(wd)[..., 0])
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("class_agnostic", [False, True])
def test_multiclass_nms_matches_jax(class_agnostic):
    """Images with different box maxima: the class offset is each image's
    own max + 1 (the reference's per-image vmap), not the batch's."""
    rng = np.random.default_rng(3)
    boxes = np.stack([_boxes(rng, (50,), hi=h) for h in (30, 300, 3000)])
    scores = rng.uniform(size=(3, 50, 5)).astype(np.float32)
    scores[1, :10] = scores[1, 10:20]               # duplicate score rows
    kw = dict(score_threshold=0.3, nms_threshold=0.45, nms_top_k=40,
              keep_top_k=12, class_agnostic=class_agnostic)
    want = JN.multiclass_nms(jnp.asarray(boxes), jnp.asarray(scores), **kw)
    got = TN.multiclass_nms(torch.from_numpy(boxes),
                            torch.from_numpy(scores), **kw)
    _det_compare(want, got)
    kw["nms_top_k"] = 50                            # the argsort branch
    _det_compare(JN.multiclass_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                   **kw),
                 TN.multiclass_nms(torch.from_numpy(boxes),
                                   torch.from_numpy(scores), **kw))


def test_per_image_class_offset_changes_the_result():
    """Overlapping boxes of two classes in a small image beside a far
    larger image: a batch-wide offset would still separate the classes,
    but the per-image one is what the reference computes; the dets must
    equal the reference's image by image."""
    rng = np.random.default_rng(4)
    small = _boxes(rng, (20,), hi=10, size=(5, 8))
    large = _boxes(rng, (20,), hi=5000, size=(5, 900))
    boxes = np.stack([small, large])
    scores = rng.uniform(size=(2, 20, 3)).astype(np.float32)
    kw = dict(score_threshold=0.2, nms_threshold=0.3, nms_top_k=20,
              keep_top_k=10)
    got = TN.multiclass_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                            **kw)
    for i in range(2):
        want = JN.multiclass_nms(jnp.asarray(boxes[i:i + 1]),
                                 jnp.asarray(scores[i:i + 1]), **kw)
        _det_compare(want, (got[0][i:i + 1], got[1][i:i + 1]))


def test_matrix_nms_with_duplicate_scores_matches_jax():
    rng = np.random.default_rng(5)
    boxes = _boxes(rng, (2, 40))
    boxes[:, 20:] = boxes[:, :20]                   # duplicate boxes ...
    scores = rng.uniform(size=(2, 40, 4)).astype(np.float32)
    scores[:, 20:] = scores[:, :20]                 # ... at equal scores
    kw = dict(score_threshold=0.1, keep_top_k=15, pre_top_k=30)
    for gaussian in (False, True):
        want = JN.matrix_nms(jnp.asarray(boxes), jnp.asarray(scores),
                             use_gaussian=gaussian, **kw)
        got = TN.matrix_nms(torch.from_numpy(boxes),
                            torch.from_numpy(scores), use_gaussian=gaussian,
                            **kw)
        _det_compare(want, got)


def test_top_k_breaks_ties_as_lax():
    x = np.asarray([[1, 3, 3, 2, 3, 1, 2, 0]], np.float32)
    want = jax.lax.top_k(jnp.asarray(x), 5)
    got = TN.top_k(torch.from_numpy(x), 5)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------ resize, upsample
# The reference's bf16 routes round up to ten times (weights, products,
# the pass between rows and columns, the add), each within 2^-9 of the
# largest magnitude M involved; the port's fused path rounds once.
def _bf16_bound(x, out):
    return 2.0 ** -5 * max(np.abs(x).max(), np.abs(out).max())


@pytest.mark.parametrize("mode,align", [("nearest", False),
                                        ("bilinear", False),
                                        ("bilinear", True)])
@pytest.mark.parametrize("size", [(16, 20), (24, 30), (15, 13), (3, 4)])
def test_interpolate_matches_jax(mode, align, size):
    """Integer upscales take the reference's static-matrix route, other
    sizes its gather route; f32 within the JAX test's 1e-5."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 8, 10, 6)).astype(np.float32)
    want = JI.interpolate(jnp.asarray(x), size=size, mode=mode,
                          align_corners=align)
    got = TI.interpolate(torch.from_numpy(x), size=size, mode=mode,
                         align_corners=align)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


_UP_SHAPES = [((2, 8, 8, 16), (16, 16)),      # 2x, the FPN step
              ((2, 5, 6, 16), (20, 24)),      # 4x
              ((1, 38, 38, 8), (75, 75)),     # non-integer
              ((2, 7, 9, 16), (7, 18))]       # one axis unchanged


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
@pytest.mark.parametrize("xshape,out_hw", _UP_SHAPES)
def test_upsample_add_matches_jax_default_route(mode, xshape, out_hw):
    """f32 within 1e-5; nearest bitwise in f32 and bf16; bilinear bf16
    within the bound above."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=xshape).astype(np.float32)
    skip = rng.normal(size=(xshape[0], *out_hw, xshape[3])).astype(np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(JI.upsample_add(jnp.asarray(x, jdt),
                                          jnp.asarray(skip, jdt), mode=mode),
                          np.float32)
        got = TI.upsample_add(torch.from_numpy(x).to(tdt),
                              torch.from_numpy(skip).to(tdt), mode=mode)
        assert got.dtype == tdt and got.shape == skip.shape
        if mode == "nearest":
            np.testing.assert_array_equal(_np(got), want)
        elif tdt == torch.float32:
            np.testing.assert_allclose(_np(got), want, atol=1e-5)
        else:
            np.testing.assert_allclose(_np(got), want, rtol=0,
                                       atol=_bf16_bound(x, want))


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
@pytest.mark.parametrize("xshape,out_hw", _UP_SHAPES[:3])
def test_upsample_add_plain_matches_the_pallas_kernel(mode, xshape, out_hw):
    """The kernel's plain version against the TPU kernel interpreted."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=xshape).astype(np.float32)
    skip = rng.normal(size=(xshape[0], *out_hw, xshape[3])).astype(np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(j_up_add(jnp.asarray(x, jdt),
                                   jnp.asarray(skip, jdt), mode=mode,
                                   interpret=True), np.float32)
        got = _np(upsample_add_plain(torch.from_numpy(x).to(tdt),
                                     torch.from_numpy(skip).to(tdt), mode))
        if tdt == torch.float32 or mode == "nearest":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        else:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=_bf16_bound(x, want))


def test_upsample_add_routes_within_the_contract_only(monkeypatch):
    """Calls within the kernel's contract go to upsample_add_fused (here
    its plain version); align_corners, a downsample or mixed dtypes take
    the composition."""
    calls = []
    real = TI.upsample_add_fused
    monkeypatch.setattr(TI, "upsample_add_fused",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x = torch.randn(1, 4, 4, 8)
    TI.upsample_add(x, torch.randn(1, 8, 8, 8), mode="nearest")
    TI.upsample_add(x.bfloat16(), torch.randn(1, 8, 8, 8).bfloat16())
    assert len(calls) == 2
    TI.upsample_add(x, torch.randn(1, 8, 8, 8), align_corners=True)
    TI.upsample_add(x, torch.randn(1, 2, 2, 8))
    TI.upsample_add(x, torch.randn(1, 8, 8, 8).bfloat16())
    assert len(calls) == 2


def test_upsample_add_fused_rejects_what_it_does_not_take():
    x = torch.randn(1, 4, 4, 8)
    with pytest.raises(ValueError):
        upsample_add_fused(x, torch.randn(1, 8, 8, 4))          # C differs
    with pytest.raises(ValueError):
        upsample_add_fused(x, torch.randn(1, 2, 2, 8))          # downsample
    with pytest.raises(ValueError):
        upsample_add_fused(x.half(), torch.randn(1, 8, 8, 8).half())
    with pytest.raises(ValueError):
        upsample_add_fused(x, torch.randn(1, 8, 8, 8), mode="bicubic")


# ----------------------------------------------------------------- gather
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("r", [64, 777])
def test_gather_rows_matches_the_pallas_kernels(dtype, r):
    """The cases of tests/test_pallas_gather.py, bitwise, against both
    Pallas gathers interpreted."""
    rng = np.random.default_rng(0)
    table = rng.normal(size=(500, 256)).astype(np.float32)
    idx = rng.integers(0, 500, size=r).astype(np.int32)
    jt = jnp.asarray(table, jnp.bfloat16 if dtype == "bfloat16" else dtype)
    tt = torch.from_numpy(table)
    if dtype == "bfloat16":
        tt = tt.bfloat16()
    want = j_gather_rows(jt, jnp.asarray(idx), g=64, wave=8, interpret=True)
    got = gather_rows_plain(tt, torch.from_numpy(idx))
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))
    want_bs = j_gather_rows_bs(jt, jnp.asarray(idx), g=8, interpret=True)
    np.testing.assert_array_equal(_np(gather_rows(tt, torch.from_numpy(idx))),
                                  np.asarray(want_bs, np.float32))


def test_gather_rows_repeated_and_boundary_indices():
    table = np.arange(100 * 128, dtype=np.float32).reshape(100, 128)
    idx = np.asarray([0, 99, 0, 99, 50, 50, 1, 98], np.int32)
    want = j_gather_rows(jnp.asarray(table), jnp.asarray(idx), g=8, wave=2,
                         interpret=True)
    got = gather_rows_bs(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("r,g", [(64, 8), (77, 8), (48, 16)])
def test_gather_rows_bs_cases(r, g):
    rng = np.random.default_rng(1)
    table = rng.normal(size=(300, 256)).astype(np.float32)
    idx = rng.integers(0, 300, size=r).astype(np.int32)
    want = j_gather_rows_bs(jnp.asarray(table, jnp.bfloat16),
                            jnp.asarray(idx), g=g, interpret=True)
    got = gather_rows_bs(torch.from_numpy(table).bfloat16(),
                         torch.from_numpy(idx))
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


def test_gather_rows_checks_its_contract():
    table = torch.zeros(10, 4)
    with pytest.raises(ValueError):
        gather_rows(table, torch.zeros(3, dtype=torch.int64))   # not int32
    with pytest.raises(ValueError):
        gather_rows(table[None], torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        gather_rows(table, torch.zeros(3, 1, dtype=torch.int32))


# -------------------------------------------------------------- RoIAlign
def _pyramid(rng, n=2, c=8, hws=(32, 16, 8, 4)):
    feats = [rng.normal(size=(n, hw, hw, c)).astype(np.float32)
             for hw in hws]
    lo = rng.uniform(-8, 100, size=(n, 9, 2))
    wh = rng.uniform(1, 120, size=(n, 9, 2))
    return feats, np.concatenate([lo, lo + wh], -1).astype(np.float32)


@pytest.mark.parametrize("impl,sr", [("xla", 1), ("xla", 2), ("pallas", 1),
                                     ("pallas_bs", 1), ("pallas_bs", 2)])
def test_multilevel_roi_align_matches_jax(sr, impl):
    """Both reference paths (the per-image XLA gather and the whole-batch
    Pallas gathers, interpreted; the async-DMA one costs about 12 s to
    interpret, so it runs once); boxes cross the image edge and span every
    level.  f32 within 2e-5, the reference's own bound between them."""
    rng = np.random.default_rng(9)
    feats, boxes = _pyramid(rng)
    want = JR.multilevel_roi_align(
        [jnp.asarray(f) for f in feats], jnp.asarray(boxes), output_size=7,
        sampling_ratio=sr, gather_impl=impl, _interpret=impl != "xla")
    got = TR.multilevel_roi_align([torch.from_numpy(f) for f in feats],
                                  torch.from_numpy(boxes), 7, sr)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_multilevel_roi_align_bf16_table_gives_f32():
    """A bf16 pyramid with f32 boxes: f32 out, as the reference."""
    rng = np.random.default_rng(10)
    feats, boxes = _pyramid(rng)
    want = JR.multilevel_roi_align([jnp.asarray(f, jnp.bfloat16)
                                    for f in feats], jnp.asarray(boxes),
                                   output_size=7, sampling_ratio=1)
    got = TR.multilevel_roi_align([torch.from_numpy(f).bfloat16()
                                   for f in feats],
                                  torch.from_numpy(boxes), 7, 1)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_roi_align_and_paste_match_jax():
    rng = np.random.default_rng(11)
    feat = rng.normal(size=(2, 12, 16, 3)).astype(np.float32)
    boxes = np.asarray([[[2.0, 3.0, 10.0, 9.0], [0.0, 0.0, 16.0, 12.0],
                         [5.5, 2.5, 7.5, 6.0]]] * 2, np.float32)
    boxes[1] += 1.5
    for s, sr, scale in ((4, 2, 1.0), (7, 1, 0.5)):
        want = JR.roi_align(jnp.asarray(feat), jnp.asarray(boxes), s, scale,
                            sr)
        got = TR.roi_align(torch.from_numpy(feat), torch.from_numpy(boxes), s,
                           scale, sr)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    masks = rng.uniform(size=(3, 14, 14)).astype(np.float32)
    pboxes = np.asarray([[4.0, 4.0, 12.0, 12.0], [-3.0, 2.0, 9.0, 30.0],
                         [10.0, 1.0, 10.5, 3.0]], np.float32)
    want = JR.paste_masks(jnp.asarray(masks), jnp.asarray(pboxes), (20, 24))
    got = TR.paste_masks(torch.from_numpy(masks), torch.from_numpy(pboxes),
                         (20, 24))
    assert got.shape == (3, 20, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# -------------------------------------------------------- ConvTranspose2d
@pytest.mark.parametrize("cin,cout,k,s,p,op,g", [
    (8, 6, 2, 2, 0, 0, 1),      # the mask head's deconv
    (6, 4, 3, 2, 1, 1, 1),      # padded, output padding
    (8, 6, 3, 2, 1, 1, 2),      # grouped
])
def test_conv_transpose_matches_jax_through_the_bridge(cin, cout, k, s, p,
                                                       op, g):
    rng = np.random.default_rng(12)
    jl = jnn.ConvTranspose2d(cin, cout, k, stride=s, padding=p,
                             output_padding=op, groups=g)
    params, _ = split(jl)
    flat = {name: rng.normal(size=np.shape(v)).astype(np.float32)
            for name, v in params.items()}
    jl.weight.value = jnp.asarray(flat["weight"])
    jl.bias.value = jnp.asarray(flat["bias"])
    tl = tnn.ConvTranspose2d(cin, cout, k, stride=s, padding=p,
                             output_padding=op, groups=g, device="cpu")
    load_jax_params(tl, flat)
    x = rng.normal(size=(2, 5, 7, cin)).astype(np.float32)
    want = np.asarray(jl(jnp.asarray(x)))
    got = tl(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (2, (5 - 1) * s - 2 * p + k + op,
                                       (7 - 1) * s - 2 * p + k + op, cout)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
