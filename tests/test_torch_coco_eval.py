"""The port's COCO evaluator against the JAX package's on the CPU.

Both are numpy on the host, the same arithmetic: every stat is held equal,
float for float (no tolerance), on seeded random images for bbox, segm and
keypoints, and on the analytic cases of ``tests/test_coco_eval_golden.py``
(each also against its hand-derived value).  The port's inputs are torch
tensors where the reference's are numpy arrays, as a detector hands them
over.
"""
import numpy as np
import pytest
import torch

from tlxcv_tpu.utils import coco_eval as JC
from tlxcv_tpu_torch.utils import coco_eval as TC


def _tensors(images):
    """The same per-image dicts with every array as a torch tensor."""
    return [{k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
            for d in images]


def _same(got, want):
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["stats"], want["stats"])
    for k in ("map", "map50", "map75", "ar", "iou_type"):
        assert got[k] == want[k], k
    assert got["per_class"] == want["per_class"]


def _random_images(rng, n, kind):
    preds, gts = [], []
    for _ in range(n):
        ng, nd = int(rng.integers(1, 6)), int(rng.integers(0, 9))
        xy = rng.uniform(0, 48, (ng, 2))
        g = np.concatenate([xy, xy + rng.uniform(4, 40, (ng, 2))], 1)
        j = rng.integers(0, ng, nd)
        p = g[j] + rng.normal(0, 3, (nd, 4))
        gt = {"boxes": g.astype(np.float32),
              "labels": rng.integers(0, 3, ng),
              "iscrowd": (rng.random(ng) < 0.15).astype(np.int64)}
        pred = {"boxes": p.astype(np.float32),
                "scores": rng.random(nd).astype(np.float32),
                "labels": np.where(rng.random(nd) < 0.7,
                                   gt["labels"][j], rng.integers(0, 3, nd))}
        if kind == "segm":
            yy, xx = np.mgrid[0:96, 0:96]

            def masks(b):
                return np.stack([(xx >= x0) & (xx < x1) & (yy >= y0)
                                 & (yy < y1) & (rng.random((96, 96)) < 0.9)
                                 for x0, y0, x1, y1 in b]) if len(b) else \
                    np.zeros((0, 96, 96), bool)

            gt["masks"], pred["masks"] = masks(g), masks(p)
        if kind == "keypoints":
            kg = np.concatenate([rng.uniform(0, 90, (ng, 17, 2)),
                                 rng.integers(0, 3, (ng, 17, 1))], -1)
            kp = kg[j].copy()
            kp[..., :2] += rng.normal(0, 2, (nd, 17, 2))
            gt["keypoints"] = kg.astype(np.float32)
            pred["keypoints"] = kp.astype(np.float32)
        preds.append(pred)
        gts.append(gt)
    return preds, gts


@pytest.mark.parametrize("kind", ["bbox", "segm", "keypoints"])
def test_compute_coco_stats_equals_jax_float_for_float(kind):
    rng = np.random.default_rng({"bbox": 0, "segm": 1, "keypoints": 2}[kind])
    preds, gts = _random_images(rng, 12, kind)
    want = JC.compute_coco_stats(preds, gts, iou_type=kind)
    got = TC.compute_coco_stats(_tensors(preds), _tensors(gts),
                                iou_type=kind)
    _same(got, want)
    assert want["stats"][0] > 0  # matches happen: the cases are not empty
    ev = TC.CocoEvaluator(iou_types=(kind,))
    ev.update(_tensors(preds[:5]), _tensors(gts[:5]))
    ev.update(_tensors(preds[5:]), _tensors(gts[5:]))
    _same(ev.accumulate(), want)
    np.testing.assert_array_equal(TC.COCO_KPT_SIGMAS, JC.COCO_KPT_SIGMAS)


def test_compute_map_and_summaries_equal_jax(capsys):
    rng = np.random.default_rng(3)
    preds, gts = _random_images(rng, 8, "bbox")
    want = JC.compute_map(preds, gts)
    got = TC.compute_map(_tensors(preds), gts)
    assert got == want
    stats = JC.compute_coco_stats(preds, gts)["stats"]
    for kind in ("bbox", "keypoints"):
        assert TC.summarize_stats(stats, kind) == JC.summarize_stats(stats,
                                                                     kind)
    light = TC.CocoEvaluator(full_protocol=False)
    light.update(preds, gts)
    assert light.summarize() == want
    jl = JC.CocoEvaluator(full_protocol=False)
    jl.update(preds, gts)
    jl.summarize()
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1]


def _img(boxes, labels, scores=None, **extra):
    d = {"boxes": np.asarray(boxes, np.float32),
         "labels": np.asarray(labels, np.int64)}
    if scores is not None:
        d["scores"] = np.asarray(scores, np.float32)
    d.update({k: np.asarray(v) for k, v in extra.items()})
    return d


def _square(h, w, rows, cols):
    m = np.zeros((h, w), bool)
    m[rows, cols] = True
    return m[None]


def _kp(points, vis):
    kp = np.zeros((len(points), 17, 3), np.float32)
    for i, (p, v) in enumerate(zip(points, vis)):
        kp[i, :, :2] = p
        kp[i, :, 2] = v
    return kp


def _oks_offset_case():
    area, var = 64.0 * 64.0, (2 * float(JC.COCO_KPT_SIGMAS[0])) ** 2
    d = float(np.sqrt(-np.log(0.52) * 2 * area * var))
    gk = np.zeros((1, 17, 3), np.float32)
    gk[0, 0] = [32, 32, 2]
    pk = np.zeros((1, 17, 3), np.float32)
    pk[0, 0] = [32 + d, 32, 1]
    box = [[0, 0, 64, 64]]
    return ([_img(box, [1], [0.9], keypoints=pk)],
            [_img(box, [1], keypoints=gk, area=[area])],
            {"iou_type": "keypoints"}, {"map50": 1.0, "map": 0.1})


def _golden_cases():
    """(predictions, ground truths, kwargs, expected) of the reference's
    analytic cases; kwargs with ``max_dets`` go through ``compute_map``."""
    b10 = [[0, 0, 10, 10]]
    fps = [[i * 20 + 1000, 0, i * 20 + 1010, 10] for i in range(149)]
    cap_pred = [_img(fps + b10, [1] * 150,
                     list(np.linspace(0.9, 0.5, 149)) + [0.1])]
    m32 = _square(64, 64, slice(0, 32), slice(0, 32))
    m16 = _square(64, 64, slice(0, 16), slice(0, 32))
    strip = _square(128, 128, slice(10, 30), slice(10, 14))
    m10 = _square(64, 64, slice(0, 10), slice(0, 10))
    lin = np.linspace(10, 50, 17)
    kp_perfect = np.stack([lin, lin, np.full(17, 2.0)], -1)[None].astype(
        np.float32)
    box64 = [[0, 0, 64, 64]]
    return {
        "perfect_single_detection": (
            [_img(b10, [1], [0.9])], [_img(b10, [1])], {"max_dets": 100},
            {"map": 1.0, "map50": 1.0, "map75": 1.0}),
        "high_scored_false_positive_halves_precision": (
            [_img([[50, 50, 60, 60]] + b10, [1, 1], [0.9, 0.8])],
            [_img(b10, [1])], {"max_dets": 100}, {"map": 0.5, "map50": 0.5}),
        "iou_threshold_cutoff": (
            [_img([[0, 0, 10, 6]], [1], [0.9])], [_img(b10, [1])],
            {"max_dets": 100}, {"map50": 1.0, "map75": 0.0, "map": 0.3}),
        "per_class_mean": (
            [_img(b10, [1], [0.9])], [_img(b10 + [[20, 20, 30, 30]], [1, 2])],
            {"max_dets": 100}, {"map": 0.5, ("per_class", 1): 1.0,
                                ("per_class", 2): 0.0}),
        "partial_recall_interpolation_grid": (
            [_img(b10, [1], [0.9])], [_img(b10 + [[40, 40, 50, 50]], [1, 1])],
            {"max_dets": 100}, {"map": 51 / 101, "map50": 51 / 101}),
        "greedy_matching_takes_best_iou_first": (
            [_img([[0, 0, 10, 6]] + b10, [1, 1], [0.9, 0.8])],
            [_img(b10, [1])], {"max_dets": 100},
            {"map50": 1.0, "map75": 0.5}),
        "max_dets_cap_100": (cap_pred, [_img(b10, [1])], {"max_dets": 100},
                             {"map": 0.0}),
        "max_dets_cap_200": (cap_pred, [_img(b10, [1])], {"max_dets": 200},
                             {}),
        "iscrowd_gt_is_ignored_not_counted": (
            [_img(b10 + [[50, 50, 60, 60]], [1, 1], [0.9, 0.8])],
            [_img(b10 + [[50, 50, 60, 60]], [1, 1], iscrowd=[1, 0])], {},
            {"map": 1.0}),
        "iscrowd_iou_uses_det_area": (
            [_img(b10 + [[200, 0, 220, 20]], [1, 1], [0.95, 0.9])],
            [_img([[0, 0, 100, 100], [200, 0, 220, 20]], [1, 1],
                  iscrowd=[1, 0])], {}, {"map": 1.0}),
        "area_range_stats": (
            [_img(b10 + [[300, 300, 500, 500]], [1, 1], [0.9, 0.8])],
            [_img(b10 + [[300, 300, 500, 500]], [1, 1])], {},
            {("stats", 0): 1.0, ("stats", 3): 1.0, ("stats", 4): -1.0,
             ("stats", 5): 1.0, ("stats", 9): 1.0, ("stats", 11): 1.0}),
        "out_of_range_unmatched_det_is_ignored": (
            [_img([[300, 300, 500, 500]] + b10, [1, 1], [0.9, 0.8])],
            [_img(b10, [1])], {}, {("stats", 3): 1.0, ("stats", 0): 0.5}),
        "ar_maxdet_tiers": (
            [_img(b10 + [[200, 0, 210, 10], [0, 200, 10, 210],
                         [50, 50, 60, 60]], [1] * 4, [0.9, 0.8, 0.7, 0.6])],
            [_img(b10 + [[50, 50, 60, 60], [100, 100, 110, 110]], [1] * 3)],
            {}, {("stats", 6): 1 / 3, ("stats", 7): 2 / 3,
                 ("stats", 8): 2 / 3}),
        "segm_mask_iou_perfect_and_half": (
            [_img([[0, 0, 32, 32]], [1], [0.9], masks=m32),
             _img([[0, 0, 32, 32]], [2], [0.9], masks=m16)],
            [_img([[0, 0, 32, 32]], [1], masks=m32),
             _img([[0, 0, 32, 32]], [2], masks=m32)], {"iou_type": "segm"},
            {("per_class", 1): 1.0, ("per_class", 2): 0.1}),
        "segm_area_from_mask_not_box": (
            [_img([[0, 0, 100, 100]], [1], [0.9], masks=strip)],
            [_img([[0, 0, 100, 100]], [1], masks=strip)],
            {"iou_type": "segm"}, {("stats", 3): 1.0, ("stats", 5): -1.0}),
        "oks_perfect_keypoints": (
            [_img(box64, [1], [0.9], keypoints=kp_perfect)],
            [_img(box64, [1], keypoints=kp_perfect, area=[64.0 * 64.0])],
            {"iou_type": "keypoints"}, {"map": 1.0}),
        "oks_known_offset_value": _oks_offset_case(),
        "keypoints_zero_visible_gt_ignored": (
            [_img([[0, 0, 40, 40], [180, 180, 220, 220]], [1, 1], [0.9, 0.8],
                  keypoints=_kp([20, 200], [1, 1]))],
            [_img([[0, 0, 40, 40], [180, 180, 220, 220]], [1, 1],
                  keypoints=_kp([20, 0], [2, 0]), area=[1600.0, 1600.0])],
            {"iou_type": "keypoints"}, {"map": 1.0}),
        "segm_zero_detection_image": (
            [_img(np.zeros((0, 4)), np.zeros(0), np.zeros(0),
                  masks=np.zeros((0, 64, 64), bool)),
             _img(b10, [1], [0.9], masks=m10)],
            [_img(b10, [1], masks=m10), _img(b10, [1], masks=m10)],
            {"iou_type": "segm"}, {"map": 51 / 101}),
    }


GOLDEN = _golden_cases()


@pytest.mark.parametrize("case", sorted(GOLDEN))
def test_golden_case_equals_jax_and_its_analytic_value(case):
    preds, gts, kw, expected = GOLDEN[case]
    if "max_dets" in kw:
        want = JC.compute_map(preds, gts, **kw)
        got = TC.compute_map(_tensors(preds), _tensors(gts), **kw)
        assert got == want
    else:
        want = JC.compute_coco_stats(preds, gts, **kw)
        got = TC.compute_coco_stats(_tensors(preds), _tensors(gts), **kw)
        _same(got, want)
    if case == "max_dets_cap_200":
        assert got["map"] > 0.0
    for key, value in expected.items():
        v = got[key[0]][key[1]] if isinstance(key, tuple) else got[key]
        assert v == pytest.approx(value), key


def test_multi_type_evaluator_equals_jax():
    m = _square(64, 64, slice(0, 10), slice(0, 10))
    gt = [_img([[0, 0, 10, 10]], [1], masks=m)]
    pred = [_img([[0, 0, 10, 10]], [1], [0.9], masks=m)]
    ev = TC.CocoEvaluator(iou_types=("bbox", "segm"))
    ev.update(_tensors(pred), _tensors(gt))
    got = ev.summarize()
    jev = JC.CocoEvaluator(iou_types=("bbox", "segm"))
    jev.update(pred, gt)
    want = jev.summarize()
    for kind in ("bbox", "segm"):
        _same(got[kind], want[kind])
        assert got[kind]["map"] == pytest.approx(1.0)
