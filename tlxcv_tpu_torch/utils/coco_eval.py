"""COCO-protocol evaluation (bbox / segm / keypoints) in numpy on the host
(counterpart of ``tlxcv_tpu/utils/coco_eval.py``, the same arithmetic:
results equal the reference's float for float on the same inputs).

The protocol is pycocotools': greedy best-IoU matching per threshold with
``iscrowd`` semantics (a crowd GT takes IoU = inter/det_area, may absorb
many detections, and a detection matched to it is ignored, not a TP);
area ranges (all / small / medium / large); maxDets tiers ([1, 10, 100]
boxes, [20] keypoints); 101-point interpolated AP over IoU .50:.05:.95 and
AR, as the 12-number (bbox/segm) or 10-number (keypoints) stat vector;
mask IoU on binary masks; OKS with the 17 COCO keypoint sigmas.

Every per-image field may be a tensor on any device: it reaches numpy
through ``utils.metrics.as_numpy`` (floating tensors in f32).
``compute_map`` is the bbox facade of the detection accuracy loops;
``compute_coco_stats`` the full protocol.
"""
from __future__ import annotations

import typing as tp

import numpy as np

from .metrics import as_numpy

__all__ = ["compute_map", "compute_coco_stats", "CocoEvaluator",
           "COCO_KPT_SIGMAS", "summarize_stats"]

IOU_THRS = np.round(np.arange(0.5, 1.0, 0.05), 2)
RECALL_THRS = np.linspace(0.0, 1.0, 101)

# pycocotools Params.kpt_oks_sigmas (COCO 17-keypoint convention).
COCO_KPT_SIGMAS = np.array(
    [.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62,
     1.07, 1.07, .87, .87, .89, .89], np.float32) / 10.0

AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def _get(d, key, default=None):
    v = d.get(key, default) if isinstance(d, dict) else default
    return None if v is None else as_numpy(v)


def _box_area(boxes):
    if len(boxes) == 0:
        return np.zeros((0,), np.float64)
    wh = np.clip(boxes[:, 2:4] - boxes[:, 0:2], 0, None)
    return (wh[:, 0] * wh[:, 1]).astype(np.float64)


def _bbox_iou(det, gt, iscrowd):
    """IoU [Nd, Ng]; crowd GTs use inter/det_area (pycocotools maskUtils.iou)."""
    lt = np.maximum(det[:, None, :2], gt[None, :, :2])
    rb = np.minimum(det[:, None, 2:4], gt[None, :, 2:4])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    da = _box_area(det)[:, None]
    ga = _box_area(gt)[None, :]
    union = np.where(iscrowd[None, :], da, da + ga - inter)
    return inter / np.maximum(union, 1e-9)


def _flat_masks(m):
    """[N, H, W] -> [N, H*W] bool; safe for N == 0 (reshape(0, -1) is a
    numpy error)."""
    m = np.asarray(m)
    n = len(m)
    return m.reshape(n, int(np.prod(m.shape[1:], dtype=np.int64))
                     if m.ndim > 1 else 0).astype(bool)


def _mask_iou(det_m, gt_m, iscrowd):
    """Mask IoU on binary [N, H, W] arrays; crowd uses inter/det_area.

    Intersections via matmul — the broadcast formulation materializes a
    [Nd, Ng, H*W] bool (≈4 GB at 100x100 dets/GTs on 640² masks); the
    f32 product keeps it O(Nd*Ng)."""
    d = _flat_masks(det_m).astype(np.float32)
    g = _flat_masks(gt_m).astype(np.float32)
    inter = (d @ g.T).astype(np.float64)
    da = d.sum(-1).astype(np.float64)[:, None]
    ga = g.sum(-1).astype(np.float64)[None, :]
    union = np.where(iscrowd[None, :], da, da + ga - inter)
    return inter / np.maximum(union, 1e-9)


def _oks(det_k, gt_k, gt_areas, gt_boxes, sigmas):
    """OKS matrix [Nd, Ng] — pycocotools COCOeval.computeOks.

    det_k [Nd, K, 3] (x, y, score), gt_k [Ng, K, 3] (x, y, visibility).
    For GTs with zero visible keypoints, distances are measured against
    the 2x-expanded GT box (clipped outside it), as pycocotools does.
    """
    nd, ng = len(det_k), len(gt_k)
    out = np.zeros((nd, ng), np.float64)
    variances = (2.0 * np.asarray(sigmas, np.float64)) ** 2
    for j in range(ng):
        g = np.asarray(gt_k[j], np.float64)
        xg, yg, vg = g[:, 0], g[:, 1], g[:, 2]
        k1 = int((vg > 0).sum())
        x1, y1, x2, y2 = np.asarray(gt_boxes[j], np.float64)
        w, h = x2 - x1, y2 - y1
        z0x, z0y = x1 - w, y1 - h
        z1x, z1y = x2 + w, y2 + h
        for i in range(nd):
            d = np.asarray(det_k[i], np.float64)
            xd, yd = d[:, 0], d[:, 1]
            if k1 > 0:
                dx, dy = xd - xg, yd - yg
            else:
                dx = np.maximum(z0x - xd, 0) + np.maximum(xd - z1x, 0)
                dy = np.maximum(z0y - yd, 0) + np.maximum(yd - z1y, 0)
            e = ((dx ** 2 + dy ** 2) / variances
                 / (gt_areas[j] + np.spacing(1)) / 2.0)
            if k1 > 0:
                e = e[vg > 0]
            out[i, j] = np.exp(-e).sum() / max(len(e), 1)
    return out


def _prepare_image(pred, gt, iou_type, kpt_sigmas):
    """Normalize one image's pred/gt dicts -> ious, scores, flags."""
    p_boxes = _get(pred, "boxes")
    p_boxes = (np.zeros((0, 4), np.float32) if p_boxes is None or p_boxes.size == 0
               else p_boxes.reshape(-1, 4).astype(np.float32))
    p_scores = _get(pred, "scores")
    p_scores = (np.ones(len(p_boxes), np.float32) if p_scores is None
                else p_scores.astype(np.float32).reshape(-1))
    p_labels = _get(pred, "labels")
    p_labels = (np.zeros(len(p_boxes), np.int64) if p_labels is None
                else p_labels.astype(np.int64).reshape(-1))

    g_boxes = _get(gt, "boxes")
    g_boxes = (np.zeros((0, 4), np.float32) if g_boxes is None or g_boxes.size == 0
               else g_boxes.reshape(-1, 4).astype(np.float32))
    g_labels = _get(gt, "labels")
    g_labels = (np.zeros(len(g_boxes), np.int64) if g_labels is None
                else g_labels.astype(np.int64).reshape(-1))
    crowd = _get(gt, "iscrowd")
    crowd = (np.zeros(len(g_boxes), bool) if crowd is None
             else crowd.astype(bool).reshape(-1))
    ignore = _get(gt, "ignore")
    ignore = (np.zeros(len(g_boxes), bool) if ignore is None
              else ignore.astype(bool).reshape(-1))
    # pycocotools _prepare: crowd GTs never count as npig and matched
    # detections against them are ignored, for every iou type.
    ignore = ignore | crowd

    g_area = _get(gt, "area")
    if iou_type == "segm":
        gm = _get(gt, "masks")
        pm = _get(pred, "masks")
        gm = (np.zeros((len(g_boxes), 1, 1), bool) if gm is None
              else (gm > 0.5))
        pm = (np.zeros((len(p_boxes), 1, 1), bool) if pm is None
              else (pm > 0.5))
        if g_area is None:
            g_area = _flat_masks(gm).sum(-1).astype(np.float64)
        p_area = _flat_masks(pm).sum(-1).astype(np.float64)
        ious = _mask_iou(pm, gm, crowd) if len(pm) and len(gm) else \
            np.zeros((len(p_boxes), len(g_boxes)))
    elif iou_type == "keypoints":
        gk = _get(gt, "keypoints")
        pk = _get(pred, "keypoints")
        if g_area is None:
            g_area = _box_area(g_boxes)
        p_area = _box_area(p_boxes)
        if gk is not None and len(gk):
            # pycocotools: GTs with zero labelled keypoints are ignored
            k1 = (np.asarray(gk)[..., 2] > 0).sum(-1)
            ignore = ignore | (k1 == 0)
        ious = (_oks(pk, gk, np.asarray(g_area, np.float64), g_boxes,
                     kpt_sigmas)
                if pk is not None and gk is not None and len(pk) and len(gk)
                else np.zeros((len(p_boxes), len(g_boxes))))
    else:
        if g_area is None:
            g_area = _box_area(g_boxes)
        p_area = _box_area(p_boxes)
        ious = (_bbox_iou(p_boxes, g_boxes, crowd)
                if len(p_boxes) and len(g_boxes)
                else np.zeros((len(p_boxes), len(g_boxes))))
    return {
        "ious": ious, "p_scores": p_scores, "p_labels": p_labels,
        "p_area": np.asarray(p_area, np.float64),
        "g_labels": g_labels, "g_area": np.asarray(g_area, np.float64),
        "g_crowd": crowd, "g_ignore": ignore,
    }


def _evaluate_img(prep, cls, area_rng, max_det, iou_thrs):
    """pycocotools COCOeval.evaluateImg for one (image, class, area, maxDet)."""
    gsel = np.where(prep["g_labels"] == cls)[0]
    psel = np.where(prep["p_labels"] == cls)[0]
    if len(gsel) == 0 and len(psel) == 0:
        return None
    g_area = prep["g_area"][gsel]
    g_ig = (prep["g_ignore"][gsel]
            | (g_area < area_rng[0]) | (g_area > area_rng[1]))
    # non-ignored GTs first (stable), as pycocotools sorts by _ignore
    gorder = np.argsort(g_ig, kind="stable")
    gsel = gsel[gorder]
    g_ig = g_ig[gorder]
    g_crowd = prep["g_crowd"][gsel]

    scores = prep["p_scores"][psel]
    porder = np.argsort(-scores, kind="stable")[:max_det]
    psel = psel[porder]
    scores = scores[porder]
    p_area = prep["p_area"][psel]

    ious = prep["ious"][np.ix_(psel, gsel)] if len(psel) and len(gsel) else \
        np.zeros((len(psel), len(gsel)))

    T, D, G = len(iou_thrs), len(psel), len(gsel)
    dtm = -np.ones((T, D), np.int64)
    gtm = -np.ones((T, G), np.int64)
    dt_ig = np.zeros((T, D), bool)
    for ti, thr in enumerate(iou_thrs):
        for di in range(D):
            best_iou = min(thr, 1 - 1e-10)
            m = -1
            for gi in range(G):
                if gtm[ti, gi] >= 0 and not g_crowd[gi]:
                    continue
                if m > -1 and not g_ig[m] and g_ig[gi]:
                    break  # past all non-ignored GTs with a real match in hand
                if ious[di, gi] < best_iou:
                    continue
                best_iou = ious[di, gi]
                m = gi
            if m == -1:
                continue
            dtm[ti, di] = m
            gtm[ti, m] = di
            dt_ig[ti, di] = g_ig[m]
    out_of_rng = (p_area < area_rng[0]) | (p_area > area_rng[1])
    dt_ig |= (dtm < 0) & out_of_rng[None, :]
    return {
        "scores": scores, "dtm": dtm >= 0, "dt_ig": dt_ig,
        "n_gt": int((~g_ig).sum()),
    }


def compute_coco_stats(predictions, ground_truths, iou_type="bbox",
                       iou_thrs=IOU_THRS, max_dets=None, area_rngs=None,
                       kpt_sigmas=None, recall_thrs=RECALL_THRS):
    """Full COCO protocol over per-image pred/gt dict lists.

    predictions[i]: boxes [N,4] xyxy, scores [N], labels [N], plus
      masks [N,H,W] (segm) or keypoints [N,K,3] (keypoints).
    ground_truths[i]: boxes [M,4], labels [M]; optional iscrowd [M],
      ignore [M], area [M], masks [M,H,W], keypoints [M,K,3].

    Returns dict with 'stats' (the pycocotools 12- or 10-number vector),
    'map'/'map50'/'map75'/'per_class' plus named AR entries.
    """
    iou_thrs = np.asarray(iou_thrs, np.float64)
    if kpt_sigmas is None:
        kpt_sigmas = COCO_KPT_SIGMAS
    if iou_type == "keypoints":
        max_dets = max_dets or [20]
        area_names = ["all", "medium", "large"] if area_rngs is None \
            else list(area_rngs)
    else:
        max_dets = max_dets or [1, 10, 100]
        area_names = ["all", "small", "medium", "large"] if area_rngs is None \
            else list(area_rngs)
    rngs = [AREA_RNG[a] if isinstance(a, str) else tuple(a)
            for a in area_names]

    preps = [_prepare_image(p, g, iou_type, kpt_sigmas)
             for p, g in zip(predictions, ground_truths)]
    classes = sorted({int(c) for pr in preps for c in pr["g_labels"]})

    T, R, K, A, M = (len(iou_thrs), len(recall_thrs), len(classes),
                     len(rngs), len(max_dets))
    precision = -np.ones((T, R, K, A, M))
    recall = -np.ones((T, K, A, M))

    md_max = max(max_dets)
    for ki, cls in enumerate(classes):
        for ai, rng in enumerate(rngs):
            # one greedy match per (class, area) at the LARGEST maxDets;
            # smaller tiers slice the per-image score-ordered prefix
            # (greedy matching has the prefix property — pycocotools
            # does exactly this in accumulate)
            evs = [_evaluate_img(pr, cls, rng, md_max, iou_thrs)
                   for pr in preps]
            evs = [e for e in evs if e is not None]
            if not evs:
                continue
            n_gt = sum(e["n_gt"] for e in evs)
            if n_gt == 0:
                continue
            for mi, md in enumerate(max_dets):
                scores = np.concatenate([e["scores"][:md] for e in evs])
                order = np.argsort(-scores, kind="mergesort")
                dtm = np.concatenate([e["dtm"][:, :md] for e in evs],
                                     1)[:, order]
                dt_ig = np.concatenate([e["dt_ig"][:, :md] for e in evs],
                                       1)[:, order]
                tps = dtm & ~dt_ig
                fps = ~dtm & ~dt_ig
                tp_cum = np.cumsum(tps, 1).astype(np.float64)
                fp_cum = np.cumsum(fps, 1).astype(np.float64)
                for ti in range(T):
                    tp, fp = tp_cum[ti], fp_cum[ti]
                    rc = tp / n_gt
                    pr = tp / np.maximum(tp + fp, np.spacing(1))
                    recall[ti, ki, ai, mi] = rc[-1] if len(rc) else 0.0
                    pr = pr.tolist()
                    for i in range(len(pr) - 1, 0, -1):
                        if pr[i] > pr[i - 1]:
                            pr[i - 1] = pr[i]
                    inds = np.searchsorted(rc, recall_thrs, side="left")
                    q = np.zeros(R)
                    for ri, pi in enumerate(inds):
                        if pi < len(pr):
                            q[ri] = pr[pi]
                    precision[ti, :, ki, ai, mi] = q

    def _summ(ap, iou=None, area="all", md=max_dets[-1]):
        if area not in area_names or md not in max_dets:
            return -1.0  # restricted-protocol call (compute_map facade)
        ai = area_names.index(area)
        mi = max_dets.index(md)
        if ap:
            s = precision[:, :, :, ai, mi]
            if iou is not None:
                s = s[np.where(np.isclose(iou_thrs, iou))[0]]
        else:
            s = recall[:, :, ai, mi]
            if iou is not None:
                s = s[np.where(np.isclose(iou_thrs, iou))[0]]
        valid = s[s > -1]
        return float(valid.mean()) if valid.size else -1.0

    if iou_type == "keypoints":
        stats = [
            _summ(True), _summ(True, iou=0.5), _summ(True, iou=0.75),
            _summ(True, area="medium"), _summ(True, area="large"),
            _summ(False), _summ(False, iou=0.5), _summ(False, iou=0.75),
            _summ(False, area="medium"), _summ(False, area="large"),
        ]
    else:
        stats = [
            _summ(True), _summ(True, iou=0.5), _summ(True, iou=0.75),
            _summ(True, area="small"), _summ(True, area="medium"),
            _summ(True, area="large"),
            _summ(False, md=max_dets[0]),
            _summ(False, md=max_dets[min(1, M - 1)]),
            _summ(False, md=max_dets[-1]),
            _summ(False, area="small"), _summ(False, area="medium"),
            _summ(False, area="large"),
        ]

    # custom area_rngs may omit "all" — fall back to the first range
    ai_all = area_names.index("all") if "all" in area_names else 0
    per_class = {}
    for ki, cls in enumerate(classes):
        s = precision[:, :, ki, ai_all, M - 1]
        valid = s[s > -1]
        per_class[cls] = float(valid.mean()) if valid.size else 0.0
    return {
        "stats": np.asarray(stats),
        "map": max(stats[0], 0.0), "map50": max(stats[1], 0.0),
        "map75": max(stats[2], 0.0),
        "ar": max(stats[-4] if iou_type != "keypoints" else stats[5], 0.0),
        "per_class": per_class,
        "iou_type": iou_type,
    }


def compute_map(predictions, ground_truths, iou_thrs=IOU_THRS, max_dets=100):
    """Bbox mAP facade (kept for the detection accuracy loops).

    predictions: list per image of dict(boxes [N,4] xyxy, scores [N],
      labels [N]).
    ground_truths: list per image of dict(boxes [M,4] xyxy, labels [M]).
    Returns dict with 'map' (AP@[.5:.95]), 'map50', 'map75', per-class APs.
    """
    s = compute_coco_stats(predictions, ground_truths, iou_type="bbox",
                           iou_thrs=iou_thrs, max_dets=[max_dets],
                           area_rngs=["all"])
    return {"map": s["map"], "map50": s["map50"], "map75": s["map75"],
            "per_class": s["per_class"]}


_STAT_NAMES_BOX = [
    "AP@[.50:.95]", "AP@.50", "AP@.75", "AP(small)", "AP(medium)",
    "AP(large)", "AR@1", "AR@10", "AR@100", "AR(small)", "AR(medium)",
    "AR(large)"]
_STAT_NAMES_KPT = [
    "AP@[.50:.95]", "AP@.50", "AP@.75", "AP(medium)", "AP(large)",
    "AR@[.50:.95]", "AR@.50", "AR@.75", "AR(medium)", "AR(large)"]


def summarize_stats(stats, iou_type="bbox"):
    names = _STAT_NAMES_KPT if iou_type == "keypoints" else _STAT_NAMES_BOX
    return "  ".join(f"{n} = {v:.4f}" for n, v in zip(names, stats))


class CocoEvaluator:
    """update/accumulate/summarize facade.

    iou_types may be any subset of ("bbox", "segm", "keypoints"); each
    type evaluates from the same per-image dicts (masks / keypoints keys
    used where relevant). `full_protocol=False` keeps the light bbox-only
    mAP path for the fixture accuracy loops.
    """

    def __init__(self, iou_types=("bbox",), full_protocol=True,
                 kpt_sigmas=None):
        self.iou_types = tuple(iou_types)
        self.full_protocol = full_protocol
        self.kpt_sigmas = kpt_sigmas
        self.reset()

    def reset(self):
        self._preds: list = []
        self._gts: list = []
        self.stats: tp.Optional[dict] = None

    def update(self, predictions, ground_truths):
        """Append one batch: lists per image (see compute_coco_stats)."""
        self._preds.extend(predictions)
        self._gts.extend(ground_truths)

    def synchronize_between_processes(self):
        pass  # one process, as the reference

    def accumulate(self):
        if not self.full_protocol and self.iou_types == ("bbox",):
            self.stats = compute_map(self._preds, self._gts)
            return self.stats
        out = {}
        for it in self.iou_types:
            out[it] = compute_coco_stats(self._preds, self._gts, iou_type=it,
                                         kpt_sigmas=self.kpt_sigmas)
        self.stats = out if len(self.iou_types) > 1 else out[self.iou_types[0]]
        return self.stats

    def summarize(self):
        if self.stats is None:
            self.accumulate()
        s = self.stats
        if isinstance(s, dict) and "map" not in s and "stats" not in s:
            per_type = s  # multi-type: {iou_type: stats_dict}
        else:
            per_type = {self.iou_types[0]: s}
        for it, st in per_type.items():
            if "stats" in st:
                print(f"[{it}] {summarize_stats(st['stats'], it)}")
            else:
                print(f"[{it}] AP@[.50:.95] = {st['map']:.4f}  "
                      f"AP@.50 = {st['map50']:.4f}  AP@.75 = {st['map75']:.4f}")
        return s
