"""The port's datasets and host transforms against the JAX package's on the
CPU, on files each test writes (nothing is downloaded).

Datasets: CIFAR-10 pickles, Circles from a seed, WIDER FACE's label.txt,
300-W's ``.pts``, CASIA-WebFace folders and a COCO instances/keypoints
JSON over JPEGs, each held item by item equal (JPEGs decode through each
package's own native libjpeg build, bitwise).  Transforms: the detection
and landmark pipelines equal, the landmark draws from seeded generators of
both kinds the reference takes.  DETR's post-processing runs on tensors
in the port: within 1e-6 of the reference's numpy.
"""
import json
import pickle
import random

import numpy as np
import pytest
import torch
from PIL import Image

import tlxcv_tpu.data as JD
import tlxcv_tpu_torch.data as TD
from tlxcv_tpu.data import det_transforms as JDT
from tlxcv_tpu.data import landmark_transforms as JLT
from tlxcv_tpu_torch.data import det_transforms as TDT
from tlxcv_tpu_torch.data import landmark_transforms as TLT


def _equal(a, b):
    """Nested items equal: arrays exactly, with their dtypes."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)) and not isinstance(b, np.ndarray):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _same_items(port, ref):
    assert len(port) == len(ref) > 0
    for i in range(len(ref)):
        _equal(port[i], ref[i])


def _image(rng, h, w):
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def test_cifar10_items_equal_jax(tmp_path, rng):
    base = tmp_path / "cifar-10-batches-py"
    base.mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(base / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (3, 3072),
                                               dtype=np.uint8),
                         b"labels": rng.integers(0, 10, 3).tolist()}, f)
    for split in ("train", "test"):
        _same_items(TD.Cifar10(str(tmp_path), split=split),
                    JD.Cifar10(str(tmp_path), split=split))
    with pytest.raises(FileNotFoundError):
        TD.Cifar10(str(tmp_path / "missing"))


@pytest.mark.parametrize("nx,nc", [(64, 1), (172, 3)])
def test_circles_items_equal_jax(nx, nc):
    _same_items(TD.Circles(3, nx=nx, ny=nx, nc=nc, seed=5),
                JD.Circles(3, nx=nx, ny=nx, nc=nc, seed=5))


def test_wider_items_and_split_equal_jax(tmp_path, rng):
    root = tmp_path / "wider"
    (root / "train" / "images" / "0").mkdir(parents=True)
    lines = []
    for i in range(3):
        name = f"0/img{i}.png"
        Image.fromarray(_image(rng, 40 + i, 50)).save(
            root / "train" / "images" / name)
        lines.append(f"# {name}")
        for j in range(i + 1):
            row = [*rng.integers(0, 30, 2), *rng.integers(5, 15, 2)]
            if j % 2 == 0:  # 5 landmarks (x, y, vis) and a score
                pts = [[*rng.uniform(0, 40, 2), 0.0] for _ in range(5)]
                row += [v for p in pts for v in p] + [0.9]
            lines.append(" ".join(str(float(v)) for v in row))
    (root / "train" / "label.txt").write_text("\n".join(lines) + "\n")
    _same_items(TD.Wider(str(root)), JD.Wider(str(root)))
    samples = TD.wider.parse_wider_txt(str(root / "train" / "label.txt"))
    assert samples == JD.wider.parse_wider_txt(
        str(root / "train" / "label.txt"))
    assert (TD.wider.split_train_test(samples * 7, 0.3, seed=2)
            == JD.wider.split_train_test(samples * 7, 0.3, seed=2))


def test_face300w_items_equal_jax(tmp_path, rng):
    for i in range(12):
        d = tmp_path / f"set{i % 2}"
        d.mkdir(exist_ok=True)
        Image.fromarray(_image(rng, 24, 20)).save(d / f"f{i}.png")
        pts = rng.uniform(0, 20, (68, 2))
        body = "\n".join(f"{x:.3f} {y:.3f}" for x, y in pts)
        (d / f"f{i}.pts").write_text(
            f"version: 1\nn_points: 68\n{{\n{body}\n}}\n")
    for split in ("train", "test", "all"):
        _same_items(TD.Face300W(str(tmp_path), split=split),
                    JD.Face300W(str(tmp_path), split=split))


def test_casiawebface_items_equal_jax(tmp_path, rng):
    for c in ("0001", "0002", "0003"):
        (tmp_path / c).mkdir()
        for i in range(4):
            Image.fromarray(_image(rng, 16, 16)).save(
                tmp_path / c / f"{i}.jpg")
    for split in ("train", "test"):
        port = TD.CasiaWebFace(str(tmp_path), split=split, test_ratio=0.25)
        ref = JD.CasiaWebFace(str(tmp_path), split=split, test_ratio=0.25)
        assert port.num_classes == ref.num_classes == 3
        _same_items(port, ref)


def _coco_files(tmp_path, rng):
    """Four JPEGs and their instances JSON: polygons, a crowd annotation,
    an image whose only annotation is crowd, keypoints."""
    images, anns = [], []
    for i in range(4):
        name = f"{i:03d}.jpg"
        Image.fromarray(_image(rng, 60 + 4 * i, 80)).save(
            tmp_path / name, quality=90)
        images.append({"id": i + 1, "file_name": name})
        for j in range(2 if i != 2 else 1):
            x, y = (float(v) for v in rng.integers(0, 40, 2))
            w, h = (float(v) for v in rng.integers(5, 30, 2))
            kp = np.zeros((17, 3))
            kp[:5] = np.c_[rng.uniform(x, x + w, 5), rng.uniform(y, y + h, 5),
                           np.full(5, 2)]
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": [3, 7][j], "bbox": [x, y, w, h],
                         "area": w * h, "iscrowd": int(i == 2 or j == 1
                                                       and i == 3),
                         "segmentation": [[x, y, x + w, y, x + w, y + h]],
                         "keypoints": kp.reshape(-1).tolist(),
                         "num_keypoints": 5 if j == 0 else 0})
    path = tmp_path / "instances.json"
    path.write_text(json.dumps({
        "images": images, "annotations": anns,
        "categories": [{"id": 3, "name": "a"}, {"id": 7, "name": "b"}]}))
    return str(path)


def test_coco_datasets_equal_jax(tmp_path, rng):
    ann = _coco_files(tmp_path, rng)
    root = str(tmp_path)
    _same_items(TD.CocoDetection(root, ann), JD.CocoDetection(root, ann))
    _same_items(TD.CocoDetection(root, ann, filter_crowd=False),
                JD.CocoDetection(root, ann, filter_crowd=False))
    _same_items(TD.CocoHumanPoseEstimation(root, ann),
                JD.CocoHumanPoseEstimation(root, ann))
    port = TD.CocoDetection(root, ann, raw_annotations=True,
                            transforms=TDT.DetCompose(
                                [TDT.LabelFormatConvert()]))
    ref = JD.CocoDetection(root, ann, raw_annotations=True,
                           transforms=JDT.DetCompose(
                               [JDT.LabelFormatConvert()]))
    _same_items(port, ref)
    assert port[0][1]["masks"].any()  # the polygons were rasterised
    idx = TD.CocoIndex(ann)
    assert idx.get_img_ids() == JD.CocoIndex(ann).get_img_ids()


def _det_sample(rng, h=61, w=83, n=3):
    xy = rng.uniform(0, 40, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 20, (n, 2))], 1)
    masks = rng.random((n, h, w)) < 0.3
    return _image(rng, h, w), {
        "boxes": boxes.astype(np.float32),
        "class_labels": rng.integers(0, 5, n), "masks": masks,
        "area": rng.uniform(10, 200, n).astype(np.float32),
        "gt_score": rng.random(n).astype(np.float32)}


@pytest.mark.parametrize("size,max_size,divide", [
    (40, None, None), (48, 60, None), ((50, 70), None, 32), (61, None, 8)])
def test_detection_transforms_equal_jax(rng, size, max_size, divide):
    image, target = _det_sample(rng)

    def pipeline(M):
        return M.DetCompose([M.DetResize(size, max_size, divide),
                             M.DetNormalize((0.4, 0.5, 0.6), (0.2, 0.3, 0.1)),
                             M.PadGTSingle(num_max_boxes=5)])

    _equal(pipeline(TDT)(image, dict(target)),
           pipeline(JDT)(image, dict(target)))
    _equal(TDT.DetResize(size, max_size, divide)((image, dict(target))),
           JDT.DetResize(size, max_size, divide)((image, dict(target))))
    np.testing.assert_array_equal(
        TDT.corners_to_center_format(target["boxes"]),
        JDT.corners_to_center_format(target["boxes"]))
    cxcywh = TDT.corners_to_center_format(target["boxes"])
    np.testing.assert_array_equal(
        TDT.center_to_corners_format(torch.from_numpy(cxcywh)).numpy(),
        JDT.center_to_corners_format(cxcywh))


def test_detr_post_processing_within_1e_6_of_jax(rng):
    logits = rng.normal(size=(2, 6, 5)).astype(np.float32) * 3
    boxes = rng.uniform(0.1, 0.6, (2, 6, 4)).astype(np.float32)
    sizes = np.asarray([[48, 64], [40, 40]])
    for top_k in (None, 2):
        got = TDT.detr_post_process(torch.from_numpy(logits),
                                    torch.from_numpy(boxes),
                                    torch.from_numpy(sizes), top_k=top_k)
        want = JDT.detr_post_process(logits, boxes, sizes, top_k=top_k)
        for g, w in zip(got, want):
            for k in ("scores", "labels", "boxes"):
                assert isinstance(g[k], torch.Tensor)
                np.testing.assert_allclose(g[k].numpy(), w[k], rtol=0,
                                           atol=1e-6 * max(1.0, np.abs(
                                               w[k]).max(initial=0)))
    masks = rng.normal(size=(2, 6, 12, 16)).astype(np.float32) * 4
    got = TDT.detr_post_process_segmentation(
        torch.from_numpy(logits), torch.from_numpy(masks), sizes,
        threshold=0.3)
    want = JDT.detr_post_process_segmentation(logits, masks, sizes,
                                              threshold=0.3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["scores"].numpy(), w["scores"],
                                   atol=1e-6)
        np.testing.assert_array_equal(g["labels"].numpy(), w["labels"])
        # the mask logits resized within 1e-6 of cv2's: a pixel flips only
        # where its sigmoid sits within that of the threshold
        assert g["masks"].shape == w["masks"].shape
        assert (g["masks"].numpy() != w["masks"]).mean() < 1e-3
    assert sum(len(w["scores"]) for w in want) > 0


def _face(rng, n=68):
    return _image(rng, 96, 88), {
        "landmark": (rng.uniform(20, 70, (n, 2))).astype(np.float32)}


def test_landmark_transforms_equal_jax(rng):
    def pipeline(M, gen_flip, gen_rot, gen_occ):
        return M.LandmarkCompose([
            M.Crop(), M.RandomRotate([-10, 0, 15], rng=gen_rot),
            M.LandmarkResize(64), M.RandomHorizontalFlip(rng=gen_flip),
            M.CalculateEulerAngles(), M.RandomOcclude((12, 10), rng=gen_occ),
            M.LandmarkNormalize(), M.ToTuple()])

    for seed in range(4):
        image, label = _face(np.random.default_rng(seed))
        got = pipeline(TLT, np.random.default_rng(seed),
                       np.random.default_rng(seed + 9),
                       random.Random(seed))(image, dict(label))
        want = pipeline(JLT, np.random.default_rng(seed),
                        np.random.default_rng(seed + 9),
                        random.Random(seed))(image, dict(label))
        _equal(got, want)
    pts = rng.uniform(0, 200, (14, 2))
    assert TLT.calculate_pitch_yaw_roll(pts) == JLT.calculate_pitch_yaw_roll(
        pts)
    assert TLT.MIRROR_INDEXES_68 == JLT.MIRROR_INDEXES_68
    assert TLT.TRACKED_POINTS_68 == JLT.TRACKED_POINTS_68


def test_fused_resize_normalize_equals_jax(rng):
    from tlxcv_tpu.data.transforms import FusedResizeNormalize as JF
    from tlxcv_tpu_torch.data.transforms import FusedResizeNormalize as TF

    batch = rng.integers(0, 256, (3, 37, 53, 3), dtype=np.uint8)
    args = ((24, 30), (120.0, 110.0, 100.0), (60.0, 50.0, 40.0))
    _equal(TF(*args)(batch), JF(*args)(batch))
    _equal(TF(*args)(batch[0]), JF(*args)(batch[0]))
