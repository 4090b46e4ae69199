"""The port's Charades and Synth90k datasets against the JAX package's,
item for item, on synthetic files written to ``tmp_path``: Charades'
frame folders (PNG, read by OpenCV) and its CSV of actions, Synth90k's
annotation file and word crops (PNG, read by PIL), also through
``TrOCRTransform`` on a character tokenizer.  Frames, images, labels and
ids exactly; the loader's batches of both."""
import csv

import numpy as np
import pytest

from tlxcv_tpu.data import Charades as JCharades
from tlxcv_tpu.data import Synth90k as JSynth90k
from tlxcv_tpu.models.ocr import CharTokenizer as JCharTokenizer
from tlxcv_tpu.models.ocr import TrOCRTransform as JTrOCRTransform
from tlxcv_tpu_torch.data import Charades, DataLoader, Synth90k
from tlxcv_tpu_torch.data.charades import NUM_CLASSES
from tlxcv_tpu_torch.models.ocr import CharTokenizer, TrOCRTransform


@pytest.fixture
def charades_root(tmp_path, rng):
    cv2 = pytest.importorskip("cv2")
    frames = tmp_path / "frames"
    rows = [("V001", "c012 0.0 0.3;c156 0.2 1.0"), ("V002", ""),
            ("V003", "c000 0.5 0.9")]
    for (vid, _), n in zip(rows, (30, 12, 45)):
        d = frames / vid
        d.mkdir(parents=True)
        for i in range(n):
            img = rng.integers(0, 256, size=(18, 24, 3), dtype=np.uint8)
            cv2.imwrite(str(d / f"{vid}-{i:06d}.png"), img)
    with open(tmp_path / "charades.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["id", "actions"])
        w.writeheader()
        for vid, acts in rows:
            w.writerow({"id": vid, "actions": acts})
    return str(frames), str(tmp_path / "charades.csv")


@pytest.mark.parametrize("num_frames", [8, 32])
def test_charades_items_match_jax(charades_root, num_frames):
    root, csv_file = charades_root
    ds = Charades(root, csv_file, num_frames=num_frames)
    ref = JCharades(root, csv_file, num_frames=num_frames)
    assert len(ds) == len(ref) == 3 and ds.videos == ref.videos
    for i in range(3):
        (x, y), (wx, wy) = ds[i], ref[i]
        assert x.shape == (num_frames, 18, 24, 3) and x.dtype == np.float32
        assert y.shape == (num_frames, NUM_CLASSES)
        np.testing.assert_array_equal(x, wx)
        np.testing.assert_array_equal(y, wy)
    assert ds[0][1][:, 12].sum() > 0 and ds[1][1].sum() == 0


def test_charades_loader_batches(charades_root):
    root, csv_file = charades_root
    x, y = next(iter(DataLoader(Charades(root, csv_file, num_frames=8),
                                batch_size=2)))
    assert x.shape == (2, 8, 18, 24, 3) and y.shape == (2, 8, NUM_CLASSES)


WORDS = ["hello", "Tpu", "x42", "naive"]


@pytest.fixture
def synth_root(tmp_path, rng):
    from PIL import Image

    lines = []
    for i, word in enumerate(WORDS):
        d = tmp_path / str(i)
        d.mkdir()
        h, w = 31 + i, 20 * len(word)
        img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        path = f"{i}/{i}_{word}_{100 + i}.png"
        Image.fromarray(img).save(tmp_path / path)
        lines.append(f"./{path} {100 + i}")
    (tmp_path / "annotation_train.txt").write_text("\n".join(lines) + "\n")
    return str(tmp_path)


def test_synth90k_items_match_jax(synth_root):
    ds, ref = Synth90k(synth_root), JSynth90k(synth_root)
    assert len(ds) == len(ref) == 4 and ds.samples == ref.samples
    for i, word in enumerate(WORDS):
        (img, got), (want_img, want) = ds[i], ref[i]
        assert got == want == word and img.dtype == np.uint8
        np.testing.assert_array_equal(img, want_img)


def test_synth90k_through_the_trocr_transform_matches_jax(synth_root):
    pytest.importorskip("cv2")
    tok, jtok = CharTokenizer(), JCharTokenizer()
    ds = Synth90k(synth_root, transforms=TrOCRTransform(
        tok, size=(48, 64), max_length=8))
    ref = JSynth90k(synth_root, transforms=JTrOCRTransform(
        jtok, size=(48, 64), max_length=8))
    for i in range(len(ds)):
        (x, ids), (wx, wids) = ds[i], ref[i]
        np.testing.assert_array_equal(x, wx)
        np.testing.assert_array_equal(ids, wids)
    x, ids = next(iter(DataLoader(ds, batch_size=4)))
    assert x.shape == (4, 48, 64, 3) and ids.shape == (4, 8)
    assert tok.decode(ids[0]) == "hello"
