"""Gates over the committed results of the port's hermetic accuracy checks
(``tlxcv_tpu_torch/demo/*/``), as ``tests/test_accuracy_result_gates.py``
gates the reference's: each value against its floor, judged by the floors
of the scripts as they stand, and each file from a run on an NVIDIA card
at the reference's step counts that reached the kernels its path runs.
A results file not yet produced on this checkout skips.  A card run that
missed its floor is kept beside the script as ``*_below_floor.json``,
with an open fault in ROADMAP queue 3; its gate then skips naming that
file, and the file itself is held to what it says it is: a full run on
the card."""
import json
import os

import pytest

from tlxcv_tpu_torch.demo.object_detection import accuracy_sweep as S
from tlxcv_tpu_torch.demo.object_detection.accuracy_check_instance_seg \
    import FLOORS

DEMO = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tlxcv_tpu_torch", "demo")


def _load(*path):
    p = os.path.join(DEMO, *path)
    if not os.path.exists(p):
        miss = p.replace(".json", "_below_floor.json")
        if os.path.exists(miss):
            pytest.skip(f"{'/'.join(path)}: the card's run missed its floor "
                        f"({os.path.basename(miss)}; ROADMAP queue 3)")
        pytest.skip(f"{'/'.join(path)} not yet produced on this checkout")
    with open(p) as f:
        return json.load(f)


def _on_the_card(r, **kernels):
    """Run on an NVIDIA card, with these kernels' launches above 0."""
    assert "NVIDIA" in r["device"], r["device"]
    for name in kernels:
        assert r["kernel_launches"][name] > 0, (name, r["kernel_launches"])


def test_fcos_and_the_sweep_rows():
    rows = {r["model"]: r for r in _load("object_detection",
                                         "sweep_results.json")}
    assert "fcos" in rows
    for name, r in rows.items():
        _, steps, _, floor = S.REGISTRY[name][:4]
        assert "error" not in r, r
        _on_the_card(r)
        assert r["steps"] == steps, (name, r["steps"])
        assert r["floor"] == floor
        assert r["map"] >= floor, (name, r["map"], floor)


def test_sweep_int8_rows():
    for r in _load("object_detection", "int8_results.json"):
        assert "error" not in r, r
        _on_the_card(r, int8_matmul=True)
        assert r["steps"] == S.REGISTRY[r["model"]][1]
        assert r["int8_map"] >= r["map"] - 0.02, r
        assert r["map"] >= S.REGISTRY[r["model"]][3], r


def test_instance_seg_rows():
    rows = {r["model"]: r for r in _load("object_detection",
                                         "instance_seg_results.json")}
    steps = {"maskrcnn": 2500, "solov2": 4000}
    keys = {"segm": "segm_map", "bbox": "bbox_map"}
    for model, bars in FLOORS.items():
        r = rows[model]
        assert r["steps"] == steps[model]
        for key, floor in bars.items():
            assert r[keys[key]] >= floor, (model, key, r)
    _on_the_card(rows["maskrcnn"], gather_rows=True, upsample_add_fused=True,
                 sep_resize=True)
    _on_the_card(rows["solov2"])


def test_detr_r50_row():
    r = _load("object_detection", "detr_r50_results.json")
    _on_the_card(r, flash_attention=True, flash_attention_backward=True)
    assert (r["steps"], r["pretrain_steps"]) == (12000, 1500)
    assert r["map"] >= r["floor"] == 0.55, r


def test_pose_bars():
    r = _load("human_pose_estimation", "accuracy_results.json")
    _on_the_card(r)
    assert r["steps"] == 800
    assert r["value"] >= r["bar"] == 0.95, r
    assert r["oks_map"] >= r["oks_bar"] == 0.80, r


def test_pfld_nme_bar():
    r = _load("facial_landmark_detection", "accuracy_results.json")
    _on_the_card(r)
    assert r["mode"].startswith("eval")
    assert (r["steps_l2"], r["steps_wing"]) == (8000, 2000)
    assert r["value"] <= r["bar"] == 0.06, r


def test_face_verification_bar():
    r = _load("face_recognition", "accuracy_results.json")
    _on_the_card(r)
    assert r["metric"] == "verification_accuracy"
    assert r["steps"] <= 4000 and r["pairs"] == 2 * 16 * 28
    assert r["value"] >= r["bar"] == 0.93, r


def test_video_clip_bar():
    r = _load("video_classification", "accuracy_results.json")
    _on_the_card(r)
    assert (r["steps"], r["clips"]) == (400, 128)
    assert r["value"] >= r["bar"] == 0.90, r


def _ocr_on_the_card(r):
    # the f32 (split TF32) flash kernels, forward and backward
    _on_the_card(r, flash_attention_f32=True,
                 flash_attention_backward_f32=True)
    assert (r["steps"], r["n"], r["bar"]) == (6000, 128, 0.02)


def test_ocr_cer_bar():
    r = _load("ocr", "accuracy_results.json")
    _ocr_on_the_card(r)
    assert r["value"] <= r["bar"], r


def test_ocr_from_the_reference_initial_weights():
    """The check's loop from the JAX package's own initial TrOCR (``--init``;
    its draw at the reference script's seed) clears the floor."""
    r = _load("ocr", "accuracy_results_reference_init.json")
    _ocr_on_the_card(r)
    assert r["init"] == "ocr_ref_init.npz"
    assert r["value"] <= r["bar"], r


@pytest.mark.parametrize("path", [
    ("ocr", "accuracy_results_below_floor.json"),
    ("object_detection", "detr_r50_results_below_floor.json")],
    ids=["ocr", "detr_r50"])
def test_a_miss_on_record_is_a_full_card_run(path):
    r = _load(*path)
    if path[0] == "ocr":
        _ocr_on_the_card(r)
        assert r["value"] > r["bar"], r
    else:
        _on_the_card(r, flash_attention=True, flash_attention_backward=True)
        assert (r["steps"], r["pretrain_steps"]) == (12000, 1500)
        assert r["map"] < r["floor"] == 0.55, r


def test_vit_qat_int8_bar():
    r = _load("image_classification", "accuracy_results_qat.json")
    _on_the_card(r, int8_matmul=True, flash_attention_f32=True)
    assert (r["steps"], r["qat_steps"], r["images"]) == (1500, 600, 512)
    assert r["qat_int8_launches"] > 0
    assert r["qat_int8_acc"] >= r["float_acc"] - 0.02, r
    assert r["qat_int8_acc"] >= r["ptq_acc"] - 0.005, r
    assert r["pass"], r
