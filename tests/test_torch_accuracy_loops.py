"""The hermetic accuracy checks' loops on the CPU, against the reference's.

(a) Each schedule and optimizer the checks use against optax over five
    steps, to 1e-6: ``cosine_decay_schedule`` (with and without
    ``alpha``), ``warmup_cosine_decay_schedule``, ``adam`` at a constant
    rate, ``adamw`` (decay on every parameter) and
    ``chain(clip_by_global_norm, multi_transform)`` (DETR-R50's backbone
    at a tenth of the rate).
(b) The OCR check's first two AdamW steps at its own width (TrOCR 128
    wide, b32, its schedule), from the reference's TrOCR's weights copied
    by the bridge: the loss at each step (2e-4 relative), the first step's
    gradients (2e-4 of each tensor's largest) and every parameter after
    the second (2e-4).  The port's attention runs its plain version here.
(c) The face check's verification protocol and DETR's predict adapter
    against the reference's functions, on the same arrays.
(d) Each of the nine checks' ``main`` at 2 steps, batch 2 and 4 validation
    images, writing its results JSON to ``tmp_path``.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_cls_attention import _few_threads  # noqa: F401
from tests.test_torch_seg_zoo import _close, _flat
from tlxcv_tpu_torch.train import optimizers as TOpt

STEPS = 5


def _grads(rng, shapes):
    return [{k: rng.normal(size=s).astype(np.float32) * 0.3
             for k, s in shapes.items()} for _ in range(STEPS)]


SHAPES = {"backbone.w": (4, 3), "backbone.b": (3,), "head.w": (3, 2),
          "head.b": (2,)}


def _optax_params(tx, params, grads):
    @jax.jit
    def step(g, state, params):
        u, state = tx.update(g, state, params)
        return optax.apply_updates(params, u), state

    state = tx.init(params)
    out = []
    for g in grads:
        params, state = step({k: jnp.asarray(v) for k, v in g.items()},
                             state, params)
        out.append({k: np.asarray(v) for k, v in params.items()})
    return out


def _port_params(factory, params, grads):
    named = {k: torch.nn.Parameter(torch.from_numpy(np.array(v)))
             for k, v in params.items()}
    opt = factory(named)
    out = []
    for g in grads:
        for k, p in named.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        out.append({k: p.detach().numpy().copy() for k, p in named.items()})
    return out


def _labels(params):
    return {k: "backbone" if k.startswith("backbone") else "main"
            for k in params}


CASES = {
    # FCOS and the sweep, Mask R-CNN, face, video, QAT: cosine from lr
    "adam_cosine": (lambda: optax.adam(optax.cosine_decay_schedule(
        1e-3, STEPS)), lambda: TOpt.Adam(TOpt.cosine_schedule(1e-3, STEPS))),
    # PFLD: cosine to 1% of the rate
    "adam_cosine_alpha": (
        lambda: optax.adam(optax.cosine_decay_schedule(1e-3, STEPS, 1e-2)),
        lambda: TOpt.Adam(TOpt.cosine_schedule(1e-3, STEPS, 1e-2))),
    # SOLOv2: a linear warm-up from 0, then the cosine
    "adam_warmup_cosine": (
        lambda: optax.adam(optax.warmup_cosine_decay_schedule(
            0.0, 1e-3, 2, STEPS)),
        lambda: TOpt.Adam(TOpt.warmup_cosine(1e-3, 2, STEPS))),
    # pose: a constant rate
    "adam_constant": (lambda: optax.adam(1e-3), lambda: TOpt.Adam(1e-3)),
    # OCR: adamw decays every parameter (no mask)
    "adamw_warmup_cosine": (
        lambda: optax.adamw(optax.warmup_cosine_decay_schedule(
            0.0, 5e-4, 2, STEPS), weight_decay=1e-4),
        lambda: TOpt.Adam(TOpt.warmup_cosine(5e-4, 2, STEPS),
                          weight_decay=1e-4)),
    # DETR-R50: clip over every parameter, then one Adam per label
    "clip_multi_transform": (
        lambda: optax.chain(optax.clip_by_global_norm(0.1),
                            optax.multi_transform(
                                {"backbone": optax.adam(
                                    optax.cosine_decay_schedule(2e-5, STEPS)),
                                 "main": optax.adam(
                                    optax.cosine_decay_schedule(2e-4,
                                                                STEPS))},
                                _labels(SHAPES))),
        lambda: TOpt.Adam({"backbone": TOpt.cosine_schedule(2e-5, STEPS),
                           "main": TOpt.cosine_schedule(2e-4, STEPS)},
                          lr_labels=_labels, grad_clip=0.1)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_matches_optax(case):
    rng = np.random.default_rng(len(case))
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = _grads(rng, SHAPES)
    ref, port = CASES[case]
    want = _optax_params(ref(), {k: jnp.asarray(v)
                                 for k, v in params.items()}, grads)
    got = _port_params(port(), params, grads)
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ref, port", [
    (lambda: optax.cosine_decay_schedule(1e-3, STEPS),
     lambda: TOpt.cosine_schedule(1e-3, STEPS)),
    (lambda: optax.cosine_decay_schedule(1e-3, STEPS, 1e-2),
     lambda: TOpt.cosine_schedule(1e-3, STEPS, 1e-2)),
    (lambda: optax.warmup_cosine_decay_schedule(0.0, 5e-4, 2, STEPS),
     lambda: TOpt.warmup_cosine(5e-4, 2, STEPS))],
    ids=["cosine", "cosine_alpha", "warmup_cosine"])
def test_schedule_matches_optax(ref, port):
    """Read at the count of applied updates, 0 first, and past the end."""
    counts = np.arange(STEPS + 3, dtype=np.float32)
    want = np.asarray([ref()(c) for c in counts])
    got = port()(torch.from_numpy(counts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


def test_labels_need_a_rate_each():
    named = {k: torch.nn.Parameter(torch.zeros(s))
             for k, s in SHAPES.items()}
    with pytest.raises(ValueError, match="without a learning rate"):
        TOpt.Adam({"main": 1e-3}, lr_labels=_labels)(named)


# --------------------------------------------------- (b) the OCR check's steps
def test_ocr_first_two_adamw_steps_match_the_reference():
    from demo.ocr import accuracy_check as RO
    from tlxcv_tpu.core import pure, split
    from tlxcv_tpu.models.ocr import CharTokenizer as JTok
    from tlxcv_tpu.models.ocr import TrOCR as JTrOCR
    from tlxcv_tpu_torch.demo.ocr import accuracy_check as PO
    from tlxcv_tpu_torch.models.ocr import CharTokenizer
    from tlxcv_tpu_torch.utils import load_jax_params
    from tlxcv_tpu_torch.utils.bridge import _owner, _to_port_layout

    jtok = JTok()
    jm = JTrOCR(vocab_size=jtok.vocab_size, encoder_dim=128, encoder_depth=3,
                encoder_heads=4, decoder_dim=128, decoder_depth=2,
                decoder_heads=4, img_size=(RO.H, RO.W), patch_size=8,
                max_length=RO.LEN + 3)
    tm = PO.build(CharTokenizer(), "cpu")
    load_jax_params(tm, _flat(jm))
    tm.train()
    params, state = split(jm)
    lp = pure(jm, lambda m, x, y: m.loss_fn(x, y))
    tx = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, 5e-4, 300, 6000),
                     weight_decay=1e-4)
    opt_state = tx.init(params)

    @jax.jit
    def jax_step(params, opt_state, x, y):
        loss, g = jax.value_and_grad(
            lambda p: lp(p, state, x, y, training=True)[0])(params)
        u, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, u), opt_state, loss, g

    opt = PO.optimizer(tm, 6000)
    rng = np.random.default_rng(0)
    for step in range(2):
        x, y, _ = RO.sample(rng, jtok, 32)
        params, opt_state, loss, g = jax_step(params, opt_state,
                                              jnp.asarray(x), jnp.asarray(y))
        g = {k: np.asarray(v) for k, v in g.items()}

        got = tm.loss_fn(torch.from_numpy(x), torch.from_numpy(y))
        opt.zero_grad(set_to_none=True)
        got.backward()
        np.testing.assert_allclose(got.item(), float(loss), rtol=2e-4)
        if step == 0:
            largest = max(np.abs(v).max() for v in g.values())
            for key, want in g.items():
                key = key.replace("/", ".")
                p = tm.get_parameter(key)
                want = _to_port_layout(*_owner(tm, key), want)
                if key.endswith(".k.bias"):
                    # zero by the softmax's shift invariance: noise on both
                    # sides, held against the largest gradient instead
                    assert p.grad.abs().max() <= 1e-6 * largest, key
                    continue
                _close(p.grad, want)
        opt.step()
    for key, want in params.items():
        key = key.replace("/", ".")
        want = _to_port_layout(*_owner(tm, key), np.asarray(want))
        np.testing.assert_allclose(
            tm.get_parameter(key).detach().numpy(), want, rtol=0, atol=2e-4)


# ---------------------------------------- (c) verification and DETR's adapter
def test_face_verification_protocol_matches_the_reference():
    from demo.face_recognition import accuracy_check as RF
    from tlxcv_tpu_torch.demo.face_recognition import accuracy_check as PF

    proj = np.random.default_rng(3).normal(
        size=(PF.SIZE * PF.SIZE * 3, 16)).astype(np.float32)

    def embed(imgs):
        e = np.asarray(imgs, np.float32).reshape(len(imgs), -1) @ proj
        return e / np.linalg.norm(e, axis=1, keepdims=True)

    got = PF.verify(embed, 10000, 123)
    want = RF._verify(lambda p, s, x: embed(x), None, None, 10000, 123)
    assert got[0] == want[0] and got[2] == want[2]
    assert got[1] == want[1]


class _Stub:
    """A DETR whose forward and ``predict_boxes`` return given arrays."""

    def __init__(self, labels, scores, boxes, wrap):
        self.out = tuple(wrap(a) for a in (labels, scores, boxes))
        self.hw = None

    def __call__(self, x):
        return {}

    def predict_boxes(self, out, hw):
        self.hw = tuple(hw)
        return self.out


def test_detr_predict_adapter_matches_the_reference():
    """Descending scores, ties in query order, counted above 0.05."""
    from demo.object_detection import accuracy_sweep as RS
    from tlxcv_tpu_torch.demo.object_detection import accuracy_sweep as PS

    rng = np.random.default_rng(5)
    labels = rng.integers(0, 3, size=(2, 6)).astype(np.int32)
    scores = np.asarray([[0.3, 0.9, 0.3, 0.01, 0.05, 0.7],
                         [0.2, 0.2, 0.2, 0.6, 0.04, 0.2]], np.float32)
    boxes = rng.uniform(0, 128, size=(2, 6, 4)).astype(np.float32)
    x = np.zeros((2, 128, 96, 3), np.float32)
    jstub = _Stub(labels, scores, boxes, jnp.asarray)
    tstub = _Stub(labels, scores, boxes, torch.from_numpy)
    want = RS._detr_predict(jstub, jnp.asarray(x))
    got = PS._detr_predict(tstub, torch.from_numpy(x))
    assert tstub.hw == jstub.hw == (128, 96)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


# ------------------------------------------------ (d) the nine mains, 2 steps
def _fcos(out):
    from tlxcv_tpu_torch.demo.object_detection import accuracy_check

    return accuracy_check.main(device="cpu", steps=2, batch=2, val_num=4,
                               out_dir=out)


def _instance(name):
    def run(out):
        from tlxcv_tpu_torch.demo.object_detection import \
            accuracy_check_instance_seg as m

        return m.main([name], device="cpu", steps=2, batch=2, val_num=4,
                      out_dir=out)
    return run


POSE_CPU = {"steps": 2, "batch": 2, "val_images": 4, "device": "cpu"}


def _pose(out):
    from tlxcv_tpu_torch.demo.human_pose_estimation import accuracy_check

    return accuracy_check.main(**POSE_CPU, out_dir=out)


def _pfld(out):
    from tlxcv_tpu_torch.demo.facial_landmark_detection import \
        accuracy_check

    return accuracy_check.main(steps_l2=2, steps_wing=2, batch=2,
                               val_images=4, recal_batches=2, device="cpu",
                               out_dir=out)


def _face(out):
    from tlxcv_tpu_torch.demo.face_recognition import accuracy_check

    return accuracy_check.main(steps=2, batch_size=2, n_ids=2, per=2,
                               device="cpu", out_dir=out)


def _video(out):
    from tlxcv_tpu_torch.demo.video_classification import accuracy_check

    return accuracy_check.main(steps=2, batch_size=2, val_clips=4,
                               device="cpu", out_dir=out)


def _ocr(out):
    from tlxcv_tpu_torch.demo.ocr import accuracy_check

    return accuracy_check.main(steps=2, batch=2, val_images=4, device="cpu",
                               out_dir=out)


def _qat(out):
    from tlxcv_tpu_torch.demo.image_classification import \
        accuracy_check_qat

    return accuracy_check_qat.main(steps=2, qat_steps=2, batch=2, val_num=4,
                                   device="cpu", out_dir=out)


MAINS = {  # check -> (runner, results file, the metric's key, its value)
    "fcos": (_fcos, "sweep_results.json", "map"),
    "maskrcnn": (_instance("maskrcnn"), "instance_seg_results.json",
                 "segm_map"),
    "solov2": (_instance("solov2"), "instance_seg_results.json",
               "segm_map"),
    "pose": (_pose, "accuracy_results.json", "value"),
    "pfld": (_pfld, "accuracy_results.json", "value"),
    "face": (_face, "accuracy_results.json", "value"),
    "video": (_video, "accuracy_results.json", "value"),
    "ocr": (_ocr, "accuracy_results.json", "value"),
    "qat": (_qat, "accuracy_results_qat.json", "qat_int8_acc"),
}


@pytest.mark.parametrize("name", list(MAINS))
def test_main_runs_two_steps_on_the_cpu(name, tmp_path):
    """Two steps miss every floor (the QAT check's relative one aside):
    ``main`` writes its results file, with its device, launch counts and
    metrics beside their floors, then raises ``BelowFloor`` carrying what
    it wrote (or returns it when every metric clears)."""
    from tlxcv_tpu_torch.demo._accuracy import BelowFloor

    run, results, key = MAINS[name]
    try:
        got = run(str(tmp_path))
    except BelowFloor as e:
        got = e.result
    (r,) = ([row for row in got if row["model"] == name]
            if isinstance(got, list) else [got])
    with open(tmp_path / results) as f:
        written = json.load(f)
    if isinstance(written, list):
        (written,) = [row for row in written if row["model"] == name]
    assert written == json.loads(json.dumps(r))
    assert np.isfinite(r[key])
    assert r["device"] == "cpu"
    assert set(r["kernel_launches"].values()) == {0}
    assert r["metrics"][0]["value"] == r[key]
    for m in r["metrics"]:
        assert m["ok"] == bool(m["value"] >= m["floor"] if m["higher"]
                               else m["value"] <= m["floor"]), m


def _accuracy_lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith('{"phase": "accuracy"')]


def test_accuracy_mode_reads_the_metrics_main_returned(monkeypatch,
                                                       tmp_path, capsys):
    """``chip_smoke.py --accuracy``'s line for a check that missed: the
    metrics its ``main`` carried in ``BelowFloor``, each beside its floor,
    the steps and the launches; the check is returned as failed."""
    import chip_smoke

    assert chip_smoke.ACCURACY_DEFAULT == (
        "fcos", "maskrcnn", "solov2", "pose", "pfld", "face", "video", "ocr",
        "qat")
    monkeypatch.setitem(chip_smoke.ACCURACY_CHECKS, "pose", (
        "human_pose_estimation.accuracy_check", POSE_CPU))
    assert chip_smoke.phase_accuracy(["pose"], str(tmp_path)) == ["pose"]
    (line,) = _accuracy_lines(capsys)
    with open(tmp_path / "human_pose_estimation"
              / "accuracy_results.json") as f:
        written = json.load(f)
    assert "error" not in line and not line["ok"]
    assert [m["metric"] for m in line["metrics"]] == ["pck@0.05", "oks_map"]
    assert line["metrics"] == written["metrics"]
    assert (line["metric"], line["value"], line["floor"]) == (
        "pck@0.05", written["value"], written["bar"])
    assert line["steps"] == {"steps": 2}
    assert line["launches"] == {}


def test_accuracy_mode_reports_a_check_that_raised(monkeypatch, tmp_path,
                                                   capsys):
    """An assert that fails inside a check (not its floor) is an error of
    this run, whatever results file lies in the folder from an earlier
    one."""
    import chip_smoke
    from tlxcv_tpu_torch.demo.human_pose_estimation import accuracy_check

    old = tmp_path / "human_pose_estimation" / "accuracy_results.json"
    old.parent.mkdir()
    old.write_text(json.dumps({"metric": "pck@0.05", "value": 1.0,
                               "bar": 0.95, "metrics": [{
                                   "metric": "pck@0.05", "value": 1.0,
                                   "floor": 0.95, "higher": True,
                                   "ok": True}]}))

    def broken(**kw):
        raise AssertionError("a shape check inside the model")

    monkeypatch.setattr(accuracy_check, "main", broken)
    assert chip_smoke.phase_accuracy(["pose"], str(tmp_path)) == ["pose"]
    (line,) = _accuracy_lines(capsys)
    assert "a shape check inside the model" in line["error"]
    assert "metrics" not in line and not line["ok"]


# ------------------------------------------- the checks' shared host pieces
def test_merge_rows_keeps_every_writers_rows(tmp_path):
    """Writers that merge into one results file side by side (as the card's
    lanes do) lose no row: more threads than cores, each with its own open
    of the folder's lock."""
    import os
    import sys
    import threading

    from tlxcv_tpu_torch.demo._accuracy import merge_rows

    path = str(tmp_path / "rows.json")
    n_threads, n_rows = (os.cpu_count() or 2) + 4, 10

    def write(i):
        for j in range(n_rows):
            merge_rows(path, [{"model": f"{i}-{j}"}],
                       order=lambda r: r["model"])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=write, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    with open(path) as f:
        rows = json.load(f)
    assert len(rows) == n_threads * n_rows
    assert rows == sorted(rows, key=lambda r: r["model"])


def test_launch_counts_report_the_f32_route_on_request():
    """``ops.cuda``'s counters, which the checks and ``chip_smoke.py``
    share: the flash kernels' f32 launches under ``<name>_f32`` unless
    ``f32=False`` (the default run's exact launch checks), and one reset
    for both counts."""
    from tlxcv_tpu_torch.ops.cuda import (attention, launch_counts,
                                          reset_launches)

    reset_launches()
    attention.flash_attention.launches = 5
    attention.flash_attention.f32_launches = 3
    attention.flash_attention_backward.f32_launches = 2
    try:
        counts = launch_counts()
        assert (counts["flash_attention"], counts["flash_attention_f32"],
                counts["flash_attention_backward_f32"]) == (5, 3, 2)
        plain = launch_counts(f32=False)
        assert plain == {k: v for k, v in counts.items()
                         if not k.endswith("_f32")}
    finally:
        reset_launches()
    assert set(launch_counts().values()) == {0}
