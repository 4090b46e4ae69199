"""``Config``, ``utils.convert``, ``utils.theseus`` and ``utils.profiler``
of the port against the JAX package's on the CPU.

- ``Config.from_file`` of the three flat YAMLs builds the task the
  reference builds: the same parameter count, and with the reference's
  weights bridged across, outputs within 2e-4 of the largest magnitude
  (``tests/test_parity_resnet.py:91``); ``chip_smoke.py``'s copies of the
  configs (for a machine without PyYAML) equal the files.
- ``convert_by_order`` of synthetic torch- and paddle-layout state dicts
  (ResNet-18, a square Linear, a square ConvTranspose), by names and by
  definition order alone, writes what the reference writes: bitwise the
  bridge of the JAX result.
- ``record_features`` and ``upgrade_sublayer`` reach the same sub-layers by
  the same paths; the recorded features within 2e-4.
"""
import json
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
import tlxcv_tpu.config as JCFG
import tlxcv_tpu.nn as jnn
import tlxcv_tpu_torch.config as TCFG
from tlxcv_tpu.core import pure, split
from tlxcv_tpu.core.module import Module as JModule
from tlxcv_tpu.models.classification import resnet18 as j_resnet18
from tlxcv_tpu.utils import convert as JCV
from tlxcv_tpu.utils import theseus as JTH
from tlxcv_tpu_torch import nn as tnn
from tlxcv_tpu_torch.models.classification import resnet18
from tlxcv_tpu_torch.utils import convert as TCV
from tlxcv_tpu_torch.utils import load_jax_params
from tlxcv_tpu_torch.utils import profiler as TPR
from tlxcv_tpu_torch.utils import theseus as TTH
from tlxcv_tpu_torch.utils.metrics import Accuracy


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flat(jax_module):
    params, state = split(jax_module)
    return {k: np.asarray(v) for k, v in {**params, **state}.items()}


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 2e-4 * np.abs(want).max()


# config -> (input shape, the output compared)
CONFIGS = {"configs/resnet50_cifar10.yaml": ((2, 32, 32, 3), None),
           "configs/unet_circles.yaml": ((1, 172, 172, 1), None),
           "configs/yolov3_coco.yaml": ((1, 64, 64, 3), "head_outputs")}


@pytest.mark.parametrize("path", sorted(CONFIGS))
def test_config_builds_the_reference_task(path, rng):
    shape, method = CONFIGS[path]
    jcfg = JCFG.Config.from_file(path)
    tcfg = TCFG.Config.from_file(path)
    assert tcfg == TCFG.Config(**vars(jcfg))
    with open(path) as f:
        assert chip_smoke.DATA_CONFIGS[path] == yaml.safe_load(f)
    jt = jcfg.build_task()
    tt = tcfg.build_task(device="cpu").eval()
    assert type(tt).__name__ == type(jt).__name__
    flat = _flat(jt)
    n_params = sum(p.numel() for p in tt.parameters())
    assert n_params == sum(int(np.prod(v.value.shape))
                           for _, v in jt.variables(jnn.Param))
    load_jax_params(tt, flat)
    x = rng.normal(size=shape).astype(np.float32)
    fn = (lambda m, v: m(v)) if method is None else \
        (lambda m, v: getattr(m.backbone, method)(v))
    want, _ = pure(jt, fn)(*split(jt), jnp.asarray(x))
    with torch.no_grad():
        got = fn(tt, torch.from_numpy(x))
    for g, w in zip(got if method else [got], want if method else [want]):
        _close(g.numpy(), w)


def test_config_from_json_builds_a_trainer_and_raises_where_unported(
        tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"model": "resnet18", "model_kwargs": {
        "num_classes": 4}, "lr": 0.01, "optimizer": "SGD", "seed": 3,
        "ema_decay": 0.9}))
    cfg = TCFG.Config.from_file(str(path))
    assert cfg == TCFG.Config(**vars(JCFG.Config.from_file(str(path))))
    trainer = cfg.build_trainer(device="cpu", metrics=Accuracy())
    assert trainer.device.type == "cpu" and trainer.ema_decay == 0.9
    assert isinstance(trainer.metrics, Accuracy)
    assert isinstance(trainer.optimizer, torch.optim.Optimizer)
    with pytest.raises(NotImplementedError, match="item 12"):
        TCFG.Config(model="dcgan", task="gan").build_task(device="cpu")
    if not torch.cuda.is_available():  # the card unless given a device
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cfg.build_model()


class _JSquare(JModule):
    def __init__(self):
        self.fc = jnn.Linear(16, 16)
        self.up = jnn.ConvTranspose2d(4, 4, 3, stride=2)


class _TSquare(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = tnn.Linear(16, 16, device="cpu")
        self.up = tnn.ConvTranspose2d(4, 4, 3, stride=2, device="cpu")


def _pairs(name):
    if name == "resnet18":
        return j_resnet18(num_classes=10), resnet18(num_classes=10,
                                                    device="cpu")
    return _JSquare(), _TSquare()


def _source(model, source, rng):
    """A synthetic state dict of ``model``'s tensors as torch or paddle
    stores them: torchvision names (no ``layers`` segment), random values;
    paddle names its BatchNorm statistics ``_mean``/``_variance`` and stores
    a Linear's weight (in, out)."""
    linear, _ = TCV._kernel_kind_paths(model)
    out = {}
    for k, v in model.state_dict().items():
        arr = rng.normal(size=tuple(v.shape)).astype(np.float32)
        if k.endswith("running_var"):
            arr = np.abs(arr) + 0.5
        name = k.replace(".layers.", ".")
        if source == "paddle":
            name = name.replace("running_mean", "_mean").replace(
                "running_var", "_variance")
            if k in linear:
                arr = np.ascontiguousarray(arr.T)
        out[name] = arr
    return out


@pytest.mark.parametrize("by", ["names", "order"])
@pytest.mark.parametrize("source", ["torch", "paddle"])
@pytest.mark.parametrize("name", ["resnet18", "square"])
def test_convert_by_order_writes_what_the_reference_writes(name, source, by,
                                                           rng):
    jm, tm = _pairs(name)
    src = _source(tm, source, rng)
    if by == "order":  # no name matches: the order pass places everything
        src = {f"model.{i}.{k.rsplit('.', 1)[-1]}": v
               for i, (k, v) in enumerate(src.items())}
    jrep, trep = {}, {}
    assert JCV.convert_by_order(src, jm, source=source, report=jrep) == []
    assert TCV.convert_by_order(src, tm, source=source, report=trep) == []
    assert trep["matches"] == [(s, d.replace("/", ".")) for s, d in
                               jrep["matches"]]
    want = _pairs(name)[1]
    load_jax_params(want, _flat(jm))
    for k, v in want.state_dict().items():
        assert torch.equal(tm.state_dict()[k], v), k


def test_convert_array_and_loaders(tmp_path, rng):
    w = rng.normal(size=(6, 6)).astype(np.float32)
    # the square trap, inverted: torch as it is, paddle transposed
    np.testing.assert_array_equal(
        TCV.convert_array(w, (6, 6), "torch", linear_weight=True), w)
    np.testing.assert_array_equal(
        TCV.convert_array(w, (6, 6), "paddle", linear_weight=True), w.T)
    ct = rng.normal(size=(4, 2, 3, 3)).astype(np.float32)
    assert TCV.convert_array(ct, (2, 4, 3, 3), convtranspose_weight=True) \
        is None
    src = rng.normal(size=(10, 8 * 3 * 2)).astype(np.float32)
    np.testing.assert_array_equal(TCV.chw_flatten_to_hwc(src, 8, 3, 2),
                                  JCV.chw_flatten_to_hwc(src, 8, 3, 2))
    sd = {"a.weight": torch.from_numpy(w), "n": torch.tensor(3)}
    torch.save(sd, tmp_path / "w.pth")
    got = TCV.load_torch_weights(str(tmp_path / "w.pth"))
    want = JCV.load_torch_weights(str(tmp_path / "w.pth"))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    with open(tmp_path / "w.pdparams", "wb") as f:
        pickle.dump({"fc.w_0": w, "fc.b_0": w[0]}, f)
    got = TCV.load_pdparams(str(tmp_path / "w.pdparams"))
    want = JCV.load_pdparams(str(tmp_path / "w.pdparams"))
    assert got.keys() == want.keys()
    model = _TSquare().eval()
    x = rng.normal(size=(2, 16)).astype(np.float32)
    rep = TCV.parity_report(model.fc, lambda v: v @ model.fc.weight.detach()
                            .numpy().T + model.fc.bias.detach().numpy(), x)
    assert rep["pass"] and rep["max_abs_diff"] <= 1e-5


def test_theseus_reaches_the_reference_sub_layers(rng):
    jm, tm = _pairs("resnet18")
    load_jax_params(tm, _flat(jm))
    tm.eval()
    assert ({p for p, _ in TTH.named_modules(tm)}
            == {p for p, _ in JTH.named_modules(jm)})
    assert isinstance(TTH.get_by_path(tm, "layer2/layers/1/conv2"),
                      tnn.Conv2d)
    patterns = ["layer1", "layer3/layers/0/conv*", "fc"]
    want_store = JTH.record_features(jm, patterns)
    got_store = TTH.record_features(tm, patterns)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)

    def run(m, v):
        out = m(v)
        return out, dict(want_store)

    (_, want), _ = pure(jm, run)(*split(jm), jnp.asarray(x))
    with torch.no_grad():
        tm(torch.from_numpy(x))
    assert sorted(got_store) == sorted(want) and len(want) > 3
    for k in want:
        _close(got_store[k].numpy(), want[k])
    hits_j = JTH.upgrade_sublayer(jm, "layer4/*/relu*", lambda m: m)
    hits_t = TTH.upgrade_sublayer(tm, "layer4/*/relu*",
                                  lambda m: torch.nn.Identity())
    assert hits_t == hits_j


def test_profiler_traces_and_times(tmp_path):
    model = _TSquare().eval()
    x = torch.randn(4, 16)
    with TPR.trace(str(tmp_path / "trace")) as prof:
        model.fc(x)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert any("linear" in e.key or "addmm" in e.key
               for e in prof.key_averages())
    assert TPR.benchmark_fn(model.fc, x, iters=3, warmup=1) > 0
    assert TPR.Timer().elapsed() >= 0
    info = TPR.device_info()
    assert info["platform"] == ("gpu" if torch.cuda.is_available()
                                else "cpu")
