"""The port's metrics and the Trainer's ``metrics`` option against the JAX
package's on the CPU.

The metrics count in numpy on host copies in both packages, so their
states and results are held equal exactly, on seeded inputs handed to the
port as torch tensors (f32, bf16 and integer) and to the reference as
numpy arrays.  The Trainer's metric is held after three micro steps of a
micro CNN (a conv, a BatchNorm, a Linear; the JAX model's weights bridged
across, 32^2, 10 classes) with ``nan_guard`` and a poisoned batch, whose
outputs neither metric may see, and after ``evaluate``; the epoch line
reports the metric in both.
"""
import jax
import numpy as np
import pytest
import torch

import tlxcv_tpu.nn as jnn
import tlxcv_tpu.train.optimizers as JO
import tlxcv_tpu_torch.train.optimizers as TO
from tlxcv_tpu.core import split
from tlxcv_tpu.core.init import set_seed
from tlxcv_tpu.core.module import Module as JModule
from tlxcv_tpu.tasks import ImageClassification as JIC
from tlxcv_tpu.train import Trainer as JTrainer
from tlxcv_tpu.utils import metrics as JM
from tlxcv_tpu_torch import nn as tnn
from tlxcv_tpu_torch.tasks import ImageClassification
from tlxcv_tpu_torch.train import Trainer
from tlxcv_tpu_torch.utils import load_jax_params
from tlxcv_tpu_torch.utils import metrics as TM


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _state(metric):
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in vars(metric).items()}


def _feed(name, args, updates):
    """Update the port's metric (tensors) and the reference's (numpy) with
    the same batches; their states and results must be equal."""
    port, ref = getattr(TM, name)(*args), getattr(JM, name)(*args)
    for pred, true in updates:
        port.update(pred, true)
        ref.update(TM.as_numpy(pred), TM.as_numpy(true))
        assert _state(port) == _state(ref)
    assert port.result() == ref.result()
    port.reset()
    ref.reset()
    assert _state(port) == _state(ref)
    return port


def _t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def test_accuracy_equals_jax(rng):
    logits = rng.normal(size=(3, 16, 10)).astype(np.float32)
    labels = rng.integers(0, 10, (3, 16))
    _feed("Accuracy", (), [(_t(logits[0]), _t(labels[0])),
                           (_t(logits[1], torch.bfloat16), _t(labels[1])),
                           (_t(logits[2].argmax(-1)), _t(labels[2]))])


def test_topk_accuracy_equals_jax(rng):
    logits = rng.normal(size=(2, 32, 20)).astype(np.float32)
    labels = rng.integers(0, 20, (2, 32))
    for k in (1, 5):
        _feed("TopKAccuracy", (k,), [(_t(logits[0]), _t(labels[0])),
                                     (_t(logits[1]), _t(labels[1, :, None]))])


def test_mean_iou_equals_jax_in_each_label_form(rng):
    k = 4
    logits = rng.normal(size=(2, 8, 8, k)).astype(np.float32)
    labels = rng.integers(0, k, (2, 8, 8))
    onehot = np.eye(k, dtype=np.float32)[labels]
    port = _feed("MeanIoU", (k,), [
        (_t(logits), _t(labels)),                  # logits, integer labels
        (_t(logits), _t(onehot)),                  # both distributions
        (_t(logits.argmax(-1)), _t(onehot)),       # labels, one-hot truth
        (_t(logits.argmax(-1)), _t(labels))])      # labels both sides
    assert port.result() == 0.0  # reset: no class seen


def test_empty_metric_equals_jax():
    _feed("EmptyMetric", (), [(_t(np.ones(3)), _t(np.zeros(3)))])


class _JMicro(JModule):
    """A strided conv with a BatchNorm, a mean pool and a Linear."""

    def __init__(self):
        self.conv = jnn.Conv2d(3, 8, 3, stride=2, padding=1)
        self.bn = jnn.BatchNorm(8)
        self.fc = jnn.Linear(8, 10)

    def __call__(self, x):
        return self.fc(jax.nn.relu(self.bn(self.conv(x))).mean((1, 2)))


class _TMicro(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = tnn.Conv2d(3, 8, 3, stride=2, padding=1, device="cpu")
        self.bn = tnn.BatchNorm(8, device="cpu")
        self.fc = tnn.Linear(8, 10, device="cpu")

    def forward(self, x):
        return self.fc(torch.relu(self.bn(self.conv(x))).mean((1, 2)))


def _trainers():
    set_seed(0)
    jt = JIC(_JMicro())
    tt = ImageClassification(_TMicro())
    params, state = split(jt)
    load_jax_params(tt, {k: np.asarray(v)
                         for k, v in {**params, **state}.items()})
    jtr = JTrainer(network=jt, loss_fn=jt.loss_fn,
                   optimizer=JO.SGD(1e-3), metrics=JM.Accuracy(),
                   nan_guard=True)
    ttr = Trainer(network=tt, loss_fn=tt.loss_fn, optimizer=TO.SGD(1e-3),
                  metrics=TM.Accuracy(), nan_guard=True, device="cpu")
    return jtr, ttr


def _batches():
    rng = np.random.default_rng(4)
    out = []
    for i in range(3):
        x = rng.normal(size=(6, 32, 32, 3)).astype(np.float32)
        if i == 1:
            x[0, 0, 0, 0] = np.nan  # the guard skips this step
        out.append((x, rng.integers(0, 10, 6).astype(np.int32)))
    return out


def test_trainer_metric_equals_jax_after_micro_steps(capsys):
    jtr, ttr = _trainers()
    batches = _batches()
    jtr.train(n_epoch=1, train_dataset=batches)
    with torch.backends.mkldnn.flags(enabled=False):
        ttr.train(n_epoch=1, train_dataset=batches)
    assert jtr.nan_skips == ttr.nan_skips == 1
    assert (ttr.metrics.correct, ttr.metrics.total) == (
        jtr.metrics.correct, jtr.metrics.total)
    assert ttr.metrics.total == 12  # the skipped batch is not counted
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("Epoch")]
    assert len(lines) == 2 and all(" | train acc: " in ln for ln in lines)
    assert lines[0].split("train acc: ")[1] == lines[1].split(
        "train acc: ")[1]
    clean = [batches[0], batches[2]]
    jr = jtr.evaluate(clean)
    with torch.backends.mkldnn.flags(enabled=False):
        tr = ttr.evaluate(clean)
    assert tr["metric"] == jr["metric"]
    assert tr["loss"] == pytest.approx(jr["loss"], rel=2e-4)
    assert (ttr.metrics.correct, ttr.metrics.total) == (
        jtr.metrics.correct, jtr.metrics.total)
