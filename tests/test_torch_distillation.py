"""The port's distillation task against the JAX package on the CPU: the
hard and soft objectives on a student's two heads and on an averaged
head, plain labels, ``predict``, ``teacher_labels``, and a LeViT student
trained through the port's Trainer on teacher targets, step for step
against the JAX Trainer.

Micro size: the LeViT of ``tests/test_torch_cls_attention.py``
(``LEVIT_MICRO``: 64 px, widths 32/64/96, ``distillation=True``, 10
classes) as student and as teacher, b8 (its heads' BatchNorm normalises
one vector an image: over two images its statistics are ill-conditioned
in both packages).  Weights are the JAX model's, copied by the bridge,
its small starts drawn.  Tolerances: the objectives within 1e-6
relative; teacher logits within 2e-4 of their largest magnitude; the
Trainer's losses within 1e-5 relative at the first step and 1e-4 at the
second (after an Adam update of both).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_cls_attention import (LEVIT_MICRO, _few_threads,  # noqa: F401
                                            _pair, bridged_pair)
from tests.test_torch_seg_zoo import _close
from tests.test_torch_trainer import _jax_steps, _port_steps
from tlxcv_tpu.tasks import DistilledClassification as JDistilled
from tlxcv_tpu.tasks import teacher_labels as jax_teacher_labels
from tlxcv_tpu.train import Trainer as JTrainer
from tlxcv_tpu.train import optimizers as JOpt
from tlxcv_tpu_torch.tasks import DistilledClassification, teacher_labels
from tlxcv_tpu_torch.train import Trainer
from tlxcv_tpu_torch.train import optimizers as TOpt


def _levit(seed):
    return bridged_pair(*_pair("LeViT", **LEVIT_MICRO),
                        np.random.default_rng(seed))


def _logits(rng, b=6, c=10):
    return [rng.normal(scale=2.0, size=(b, c)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("hard,alpha,tau", [(True, 0.5, 1.0),
                                            (False, 0.5, 1.0),
                                            (False, 0.3, 3.0)])
@pytest.mark.parametrize("heads", ["two", "averaged", "labels_only"])
def test_objectives_match_jax(rng, hard, alpha, tau, heads):
    y, y_dist, teacher = _logits(rng)
    label = rng.integers(0, 10, size=6).astype(np.int32)
    task = DistilledClassification(torch.nn.Identity(), hard, alpha, tau)
    ref = JDistilled(None, hard, alpha, tau)
    if heads == "two":
        out_t = (torch.from_numpy(y), torch.from_numpy(y_dist))
        out_j = (jnp.asarray(y), jnp.asarray(y_dist))
    else:
        out_t, out_j = torch.from_numpy(y), jnp.asarray(y)
    if heads == "labels_only":
        target_t, target_j = torch.from_numpy(label), jnp.asarray(label)
    else:
        target_t = {"label": torch.from_numpy(label),
                    "teacher": torch.from_numpy(teacher)}
        target_j = {"label": jnp.asarray(label),
                    "teacher": jnp.asarray(teacher)}
    got = task.loss_fn(out_t, target_t).item()
    want = float(ref.loss_fn(out_j, target_j))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_predict_matches_jax(rng):
    """Two heads are averaged before the argmax; one is taken as it is."""
    y, y_dist, _ = _logits(rng)

    class Heads(torch.nn.Module):
        def forward(self, x):
            return x[0], x[1]

    both = DistilledClassification(Heads()).predict(
        (torch.from_numpy(y), torch.from_numpy(y_dist)))
    np.testing.assert_array_equal(both.numpy(), np.asarray(
        jnp.argmax((jnp.asarray(y) + jnp.asarray(y_dist)) / 2, -1)))
    one = DistilledClassification(torch.nn.Identity()).predict(
        torch.from_numpy(y))
    np.testing.assert_array_equal(one.numpy(), y.argmax(-1))


@pytest.fixture(scope="module")
def teacher():
    return _levit(31)


def test_teacher_labels_match_jax(rng, teacher):
    """The teacher's eval-mode logits (its two heads averaged) beside the
    batch's images and labels, which pass through unchanged; nothing of
    the teacher needs a gradient."""
    jm, tm = teacher
    batches = [(rng.normal(size=(4, 64, 64, 3)).astype(np.float32),
                rng.integers(0, 10, size=4).astype(np.int32))
               for _ in range(2)]
    got = list(teacher_labels(tm.train(), batches))
    want = list(jax_teacher_labels(jm, batches))
    assert len(got) == len(want) == 2 and not tm.training
    for (gx, gy), (wx, wy), (x, label) in zip(got, want, batches):
        assert gx is x and gy["label"] is label
        assert not gy["teacher"].requires_grad
        _close(gy["teacher"], wy["teacher"])
    params = {k: v.clone() for k, v in tm.named_parameters()}
    again = next(teacher_labels(tm, batches[:1], params=params))
    torch.testing.assert_close(again[1]["teacher"], got[0][1]["teacher"])


@pytest.mark.parametrize("hard", [True, False])
def test_student_trains_through_the_trainer_as_jax(rng, teacher, hard):
    """Two Adam steps of a LeViT student (``distillation=True``: two heads
    in train mode) on ``teacher_labels`` targets, both Trainers in f32."""
    jt_model, tt_model = teacher
    js, ts = _levit(32)
    batches = [(rng.normal(size=(8, 64, 64, 3)).astype(np.float32),
                rng.integers(0, 10, size=8).astype(np.int32))
               for _ in range(2)]
    targets = [(x, {"label": t["label"], "teacher": t["teacher"].numpy()})
               for x, t in teacher_labels(tt_model, batches)]
    jtr = JTrainer(JDistilled(js, hard=hard, tau=2.0),
                   optimizer=JOpt.Adam(1e-3))
    ttr = Trainer(DistilledClassification(ts, hard=hard, tau=2.0),
                  optimizer=TOpt.Adam(1e-3), device="cpu")
    _, _, _, want = _jax_steps(jtr, targets)
    got = _port_steps(ttr, targets)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4)
    assert ttr._put_batch(targets[0])[1]["teacher"].dtype == torch.float32
