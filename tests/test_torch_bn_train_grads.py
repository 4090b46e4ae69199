"""Train-mode BatchNorm gradients of the port against float64 on the CPU.

The micro YOLOv3 of ``tests/test_torch_yolov3_train.py`` (bridged from the
JAX package, b2 64^2, BatchNorm in train mode, oneDNN off): the port's f32
first-conv weight gradient lies 9e-3 of its largest value from its own
float64 gradient on this seed, the JAX package's 9e-5.  Traced to one
element: the pre-activation at ``neck.yolo_blocks.2.conv_module.layers.4``
(b0, y7, x2, c85) is 2.6e-5 in f32 and -3.3e-6 in float64, so the leaky
ReLU passes its gradient at slope 1 in one and 0.1 in the other, and the
train-mode BatchNorms (8 to 128 samples a channel) spread that one
element's error over whole channels upstream.  It is not an op of the port:
the forward values of both packages lie within 2e-5 of float64, and over
eight more input seeds the JAX package's f32 first-conv gradient lies up
to 4.05e-2 from its float64 one (the port's up to 2.13e-2); which package
flips a sign on which seed is chance.

So the tests pin the mechanism.  With the f32 run's leaky-ReLU signs
replayed in the float64 run, the first-conv gradient lies within 2e-4 of
its largest value (the bound of the JAX comparisons; 6.9e-5 read, the JAX
package's own 7.8e-5) and every gradient within 5e-4 (the stride-32 tip
conv, which feeds the head and its thresholds directly, reads 3.4e-4; the
rest 1.4e-4 or less).  Without the replay the first conv reads 8.9e-3 and
stays within 5e-2, above the JAX package's own worst of 4.05e-2
across the nine seeds."""
import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tlxcv_tpu.core import init as JI, split
from tlxcv_tpu.models.detection import YOLOv3 as JYOLOv3
from tlxcv_tpu_torch.models.detection import YOLOv3
from tlxcv_tpu_torch.utils import load_jax_params

HW = (64, 64)
NC = 6
FIRST_CONV = "backbone.conv0.conv.weight"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: these micro models' small ops gain nothing
    from more, and several test processes share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _targets(rng, b=2, m=10):
    """The ground truths of ``test_torch_yolov3_train._colliding_gts``."""
    boxes = np.zeros((b, m, 4), np.float32)
    for i in range(b):
        c = rng.uniform(0.2, 0.8, size=2)
        s = rng.uniform(0.1, 0.5, size=2)
        boxes[i, 0] = [*c, *s]
        boxes[i, 1] = [*c, *(s * 1.02)]
        boxes[i, 2] = [*(c + 0.01), *(s * 0.98)]
        boxes[i, 3] = [*rng.uniform(0.1, 0.9, 2), 0.3, 0.25]
        boxes[i, 4] = [*boxes[i, 3, :2], 0.32, 0.27]
        boxes[i, 5] = [1.02, 0.5, 0.2, 0.2]
        boxes[i, 6] = [*rng.uniform(0.1, 0.9, 2), 0.05, 0.08]
        boxes[i, 7] = [*boxes[i, 6, :2], 0.055, 0.085]
        boxes[i, 9] = [0.5, 0.5, 0.3, 0.3]
    cls = rng.integers(0, NC, size=(b, m)).astype(np.int32)
    return boxes, cls


@pytest.fixture(scope="module")
def case():
    JI.set_seed(0)
    rng = np.random.default_rng(0)
    jm = JYOLOv3(num_classes=NC)
    tm = YOLOv3(num_classes=NC, device="cpu")
    params, state = split(jm)
    load_jax_params(tm, {k: np.asarray(v) for k, v in
                         {**params, **state}.items()}, strict=True)
    x = rng.normal(size=(2, *HW, 3)).astype(np.float32)
    return tm, x, _targets(rng)


def _grads(tm, x, targets, dtype, leaky=None):
    """Every parameter gradient of the train-mode loss in ``dtype``; the
    leaky ReLUs run through ``leaky`` when given."""
    m = copy.deepcopy(tm).to(dtype).train()
    boxes, cls = targets
    y = {"boxes": torch.from_numpy(boxes).to(dtype),
         "class_labels": torch.from_numpy(cls)}
    with torch.backends.mkldnn.flags(enabled=False):
        if leaky is not None:
            saved, F.leaky_relu = F.leaky_relu, leaky
        try:
            loss = m.loss_fn(m(torch.from_numpy(x).to(dtype)), y)
        finally:
            if leaky is not None:
                F.leaky_relu = saved
        loss.backward()
    return {k: p.grad.double() for k, p in m.named_parameters()}


def _err(g, ref):
    return float((g - ref).abs().max() / ref.abs().max())


@pytest.fixture(scope="module")
def f32_run(case):
    """The f32 gradients, with the sign of every leaky ReLU's input
    recorded in call order."""
    tm, x, targets = case
    signs = []
    plain = F.leaky_relu

    def record(t, negative_slope=0.01):
        signs.append(t.detach() >= 0)
        return plain(t, negative_slope)

    return _grads(tm, x, targets, torch.float32, leaky=record), signs


def test_train_mode_bn_gradients_match_float64_given_the_same_kinks(
        case, f32_run):
    tm, x, targets = case
    g32, signs = f32_run
    calls = iter(range(10 ** 6))

    def replay(t, negative_slope=0.01):
        keep = signs[next(calls)]
        return torch.where(keep, t, t * negative_slope)

    g64 = _grads(tm, x, targets, torch.float64, leaky=replay)
    assert len(signs) == next(calls) > 50  # every leaky ReLU replayed
    assert _err(g32[FIRST_CONV], g64[FIRST_CONV]) <= 2e-4
    worst = max((_err(g32[k], g64[k]), k) for k in g64)
    assert worst[0] <= 5e-4, worst


def test_train_mode_bn_gradients_within_the_stated_float64_bound(
        case, f32_run):
    tm, x, targets = case
    g64 = _grads(tm, x, targets, torch.float64)
    assert _err(f32_run[0][FIRST_CONV], g64[FIRST_CONV]) <= 5e-2
