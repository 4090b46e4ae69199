"""The rest of the port's training path against the JAX package on the
CPU: ``train.recalibrate_batch_stats``, the Trainer's ``remat`` and
``progress`` options, and ``data.transforms``.

Tolerances: the recalibrated statistics within 1e-4 of their largest
value (f32 means and variances of activations that 22 convolutions
computed in other summation orders; the deepest variances read 1.0e-5);
remat bitwise (the same operations recomputed on the same
inputs); the host transforms bitwise (the same numpy and cv2 calls, the
same seeded draws); ``batch_preprocess`` within 1e-5 (f32 resize
weights)."""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlxcv_tpu import nn as jnn
from tlxcv_tpu.core import split
from tlxcv_tpu.data import transforms as jtr
from tlxcv_tpu.models.classification.mobilenetv1 import \
    mobilenet_v1 as j_mobilenet_v1
from tlxcv_tpu.train.bn_recal import \
    recalibrate_batch_stats as j_recalibrate
from tlxcv_tpu_torch import nn
from tlxcv_tpu_torch.data import DataLoader
from tlxcv_tpu_torch.data import transforms as ttr
from tlxcv_tpu_torch.models.classification import mobilenet_v1
from tlxcv_tpu_torch.train import (Trainer, optimizers,
                                   recalibrate_batch_stats)
from tlxcv_tpu_torch.utils import load_jax_params


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: these micro models' small ops gain nothing
    from more, and several test processes share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------- BatchNorm recal
def test_recalibrate_batch_stats_matches_jax():
    rng = np.random.default_rng(0)
    jm = j_mobilenet_v1(num_classes=10, scale=0.25)
    for _, mod in jm.modules():  # running statistics far from the data's
        if isinstance(mod, jnn.BatchNorm):
            c = mod.running_mean.value.shape[0]
            mod.running_mean.value = jnp.asarray(
                rng.normal(scale=3.0, size=(c,)), jnp.float32)
    tm = mobilenet_v1(num_classes=10, scale=0.25, device="cpu")
    params, state = split(jm)
    load_jax_params(tm, {k: np.asarray(v) for k, v in
                         {**params, **state}.items()}, strict=True)
    batches = [rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
               for _ in range(3)]
    want = j_recalibrate(jm, params, state,
                         [jnp.asarray(b) for b in batches])
    tm.eval()
    got = recalibrate_batch_stats(tm, [torch.from_numpy(b)
                                       for b in batches])
    assert not tm.training  # the mode is restored
    assert all(m.momentum == 0.9 for m in tm.modules()
               if isinstance(m, nn.BatchNorm))
    stat_keys = [k for k in want if k.endswith(("running_mean",
                                                 "running_var"))]
    assert sorted(got) == sorted(k.replace("/", ".") for k in stat_keys)
    moved = 0
    for k in stat_keys:
        w = np.asarray(want[k])
        g = got[k.replace("/", ".")].numpy()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)
        moved += not np.allclose(w, np.asarray(state[k]))
    assert moved == len(stat_keys)  # every statistic was re-estimated


def test_recalibrate_batch_stats_with_no_batches_changes_nothing():
    tm = mobilenet_v1(num_classes=10, scale=0.25, device="cpu")
    before = {k: b.clone() for k, b in tm.named_buffers()}
    assert recalibrate_batch_stats(tm, []) == {}
    for k, b in tm.named_buffers():
        assert torch.equal(b, before[k]), k


# ----------------------------------------------------------------- remat
class _Net(torch.nn.Module):
    """Linear, train-mode BatchNorm, a Dropout on its own generator, a
    Dropout on torch's global one: every source of step-to-step state a
    recompute could get wrong."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.fc1 = nn.Linear(8, 32, device="cpu", generator=g)
        self.bn = nn.BatchNorm(32, device="cpu")
        self.drop1 = nn.Dropout(0.3,
                                generator=torch.Generator().manual_seed(1))
        self.fc2 = nn.Linear(32, 4, device="cpu", generator=g)
        self.drop2 = nn.Dropout(0.2)
        self.calls = 0

    def forward(self, x):
        self.calls += 1
        h = self.drop1(torch.relu(self.bn(self.fc1(x))))
        return self.drop2(self.fc2(h))

    def loss_fn(self, out, y):
        return ((out - y) ** 2).mean()


def _steps(remat, n=3, contexts=None):
    net = _Net()
    trainer = Trainer(net, optimizer=optimizers.Adam(1e-2), remat=remat,
                      device="cpu", seed=0)
    if contexts is not None:
        trainer._remat_contexts = contexts
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(16, 4)).astype(np.float32))
    losses = [trainer._train_step(x, y)[0] for _ in range(n)]
    return trainer, net, losses


def test_remat_gradients_equal_no_remat_bitwise():
    base, net0, l0 = _steps(False)
    remat, net1, l1 = _steps(True)
    assert net1.calls == 2 * net0.calls  # the forward was recomputed
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    for k, p in base.params.items():
        assert torch.equal(p, remat.params[k]), k
    for (k, b0), b1 in zip(net0.named_buffers(), net1.buffers()):
        assert torch.equal(b0, b1), k  # BatchNorm counted each batch once


def test_remat_without_the_generator_replay_would_differ():
    """The trap the replay closes: the checkpoint restores only torch's
    global generators, so a recompute that starts the layers' own where
    the forward left them draws other dropout masks."""
    import contextlib

    base, _, _ = _steps(False)
    plain, _, _ = _steps(True, contexts=lambda: (contextlib.nullcontext(),
                                                 contextlib.nullcontext()))
    assert any(not torch.equal(p, plain.params[k])
               for k, p in base.params.items())


# -------------------------------------------------------------- progress
def test_progress_bars_train(capsys):
    net = _Net()
    trainer = Trainer(net, optimizer=optimizers.Adam(1e-2), device="cpu")
    rng = np.random.default_rng(0)
    data = [(rng.normal(size=8).astype(np.float32),
             rng.normal(size=4).astype(np.float32)) for _ in range(8)]
    trainer.train(2, DataLoader(data, batch_size=4), progress=True)
    assert trainer.step == 4


def test_progress_without_rich_names_the_option(monkeypatch):
    monkeypatch.setitem(sys.modules, "rich.progress", None)
    trainer = Trainer(_Net(), device="cpu")
    with pytest.raises(ImportError, match="progress=True"):
        trainer.train(1, [], progress=True)


# ------------------------------------------------------------ transforms
def _image(rng, h=37, w=53):
    return rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("interp", ["bilinear", "nearest"])
def test_compose_resize_normalize_to_tensor_match_jax(rng, interp):
    img = _image(rng)
    mean, std = (120.0, 110.0, 100.0), (58.0, 57.0, 56.0)
    for fmt in ("HWC", "CHW"):
        want = jtr.Compose([jtr.Resize((24, 30), interp),
                            jtr.Normalize(mean, std),
                            jtr.ToTensor(fmt)])(img)
        got = ttr.Compose([ttr.Resize((24, 30), interp),
                           ttr.Normalize(mean, std), ttr.ToTensor(fmt)])(img)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_resize_numpy_route_matches_jax(rng, monkeypatch):
    """Where cv2 is absent both take the reference's numpy nearest."""
    monkeypatch.setattr(jtr, "cv2", None)
    monkeypatch.setattr(ttr, "cv2", None)
    img = _image(rng)
    for size in ((24, 30), (50, 80), 16):
        np.testing.assert_array_equal(ttr.Resize(size)(img),
                                      jtr.Resize(size)(img))


def test_random_flip_and_crop_match_jax(rng):
    imgs = [_image(rng) for _ in range(6)]
    jf, tf = jtr.RandomFlipHorizontal(0.5, seed=3), \
        ttr.RandomFlipHorizontal(0.5, seed=3)
    jc, tc = jtr.RandomCrop(20, pad=4, seed=7), ttr.RandomCrop(20, pad=4,
                                                                seed=7)
    flips = 0
    for img in imgs:
        a, b = tf(img), jf(img)
        np.testing.assert_array_equal(a, b)
        flips += not np.array_equal(a, img)
        np.testing.assert_array_equal(tc(img), jc(img))
    assert 0 < flips < len(imgs)


@pytest.mark.parametrize("size", [None, (20, 28)])
def test_batch_preprocess_matches_jax(rng, size):
    x = rng.integers(0, 256, size=(3, 16, 24, 3), dtype=np.uint8)
    mean, std = (120.0, 110.0, 100.0), (58.0, 57.0, 56.0)
    want = np.asarray(jtr.batch_preprocess(jnp.asarray(x), mean, std,
                                           size=size))
    got = ttr.batch_preprocess(torch.from_numpy(x), mean, std, size=size)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # training: each image as it was or flipped, drawn from the generator
    flipped = ttr.batch_preprocess(torch.from_numpy(x), mean, std,
                                   generator=torch.Generator().manual_seed(0),
                                   size=size, training=True)
    for i in range(3):
        assert (torch.equal(flipped[i], got[i])
                or torch.equal(flipped[i], got[i].flip(1)))
    again = ttr.batch_preprocess(torch.from_numpy(x), mean, std,
                                 generator=torch.Generator().manual_seed(0),
                                 size=size, training=True)
    assert torch.equal(again, flipped)
