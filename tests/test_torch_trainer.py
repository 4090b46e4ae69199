"""One ``Trainer`` step of the port against the JAX package's ``Trainer`` on
the CPU, f32: the micro Mask R-CNN of tests/test_mask_rcnn.py (resnet18
backbone, 128^2, 4 classes, 16 proposals) and resnet18, the JAX models'
``split()`` carried across by ``load_jax_params``, seeded numpy batches fed
to both.  SGD makes the parameter change ``-lr · g``, so the step holds the
gradients; the loss and the BatchNorm statistics after the step are held
too.  Then the options: ``ema_decay``, ``grad_accum=2`` with a schedule,
``nan_guard`` with a poisoned batch, and ``train()`` through the port's
``DataLoader`` on ``ShapesDetection``.

The port's side runs with oneDNN off (``torch.backends.mkldnn.flags``):
on this CPU oneDNN's f32 convolution weight gradients at some stride-2
shapes of these models are up to 8% of max |g| away from float64, while
torch's own kernels agree with float64 to 1e-5 (measured on the micro
Mask R-CNN).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tlxcv_tpu.train.optimizers as JO
import tlxcv_tpu_torch.train.optimizers as TO
from tlxcv_tpu.core import split
from tlxcv_tpu.core.init import set_seed
from tlxcv_tpu.data import ShapesDetection as JShapes
from tlxcv_tpu.models.classification import resnet18 as j_resnet18
from tlxcv_tpu.models.detection import MaskRCNN as JMaskRCNN
from tlxcv_tpu.tasks import ImageClassification as JIC
from tlxcv_tpu.tasks import ObjectDetection as JOD
from tlxcv_tpu.train import Trainer as JTrainer
from tlxcv_tpu_torch.data import DataLoader, ShapesDetection, pad_targets
from tlxcv_tpu_torch.models.classification import resnet18
from tlxcv_tpu_torch.models.detection import MaskRCNN
from tlxcv_tpu_torch.tasks import ImageClassification, ObjectDetection
from tlxcv_tpu_torch.train import Model, Trainer
from tlxcv_tpu_torch.utils import load_jax_params
from tlxcv_tpu_torch.utils.bridge import _owner, _to_port_layout

MICRO = dict(num_classes=4, num_proposals=16, pre_nms_top_k=64,
             detections_per_image=8)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs six workers on one host: two torch threads each keep
    them from oversubscribing its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _mask_rcnn_batch():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 128, 128, 3)).astype(np.float32)
    boxes = np.asarray([[[10, 10, 60, 70], [40, 50, 100, 110], [0, 0, 0, 0]],
                        [[5, 20, 90, 60], [0, 0, 0, 0], [0, 0, 0, 0]]],
                       np.float32)
    masks = np.zeros((2, 3, 128, 128), np.float32)
    masks[0, 0, 10:70, 10:60] = 1
    masks[0, 1, 50:110, 40:100] = 1
    masks[1, 0, 20:60, 5:90] = 1
    return x, {"boxes": boxes,
               "class_labels": np.asarray([[1, 2, 0], [3, 0, 0]], np.int32),
               "mask": np.asarray([[1, 1, 0], [1, 0, 0]], np.float32),
               "masks": masks}


def _classifier_batch(seed=0, n=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 64, 64, 3)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


def _pair(kind):
    set_seed(0)
    if kind == "mask_rcnn":
        jt = JOD(JMaskRCNN(**MICRO, backbone=j_resnet18(num_classes=0,
                                                        with_pool=False)))
        tt = ObjectDetection(MaskRCNN(**MICRO, device="cpu",
                                      backbone=resnet18(num_classes=0,
                                                        with_pool=False,
                                                        device="cpu")))
    else:
        jt = JIC(j_resnet18(num_classes=10))
        tt = ImageClassification(resnet18(num_classes=10, device="cpu"))
    params, state = split(jt)
    load_jax_params(tt, {k: np.asarray(v)
                         for k, v in {**params, **state}.items()})
    return jt, tt


def _jax_steps(trainer, batches):
    p, s, o, e = (trainer.params, trainer.state, trainer.opt_state,
                  trainer.ema_params)
    losses = []
    for x, y in batches:
        p, s, o, e, loss, _ = trainer._train_step(
            p, s, o, e, jax.tree.map(jnp.asarray, x),
            jax.tree.map(jnp.asarray, y), trainer._next_key())
        losses.append(float(loss))
    trainer.opt_state = o      # the step donates the state it was given
    return p, s, e, losses


def _port_steps(trainer, batches):
    losses = []
    with torch.backends.mkldnn.flags(enabled=False):
        for x, y in batches:
            loss, _ = trainer._train_step(*trainer._put_batch((x, y)))
            losses.append(float(loss))
    return losses


def _in_port_layout(model, flat):
    return {k.replace("/", "."): _to_port_layout(
        *_owner(model, k.replace("/", ".")), np.asarray(v))
        for k, v in flat.items()}


def _build(kind):
    if kind == "mask_rcnn":
        return ObjectDetection(MaskRCNN(**MICRO, device="cpu",
                                        backbone=resnet18(num_classes=0,
                                                          with_pool=False,
                                                          device="cpu")))
    return ImageClassification(resnet18(num_classes=10, device="cpu"))


@functools.lru_cache(maxsize=None)
def _grads(kind, dtype):
    """The port's gradient of the loss on the test batch, in ``dtype``."""
    _, tt = _pair(kind)
    model = _build(kind)
    model.load_state_dict(tt.state_dict())
    model.to(dtype).train()
    x, y = _mask_rcnn_batch() if kind == "mask_rcnn" else _classifier_batch()
    y = ({k: torch.from_numpy(v) for k, v in y.items()}
         if isinstance(y, dict) else torch.from_numpy(y))
    with torch.backends.mkldnn.flags(enabled=False):
        model.loss_fn(model(torch.from_numpy(x).to(dtype)), y).backward()
    return {k: p.grad.double().numpy() for k, p in model.named_parameters()}


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


# Each parameter's gradient against the JAX package's, f32 in both, as a
# share of its largest element.  resnet18: the same sums in other orders,
# 1e-3 (1.4e-4 seen).  The micro Mask R-CNN's f32 gradients are
# ill-conditioned in both frameworks: BatchNorm over a few samples per
# channel (layer4 sees 4x4 pixels of 2 images), a mask head of six layers
# at random init, and box and mask losses that reach the backbone through
# RoIAlign's sampling coordinates, whose gradient jumps where a sample
# crosses a pixel (a last-bit change of a proposal moves it).  Measured
# against float64 on this batch: the port's f32 gradients up to 3.3% of
# max |g| (layer4), JAX's up to 1.6% (layer1) with the proposals held
# fixed and up to 10% on another batch; port against JAX 3.3%.  Bound 5e-2:
# a missing or wrong gradient path (a kernel without a backward, a wrong
# transposed resize) is off by the whole gradient.
_STEP_TOL = {"mask_rcnn": 5e-2, "resnet18": 1e-3}
# resnet18 over two updates: the second gradient is taken at parameters
# that already differ by the first one's f32 noise, and BatchNorm over 16
# samples per channel (layer4 sees 2x2 pixels of 4 images) amplifies it:
# up to 1.27% of a parameter's largest move, with the torch thread count
# changing the summation order (seen with 1 and 8 threads)
_TWO_STEP_TOL = 3e-2


@pytest.mark.parametrize("kind", ["mask_rcnn", "resnet18"])
def test_one_sgd_step_matches_jax(kind):
    """Loss within 1e-5 relative; every parameter's change, -lr · g,
    within the bound above of the JAX change's largest element (so every
    parameter the JAX step moves, the port's moves); the BatchNorm
    statistics within 1e-5."""
    lr = 0.1
    jt, tt = _pair(kind)
    batch = _mask_rcnn_batch() if kind == "mask_rcnn" else _classifier_batch()
    jtr = JTrainer(jt, optimizer=JO.SGD(lr))
    ttr = Trainer(tt, optimizer=TO.SGD(lr), device="cpu")
    p0 = _in_port_layout(tt, jtr.params)
    p1, s1, _, (jloss,) = _jax_steps(jtr, [batch])
    (tloss,) = _port_steps(ttr, [batch])
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    want = _in_port_layout(tt, p1)
    for k, p in ttr.params.items():
        d_want = want[k] - p0[k]
        assert np.abs(d_want).max() > 0, k
        assert _rel(p.detach().numpy() - p0[k], d_want) <= _STEP_TOL[kind], k
    for k, b in tt.named_buffers():
        np.testing.assert_allclose(b.numpy(), np.asarray(
            s1[k.replace(".", "/")]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["mask_rcnn", "resnet18"])
def test_step_gradients_match_float64(kind):
    """The port's f32 gradients against its float64 ones on the same batch
    (a check that does not lean on XLA:CPU's own f32 precision), within
    the bounds above."""
    g32, g64 = _grads(kind, torch.float32), _grads(kind, torch.float64)
    for k, g in g64.items():
        assert _rel(g32[k], g) <= _STEP_TOL[kind], k


def _delta(after, before):
    return {k: np.asarray(after[k]) - before[k] for k in before}


def _moves_agree(got, want, tol):
    """Parameter moves within ``tol`` of the largest, plus two f32 steps
    at |p| ~ 1 (2.4e-7) for the rounding of the parameters themselves."""
    return all(np.abs(got[k] - want[k]).max()
               <= tol * np.abs(want[k]).max() + 2.4e-7 for k in want)


def test_ema_matches_jax():
    """Two SGD steps with ``ema_decay=0.9`` on resnet18: the EMA's move
    from the initial parameters as the JAX Trainer's, within the two-step
    bound; the first loss within 1e-5, the second (after a step whose
    gradients differ by that bound) within 1e-4; ``eval_params`` is the
    EMA."""
    jt, tt = _pair("resnet18")
    batches = [_classifier_batch(1), _classifier_batch(2)]
    jtr = JTrainer(jt, optimizer=JO.SGD(0.01), ema_decay=0.9)
    ttr = Trainer(tt, optimizer=TO.SGD(0.01), ema_decay=0.9, device="cpu")
    p0 = _in_port_layout(tt, jtr.params)
    _, _, ema, jl = _jax_steps(jtr, batches)
    tl = _port_steps(ttr, batches)
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-5)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    want = _delta(_in_port_layout(tt, ema), p0)
    got = _delta({k: e.numpy() for k, e in ttr.ema_params.items()}, p0)
    assert _moves_agree(got, want, _TWO_STEP_TOL)
    assert ttr.eval_params is ttr.ema_params


def test_adam_step_matches_jax():
    """One Adam step on resnet18.  The moments are linear in g and held as
    the gradients are (mu = 0.1 g, nu = 1e-3 g^2).  The update is
    lr · g / (|g| + eps), which flips with the sign of a gradient near
    zero, so the parameters are held where |g| > 1e-2 of the parameter's
    max |g| (there the update is lr · sign(g) to 1e-6, and p + update is
    rounded to f32: two steps of 1.2e-7 at |p| ~ 1)."""
    lr = 1e-3
    jt, tt = _pair("resnet18")
    jtr = JTrainer(jt, optimizer=JO.Adam(lr))
    ttr = Trainer(tt, optimizer=TO.Adam(lr), device="cpu")
    p0 = _in_port_layout(tt, jtr.params)
    p1, _, _, jl = _jax_steps(jtr, [_classifier_batch()])
    tl = _port_steps(ttr, [_classifier_batch()])
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    want = _in_port_layout(tt, p1)
    jmu = _in_port_layout(tt, jtr.opt_state[0].mu)
    g64 = _grads("resnet18", torch.float64)
    for k, p in ttr.params.items():
        st = ttr.optimizer.state[p]
        assert _rel(st["mu"].numpy(), jmu[k]) <= 5e-3, k
        big = np.abs(g64[k]) > 1e-2 * np.abs(g64[k]).max()
        np.testing.assert_allclose(p.detach().numpy()[big], want[k][big],
                                   rtol=0, atol=1e-6 * lr + 2.4e-7)


def test_grad_accum_matches_jax():
    """``grad_accum=2`` (optax.MultiSteps, its running mean) with a cosine
    schedule over the updates: four microbatches make two updates, the
    schedule advancing once per update.  The parameters' moves within the
    two-step bound, the losses within 1e-4 (after the first update)."""
    jt, tt = _pair("resnet18")
    batches = [_classifier_batch(s) for s in (3, 4, 5, 6)]
    jtr = JTrainer(jt, optimizer=JO.SGD(JO.cosine_schedule(0.01, 2)),
                   grad_accum=2)
    ttr = Trainer(tt, optimizer=TO.SGD(TO.cosine_schedule(0.01, 2)),
                  grad_accum=2, device="cpu")
    p0 = _in_port_layout(tt, jtr.params)
    p, _, _, jl = _jax_steps(jtr, batches)
    tl = _port_steps(ttr, batches)
    np.testing.assert_allclose(tl[:2], jl[:2], rtol=1e-5)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    want = _delta(_in_port_layout(tt, p), p0)
    got = _delta({k: q.detach().numpy() for k, q in ttr.params.items()}, p0)
    assert _moves_agree(got, want, _TWO_STEP_TOL)
    assert float(ttr.optimizer.count) == 2.0 and int(ttr._mini) == 0


def test_nan_guard_skips_a_poisoned_batch():
    """A NaN in the batch: the step changes no parameter, optimizer state,
    EMA or BatchNorm statistic, and ``train()`` counts the skip; the clean
    batches around it train."""
    _, tt = _pair("resnet18")
    ttr = Trainer(tt, optimizer=TO.Adam(1e-3), nan_guard=True, ema_decay=0.5,
                  device="cpu")
    x, y = _classifier_batch(7)
    bad = x.copy()
    bad[0, 0, 0, 0] = np.nan
    with torch.backends.mkldnn.flags(enabled=False):
        ttr._train_step(*ttr._put_batch((x, y)))
    before = ({k: p.detach().clone() for k, p in ttr.params.items()},
              {k: b.clone() for k, b in tt.named_buffers()},
              {k: e.clone() for k, e in ttr.ema_params.items()},
              float(ttr.optimizer.count))
    ttr.train(1, [(bad, y)], print_freq=1)
    assert ttr.nan_skips == 1
    for k, p in ttr.params.items():
        assert torch.equal(p.detach(), before[0][k]), k
    for k, b in tt.named_buffers():
        assert torch.equal(b, before[1][k]), k
    for k, e in ttr.ema_params.items():
        assert torch.equal(e, before[2][k]), k
    assert float(ttr.optimizer.count) == before[3]
    ttr.train(1, [(x, y), (bad, y), (x, y)])
    assert ttr.nan_skips == 2 and float(ttr.optimizer.count) == 3.0
    assert all(bool(torch.isfinite(p).all()) for p in ttr.params.values())


def test_train_through_the_loader_on_shapes(tmp_path):
    """``train()`` over the port's ``DataLoader`` of ``ShapesDetection``
    with the ground truth padded to 8 slots; the samples are the JAX
    package's bitwise; the trained weights land in the network; the train
    state round-trips through ``save_checkpoint`` into a fresh trainer
    (the resume itself: tests/test_torch_checkpoint.py); the options that
    are not ported say so; ``progress=True`` trains behind rich's bars."""
    ds = ShapesDetection(num=4, size=128, max_objects=6, return_masks=True)
    jds = JShapes(num=4, size=128, max_objects=6, return_masks=True)
    img, tgt = ds[3]
    jimg, jtgt = jds[3]
    np.testing.assert_array_equal(img, jimg)
    for k in jtgt:
        np.testing.assert_array_equal(tgt[k], jtgt[k])
    loader = DataLoader(ds, batch_size=2, collate_fn=pad_targets(8))
    x, y = next(iter(loader))
    assert x.shape == (2, 128, 128, 3) and y["masks"].shape == (2, 8, 128,
                                                                 128)
    assert y["mask"].sum(1).tolist() == [len(ds[i][1]["boxes"])
                                         for i in range(2)]
    _, tt = _pair("mask_rcnn")
    trainer = Model(network=tt, loss_fn=tt.loss_fn,
                    optimizer=TO.Adam(1e-4), device="cpu")
    with torch.backends.mkldnn.flags(enabled=False):
        trainer.train(n_epoch=1, train_dataset=loader, max_steps_per_epoch=1)
    assert trainer.step == 1
    for k, p in tt.named_parameters():
        assert torch.equal(p, trainer.params[k].detach()), k
    for kw in ({"mesh": object()}, {"param_sharding": "fsdp"}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Trainer(tt, device="cpu", **kw)
    path = str(tmp_path / "state.npz")
    trainer.save_checkpoint(path)
    fresh = Model(network=tt, loss_fn=tt.loss_fn, optimizer=TO.Adam(1e-4),
                  device="cpu").restore_checkpoint(path)
    assert fresh.step == 1
    for k, p in trainer.params.items():
        assert torch.equal(fresh.params[k], p), k
    assert torch.equal(fresh.optimizer.count, trainer.optimizer.count)
    with torch.backends.mkldnn.flags(enabled=False):  # rich's bars
        trainer.train(1, loader, max_steps_per_epoch=1, progress=True)
    assert trainer.step == 2


def test_evaluate_predict_and_save_weights_use_the_eval_params(tmp_path):
    """After training with an EMA, ``evaluate`` and ``predict`` run the
    network in eval mode on the EMA parameters (as the JAX Trainer's
    ``eval_params``), with no compute-dtype cast, and ``save_weights``
    writes them."""
    _, tt = _pair("resnet18")
    ttr = Trainer(tt, optimizer=TO.SGD(0.05), ema_decay=0.5,
                  compute_dtype=torch.bfloat16, device="cpu")
    x, y = _classifier_batch(8)
    with torch.backends.mkldnn.flags(enabled=False):
        ttr.train(1, [(x, y)] * 2, print_freq=2)
        got = ttr.predict(x)
        result = ttr.evaluate([(x, y)])
        ref = _build("resnet18")
        ref.load_state_dict({**tt.state_dict(), **{
            k: e for k, e in ttr.ema_params.items()}})
        ref.eval()
        with torch.no_grad():
            want = ref(torch.from_numpy(x))
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    np.testing.assert_allclose(result["loss"], float(ref.loss_fn(
        want, torch.from_numpy(y))), rtol=1e-6)
    path = tmp_path / "weights.npz"
    ttr.save_weights(str(path))
    saved = np.load(path)
    for k, e in ttr.ema_params.items():
        assert np.array_equal(saved[k], e.numpy()), k
    assert not torch.equal(ttr.ema_params["backbone.fc.weight"],
                           ttr.params["backbone.fc.weight"])
