"""DETR training of the port against the JAX package on the CPU: the
matchers (``ops.hungarian``), ``DetrLoss`` with padded GTs and the aux
loss, the micro detector's loss and parameter gradients, and a Trainer
run whose loss falls.

Tolerances: assignments exact (scipy on both sides; the auction on cost
matrices with distinct entries, where it is deterministic); losses within
1e-5 relative; gradients within 1e-5 of their largest magnitude for the
loss alone (a few hundred terms) and 2e-4 through the micro detector (f32
sums in other orders through 20 convolutions and 5 attention layers, as
``tests/test_torch_detr.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlxcv_tpu import nn as jnn
from tlxcv_tpu.core import pure, split
from tlxcv_tpu.models.detection import detr as jdetr
from tlxcv_tpu.ops import hungarian as jhung
from tlxcv_tpu_torch.data import DataLoader
from tlxcv_tpu_torch.models.detection import detr as tdetr
from tlxcv_tpu_torch.ops import hungarian as thung
from tlxcv_tpu_torch.tasks import ObjectDetection
from tlxcv_tpu_torch.train import Trainer, optimizers
from tlxcv_tpu_torch.utils import load_jax_params
from tlxcv_tpu_torch.utils.bridge import _owner, _to_port_layout

MICRO = dict(num_classes=5, num_queries=8, dim=32, heads=2, enc_layers=1,
             dec_layers=2, ffn=64, dropout=0.0, backbone_depth=18)
HW = (64, 64)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: these micro models' small ops gain nothing
    from more, and several test processes share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _targets(rng, b=2, m=4, n_real=(3, 1), classes=5):
    """Normalized cxcywh boxes, the rows past ``n_real`` padding."""
    boxes = np.zeros((b, m, 4), np.float32)
    mask = np.zeros((b, m), np.float32)
    for i, n in enumerate(n_real):
        boxes[i, :n, :2] = rng.uniform(0.3, 0.7, size=(n, 2))
        boxes[i, :n, 2:] = rng.uniform(0.1, 0.3, size=(n, 2))
        mask[i, :n] = 1
    labels = rng.integers(0, classes, size=(b, m)).astype(np.int32)
    return {"boxes": boxes, "class_labels": labels, "mask": mask}


def _as(t, lib):
    if lib == "jax":
        return {k: jnp.asarray(v) for k, v in t.items()}
    return {k: torch.from_numpy(v) for k, v in t.items()}


@pytest.mark.parametrize("shape", [(6, 6), (3, 8), (2, 4, 9)])
def test_hungarian_callback_matches_jax(rng, shape):
    cost = rng.normal(size=shape).astype(np.float32)
    want = np.asarray(jhung.hungarian_callback(jnp.asarray(cost)))
    got = thung.hungarian_callback(torch.from_numpy(cost))
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_hungarian_callback_marks_rows_past_the_columns():
    """R > C: scipy assigns C rows; the rest come back -1 on both sides."""
    cost = np.arange(12, dtype=np.float32).reshape(4, 3)[::-1].copy()
    want = np.asarray(jhung.hungarian_callback(jnp.asarray(cost)))
    got = thung.hungarian_callback(torch.from_numpy(cost)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == -1).sum() == 1


@pytest.mark.parametrize("r, c, iters", [(3, 8, 200), (5, 5, 200),
                                         (4, 10, 3)])
def test_auction_assign_matches_jax(rng, r, c, iters):
    """Distinct costs; 3 iterations leave rows unassigned (-1) on both
    sides alike."""
    cost = rng.permutation(r * c).reshape(r, c).astype(np.float32) / 7.0
    want = np.asarray(jhung.auction_assign(jnp.asarray(cost),
                                           num_iters=iters))
    got = thung.auction_assign(torch.from_numpy(cost), num_iters=iters)
    np.testing.assert_array_equal(got.numpy(), want)
    batched = thung.auction_assign(torch.from_numpy(np.stack([cost, cost])),
                                   num_iters=iters)
    np.testing.assert_array_equal(batched.numpy(), np.stack([want, want]))


@pytest.mark.parametrize("matcher", ["callback", "auction"])
def test_detr_loss_and_its_gradients_match_jax(rng, matcher):
    b, q, c = 2, 8, 5
    logits = rng.normal(size=(b, q, c + 1)).astype(np.float32)
    boxes = rng.uniform(0.2, 0.8, size=(b, q, 4)).astype(np.float32)
    boxes[..., 2:] *= 0.4
    tgt = _targets(rng)
    jl = jdetr.DetrLoss(c, matcher=matcher)
    tl = tdetr.DetrLoss(c, matcher=matcher)
    want, (wg_l, wg_b) = jax.value_and_grad(
        lambda lg, bx: jl(lg, bx, _as(tgt, "jax")), argnums=(0, 1))(
        jnp.asarray(logits), jnp.asarray(boxes))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (logits, boxes)]
    got = tl(*leaves, _as(tgt, "torch"))
    g_l, g_b = torch.autograd.grad(got, leaves)
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    for g, w in ((g_l, wg_l), (g_b, wg_b)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    # padded GTs take no query: the box gradient reaches exactly one query
    # per real GT
    hit = (g_b.abs().sum(-1) > 0).sum(1).tolist()
    assert hit == [3, 1]


def test_unmatched_rows_get_no_supervision(rng):
    """A GT the matcher leaves at -1 is left out like a padded row (the
    JAX package's ``test_unassigned_matcher_rows_get_no_supervision``)."""
    loss = tdetr.DetrLoss(5, matcher="auction")
    loss._match = lambda cost: torch.tensor([[3, -1]], dtype=torch.int32)
    q = 6
    logits = torch.from_numpy(rng.normal(size=(1, q, 6)).astype(
        np.float32)).requires_grad_()
    pred = torch.from_numpy(rng.uniform(0.2, 0.8, size=(1, q, 4)).astype(
        np.float32)).requires_grad_()
    t = {"boxes": torch.from_numpy(rng.uniform(0.3, 0.6, size=(1, 2, 4))
                                   .astype(np.float32)),
         "class_labels": torch.tensor([[1, 2]]), "mask": torch.ones(1, 2)}
    g_logits, g_pred = torch.autograd.grad(loss(logits, pred, t),
                                           (logits, pred))
    gb = g_pred.abs().sum(-1)[0]
    assert gb[3] > 0 and (gb[torch.arange(q) != 3] == 0).all()
    tgt = np.full((q,), 5)
    tgt[3] = 1
    probs = torch.softmax(logits, -1)[0].detach().numpy()
    cls_w = np.where(tgt == 5, loss.eos_coef, 1.0)
    expect = probs.copy()
    expect[np.arange(q), tgt] -= 1.0
    expect *= cls_w[:, None] / cls_w.sum()
    np.testing.assert_allclose(g_logits[0].numpy(), expect, atol=1e-6)


@pytest.fixture(scope="module")
def micro_pair():
    rng = np.random.default_rng(0)
    jm = jdetr.Detr(**MICRO, matcher="callback")
    for _, mod in jm.modules():
        if isinstance(mod, (jdetr.FrozenBatchNorm, jnn.BatchNorm)):
            c = mod.running_mean.value.shape[0]
            for name, val in (
                    ("weight", rng.uniform(0.5, 1.5, c)),
                    ("bias", rng.normal(scale=0.1, size=c)),
                    ("running_mean", rng.normal(scale=0.2, size=c)),
                    ("running_var", rng.uniform(0.5, 2.0, c))):
                getattr(mod, name).value = jnp.asarray(val, jnp.float32)
    tm = tdetr.Detr(**MICRO, matcher="callback", device="cpu")
    params, state = split(jm)
    load_jax_params(tm, {k: np.asarray(v) for k, v in
                         {**params, **state}.items()}, strict=True)
    x = rng.normal(size=(2, *HW, 3)).astype(np.float32)
    return jm, tm, x, _targets(rng)


@pytest.mark.parametrize("aux_loss", [True, False])
def test_micro_detr_loss_and_parameter_gradients_match_jax(micro_pair,
                                                           aux_loss):
    """Train mode (the downsample branches' BatchNorms on batch
    statistics), dropout 0: the loss over the decoder layers and every
    parameter's gradient.  A gradient below a thousandth of the model's
    largest is held to 2e-7 of that largest: the key projections' biases
    shift each row's scores by a constant, so their gradient is zero in
    exact arithmetic, and both frameworks leave rounding noise there."""
    jm, tm, x, tgt = micro_pair
    jm.aux_loss = tm.aux_loss = aux_loss
    params, state = split(jm)
    lp = pure(jm, lambda m, v, t: m.loss_fn(m(v), t))
    want, wg = jax.jit(jax.value_and_grad(
        lambda p: lp(p, state, jnp.asarray(x), _as(tgt, "jax"),
                     training=True)[0]))(params)
    tm.train()
    tm.zero_grad()
    saved = {k: b.clone() for k, b in tm.named_buffers()}
    with torch.backends.mkldnn.flags(enabled=False):
        got = tm.loss_fn(tm(torch.from_numpy(x)), _as(tgt, "torch"))
        got.backward()
    with torch.no_grad():  # the train forward moved the running statistics
        for k, b in tm.named_buffers():
            b.copy_(saved[k])
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    want_g = {}
    for k, p in tm.named_parameters():
        owner, leaf = _owner(tm, k)
        want_g[k] = _to_port_layout(owner, leaf,
                                    np.asarray(wg[k.replace(".", "/")]))
    top = max(np.abs(w).max() for w in want_g.values())
    for k, p in tm.named_parameters():
        w = want_g[k]
        np.testing.assert_allclose(
            p.grad.numpy(), w, rtol=0,
            atol=2e-4 * max(np.abs(w).max(), 1e-3 * top), err_msg=k)


def test_detr_trains_through_the_trainer(rng):
    """The micro DETR through ``ObjectDetection`` and the Trainer on one
    fixed batch (targets as ``tests/test_detr.py`` builds them): 20 Adam
    steps lower the loss by a third."""
    model = tdetr.Detr(**MICRO, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    task = ObjectDetection(model)
    x = rng.normal(size=(2, *HW, 3)).astype(np.float32)
    y = _targets(rng, n_real=(2, 2))
    trainer = Trainer(task, optimizer=optimizers.Adam(1e-3), device="cpu")
    batch = trainer._put_batch((x, y))
    losses = [float(trainer._train_step(*batch)[0]) for _ in range(20)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 2 / 3, (losses[0], losses[-1])
    # and Trainer.train drives the same path from a loader
    loader = DataLoader(list(zip(x, [{k: v[i] for k, v in y.items()}
                                     for i in range(2)])), batch_size=2)
    trainer.train(n_epoch=1, train_dataset=loader, print_freq=10)
