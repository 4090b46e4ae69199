"""The port's optimizers against optax through the JAX package's factories,
three steps on fixed seeded gradients (the second ten times the first, so
that ``grad_clip`` triggers), on the CPU.  The port takes optax's
operations in optax's order, so the parameters agree to a rounding step
(1e-7 absolute for values of order 1: ``pow``, ``cos`` and ``rsqrt`` may
round differently in XLA and torch)."""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tlxcv_tpu.train.optimizers as JO
import tlxcv_tpu_torch.train.optimizers as TO

_ATOL = 1e-7


def _params():
    rng = np.random.default_rng(0)
    return {"conv.weight": rng.normal(size=(4, 3)).astype(np.float32),
            "conv.bias": rng.normal(size=(3,)).astype(np.float32)}


def _grads(params):
    rng = np.random.default_rng(1)
    return [{k: (rng.normal(size=v.shape) * s).astype(np.float32)
             for k, v in params.items()} for s in (1.0, 10.0, 0.1)]


_CASES = {
    "adam": (lambda J: J.Adam(1e-2)),
    "adamw_masked": (lambda J: J.AdamW(
        1e-2, weight_decay=0.1,
        weight_decay_mask=(J.no_decay_mask(_params()) if J is JO
                           else J.no_decay_mask))),
    "adam_clip": (lambda J: J.Adam(1e-2, grad_clip=1.0)),
    "sgd": (lambda J: J.SGD(0.1)),
    "sgd_nesterov_decay": (lambda J: J.SGD(0.1, momentum=0.9, nesterov=True,
                                           weight_decay=0.01)),
    "momentum_clip": (lambda J: J.Momentum(0.1, grad_clip=1.0)),
    "rmsprop": (lambda J: J.RMSprop(1e-2)),
    "adam_cosine": (lambda J: J.Adam(J.cosine_schedule(1e-2, 3, 0.1))),
    "sgd_warmup_cosine": (lambda J: J.SGD(J.warmup_cosine(0.1, 1, 3))),
    "sgd_epoch_decay": (lambda J: J.SGD(J.EpochDecay(0.1, 1, (1, 2)))),
}


def _run(name):
    params = _params()
    jtx = _CASES[name](JO)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = jtx.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = _CASES[name](TO)(tp.items())
    for g in _grads(params):
        u, state = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                              state, jp)
        jp = optax.apply_updates(jp, u)
        for k, t in tp.items():
            t.grad = torch.from_numpy(g[k])
        opt.step()
    return jp, state, tp, opt


@pytest.mark.parametrize("name", sorted(_CASES))
def test_three_steps_match_optax(name):
    jp, _, tp, opt = _run(name)
    for k, t in tp.items():
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=_ATOL)
    assert float(opt.count) == 3.0


def test_adam_moments_match_optax():
    """Adam's first and second moments (the state a nan_guard skip must
    restore) equal optax's."""
    _, state, tp, opt = _run("adam")
    inner = state[0]
    for k, t in tp.items():
        st = opt.state[t]
        np.testing.assert_allclose(st["mu"].numpy(), np.asarray(inner.mu[k]),
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(st["nu"].numpy(), np.asarray(inner.nu[k]),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("make", [
    lambda J: J.cosine_schedule(0.1, 7, 0.05),
    lambda J: J.warmup_cosine(0.1, 3, 10, 0.1),
    lambda J: J.EpochDecay(0.1, 2, (1, 3), rate=0.5)])
def test_schedules_match_optax(make):
    """The schedule of the applied-update count, evaluated on a float32
    tensor as the optimizers do, against optax's at counts 0..11."""
    counts = np.arange(12)
    want = np.asarray([make(JO)(jnp.asarray(c, jnp.int32)) for c in counts])
    got = make(TO)(torch.tensor(counts, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


def test_clip_by_global_norm_follows_optax_rule():
    """g · max / ‖g‖ past the limit (not clip_grad_norm_'s max / (‖g‖ +
    1e-6)), g itself under it."""
    grads = [torch.full((3,), 3.0), torch.full((4,), 4.0)]
    norm = float(np.sqrt(27 + 64))
    for limit in (1.0, 100.0):
        got = TO.clip_by_global_norm(grads, limit)
        want = optax.clip_by_global_norm(limit).update(
            [jnp.asarray(g.numpy()) for g in grads], None)[0]
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7)
        if limit < norm:
            np.testing.assert_allclose(got[0].numpy(), 3.0 / norm, rtol=1e-6)


def test_decay_mask_is_the_reference_mask_as_groups():
    params = _params()
    jax_mask = JO.no_decay_mask(params)
    assert TO.no_decay_mask({k: torch.from_numpy(v)
                             for k, v in params.items()}) == jax_mask
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = TO.AdamW(1e-2, weight_decay=0.1,
                   weight_decay_mask=TO.no_decay_mask)(tp.items())
    decays = {id(p): g["weight_decay"] for g in opt.param_groups
              for p in g["params"]}
    assert decays == {id(tp["conv.weight"]): 0.1, id(tp["conv.bias"]): 0.0}
    with pytest.raises(ValueError):
        TO.Adam()([])


def test_parameter_without_grad_counts_as_zero():
    """optax updates every leaf: a parameter that received no gradient
    moves by Adam's momentum as for a zero gradient."""
    tp = {"a": torch.ones(2, requires_grad=True),
          "b": torch.ones(2, requires_grad=True)}
    opt = TO.Adam(0.1)(tp.items())
    jtx = optax.adam(0.1)
    jp = {"a": jnp.ones(2), "b": jnp.ones(2)}
    st = jtx.init(jp)
    for ga in (1.0, 0.0):
        tp["a"].grad = torch.full((2,), ga) if ga else None
        opt.step()
        u, st = jtx.update({"a": jnp.full((2,), ga), "b": jnp.zeros(2)}, st,
                           jp)
        jp = optax.apply_updates(jp, u)
    for k in tp:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=_ATOL)
