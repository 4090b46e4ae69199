"""Checkpoints of the port (``utils.checkpoint``, ``Trainer.save_checkpoint``
/ ``restore_checkpoint``) on the CPU: the weights npz round trip with bf16
tensors, an npz written by the JAX package's ``save_weights`` loaded into
the port and giving the JAX forward, the full train-state round trip, and
a run resumed from a checkpoint bitwise equal to the uninterrupted one.

Tolerances: round trips and the resumed run are exact (bitwise); the
JAX-written weights give the JAX forward within 2e-4 of its largest
output (f32 summation order), and a bf16 leaf's values exactly."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlxcv_tpu import nn as jnn
from tlxcv_tpu.core import pure, split
from tlxcv_tpu.core.init import set_seed
from tlxcv_tpu.models.classification import resnet18 as j_resnet18
from tlxcv_tpu.utils import checkpoint as JC
from tlxcv_tpu_torch import nn
from tlxcv_tpu_torch.models.classification import resnet18
from tlxcv_tpu_torch.train import Trainer, optimizers
from tlxcv_tpu_torch.utils.checkpoint import (TrainCheckpoint, load_weights,
                                              save_weights)


class Net(torch.nn.Module):
    """A Linear, a BatchNorm and two Dropouts, one drawing from a
    generator of its own and one from torch's default generator."""

    def __init__(self, seed=0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.fc1 = nn.Linear(8, 16, device="cpu", generator=g)
        self.bn = nn.BatchNorm(16, device="cpu")
        self.drop = nn.Dropout(0.3, generator=torch.Generator()
                               .manual_seed(seed + 5))
        self.drop2 = nn.Dropout(0.2)
        self.fc2 = nn.Linear(16, 3, device="cpu", generator=g)

    def forward(self, x):
        h = torch.relu(self.bn(self.fc1(x)))
        return self.fc2(self.drop2(self.drop(h)))


def _ce(out, y):
    return torch.nn.functional.cross_entropy(out, y)


def _batches(n=8, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(8, 8)).astype(np.float32),
             rng.integers(0, 3, 8)) for _ in range(n)]


def test_weights_round_trip_with_bf16(tmp_path):
    """Every tensor of the state dict comes back bitwise in its dtype, bf16
    through the reference's ``__ml_dtypes__`` manifest (read by name, with
    no ml_dtypes), at exactly the path given."""
    src = Net(0)
    src.fc2.to(torch.bfloat16)
    src.bn.running_mean.normal_()
    path = tmp_path / "w"
    save_weights(src, str(path))
    assert path.exists()
    with np.load(path) as data:
        manifest = json.loads(bytes(data["__ml_dtypes__"].tobytes()))
    assert manifest == {"fc2.weight": "bfloat16", "fc2.bias": "bfloat16"}
    dst = Net(1)
    dst.fc2.to(torch.bfloat16)
    load_weights(dst, str(path))
    for (k, a), (_, b) in zip(src.state_dict().items(),
                              dst.state_dict().items()):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    with pytest.raises(KeyError):  # fits neither layout
        load_weights(torch.nn.Linear(3, 3), str(path))


def test_jax_written_weights_serve_in_the_port(rng, tmp_path):
    """resnet18 saved by the JAX package's ``save_weights`` ("/" keys,
    HWIO convs, (in, out) dense weights, BatchNorm statistics) loads into
    the port's resnet18 through the bridge and gives the JAX forward; a
    bf16 leaf written under the JAX manifest comes back with its values."""
    set_seed(0)
    jm = j_resnet18(num_classes=10)
    for _, mod in jm.modules():
        if isinstance(mod, jnn.BatchNorm):
            c = mod.running_mean.value.shape[0]
            mod.running_mean.value = jnp.asarray(
                rng.normal(scale=0.2, size=(c,)), jnp.float32)
            mod.running_var.value = jnp.asarray(
                rng.uniform(0.5, 2.0, size=(c,)), jnp.float32)
    path = str(tmp_path / "jax_resnet18.npz")
    JC.save_weights(jm, path)
    tm = load_weights(resnet18(num_classes=10, device="cpu"), path).eval()
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(pure(jm)(*split(jm), jnp.asarray(x))[0])
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-4 * np.abs(want).max())

    lin = jnn.Linear(4, 3)
    lin.weight.value = lin.weight.value.astype(jnp.bfloat16)
    JC.save_weights(lin, str(tmp_path / "lin.npz"))
    tl = load_weights(nn.Linear(4, 3, device="cpu"),
                      str(tmp_path / "lin.npz"))
    np.testing.assert_array_equal(
        tl.weight.detach().numpy().T,
        np.asarray(lin.weight.value.astype(jnp.float32)))
    sq = jnn.Linear(3, 3)  # fits both layouts as it is: say which
    JC.save_weights(sq, str(tmp_path / "sq.npz"))
    ts = load_weights(nn.Linear(3, 3, device="cpu"),
                      str(tmp_path / "sq.npz"), layout="jax")
    np.testing.assert_array_equal(ts.weight.detach().numpy().T,
                                  np.asarray(sq.weight.value))


def test_train_checkpoint_round_trip(tmp_path):
    """Params, buffers, optimizer state (the shared count included), step,
    EMA and the generators' states come back bitwise into a fresh
    trainer, each in the live tensor's device and dtype, the shared count
    still shared."""
    data = _batches(3)
    t = Trainer(Net(0), loss_fn=_ce, optimizer=optimizers.Adam(1e-2),
                ema_decay=0.9, device="cpu", seed=3)
    t.train(1, data, print_freq=2)
    t.nan_skips = 2
    path = str(tmp_path / "state")
    t.save_checkpoint(path)
    r = Trainer(Net(1), loss_fn=_ce, optimizer=optimizers.Adam(1e-2),
                ema_decay=0.9, device="cpu", seed=4).restore_checkpoint(path)
    assert r.step == t.step == 3 and r.nan_skips == 2
    for tree in ("params", "ema_params"):
        a, b = getattr(t, tree), getattr(r, tree)
        assert all(torch.equal(a[k], b[k]) for k in a), tree
    for k, v in t._buffers().items():
        assert torch.equal(v, r._buffers()[k]), k
    for k, v in t._opt_state().items():
        assert torch.equal(v, r._opt_state()[k]), k
    assert float(r.optimizer.count) == 3.0
    assert all(st["count"] is r.optimizer.count
               for st in r.optimizer.state.values())
    assert torch.equal(torch.get_rng_state(),
                       t._loop_state()["cpu_rng"])
    assert torch.equal(r.network.drop.generator.get_state(),
                       t.network.drop.generator.get_state())
    with pytest.raises(ValueError, match="TrainCheckpoint"):
        save_weights(Net(0), path)
        TrainCheckpoint.restore(path, {}, {}, {})


@pytest.mark.parametrize("options", [
    dict(),
    dict(ema_decay=0.9, grad_accum=2, compute_dtype=torch.bfloat16),
    dict(nan_guard=True, ema_decay=0.5),
])
def test_resumed_run_is_bitwise_the_uninterrupted_one(tmp_path, options):
    """Three steps, a checkpoint, a fresh trainer built from another seed
    restored from it, three more steps: losses, parameters, EMA and
    BatchNorm statistics equal the uninterrupted run's bitwise (dropout
    from torch's default generator and from a layer's own)."""
    data = _batches(6)
    if options.get("nan_guard"):
        data[4][0][0, 0] = np.nan  # a poisoned batch after the resume

    def trainer(seed):
        return Trainer(Net(seed), loss_fn=_ce,
                       optimizer=optimizers.Adam(1e-2), device="cpu",
                       seed=seed, **options)

    def steps(t, batches):
        out = []
        for x, y in batches:
            out.append(t._train_step(*t._put_batch((x, y)))[0])
            t.step += 1
        return out

    whole = trainer(0)
    want = steps(whole, data)
    first = trainer(0)
    steps(first, data[:3])
    path = str(tmp_path / "resume.npz")
    first.save_checkpoint(path)
    resumed = trainer(7).restore_checkpoint(path)
    got = steps(resumed, data[3:])
    assert all(torch.equal(a, b, ) or (a.isnan() and b.isnan())
               for a, b in zip(want[3:], got))
    assert resumed.step == whole.step == 6
    for k, p in whole.params.items():
        assert torch.equal(p, resumed.params[k]), k
    if whole.ema_params is not None:
        for k, e in whole.ema_params.items():
            assert torch.equal(e, resumed.ema_params[k]), k
    for k, b in whole._buffers().items():
        assert torch.equal(b, resumed._buffers()[k]), k
