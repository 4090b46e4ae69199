"""Trainer (counterpart of ``tlxcv_tpu/train/trainer.py``).

    trainer = Trainer(network=task, loss_fn=task.loss_fn,
                      optimizer=optimizers.Adam(1e-4),
                      compute_dtype=torch.bfloat16)
    trainer.train(n_epoch=1, train_dataset=loader, max_steps_per_epoch=k)

The semantics are the reference's (``trainer.py:87-245``).  The trainer
owns f32 master copies of the network's parameters and runs the network
through ``torch.func.functional_call`` on them, as the reference runs its
pure function on ``split()`` params; ``train()`` writes the evaluation
parameters (the EMA when it is kept) back into the network at its end.
BatchNorm statistics are the network's own buffers, updated in place by
its forward.

- ``compute_dtype=torch.bfloat16``: the masters, gradients, optimizer
  state, BatchNorm statistics and the loss stay f32.  Inside the
  differentiated function the float parameters are cast to bf16 (so the
  gradients reach the masters through the cast), the float inputs are cast
  to bf16, and every float output is cast to f32 before ``loss_fn``.  This
  is not ``torch.autocast``, which picks per operation what runs in bf16.
- ``grad_accum=k``: optax's ``MultiSteps``: the microbatch gradients are
  averaged by its running mean, one optimizer update every k microbatches,
  the schedule advancing once per update.
- ``nan_guard``: a step whose loss or gradients are not finite changes
  nothing (parameters, optimizer state and accumulators, EMA, BatchNorm
  statistics) and reports a NaN loss; the skips are counted once an epoch
  in ``nan_skips``.  The selection runs on the device with ``torch.where``,
  with no read back to the host per step.
- ``ema_decay``: an exponential moving average of the parameters, advanced
  only by an applied update; ``ema_for_eval`` routes ``evaluate``,
  ``predict`` and ``save_weights`` through it.

Not ported yet (each raises ``NotImplementedError``): ``metrics`` (ROADMAP
queue 1, item 14), ``mesh`` and ``param_sharding="fsdp"`` (item 15),
``remat``, ``progress=True``, ``save_checkpoint`` and
``restore_checkpoint`` (item 5).
"""
from __future__ import annotations

import time
import typing as tp

import torch
from torch.func import functional_call

from ..data.loader import device_prefetch
from ..device import resolve_device
from . import optimizers

__all__ = ["Trainer", "Model"]


def _not_ported(what, item):
    return NotImplementedError(f"Trainer: {what} is not ported yet "
                               f"(ROADMAP queue 1, item {item})")


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _cast_floats(tree, dtype):
    return _map(lambda v: v.to(dtype) if isinstance(v, torch.Tensor)
                and v.is_floating_point() else v, tree)


class _Call(torch.nn.Module):
    """The network and its loss as one module, so that ``functional_call``
    swaps the parameters for the forward passes that ``loss_fn`` makes
    itself (Mask R-CNN runs its heads there), as the reference's ``pure``
    covers ``loss_fn``."""

    def __init__(self, network, loss_fn):
        super().__init__()
        self.network = network
        self.loss_fn = loss_fn

    def forward(self, x, y, compute_dtype):
        out = self.network(x)
        if compute_dtype is not None:
            out = _cast_floats(out, torch.float32)  # loss math stays f32
        loss = self.loss_fn(out, y)
        if isinstance(loss, tuple):
            loss, out = loss[0], loss[1]
        return loss, out


class Trainer:
    """Generic trainer; the alias ``Model`` keeps the reference's
    spelling."""

    def __init__(self, network: torch.nn.Module, loss_fn=None,
                 optimizer=None, metrics=None, mesh=None, seed: int = 0,
                 param_sharding: str = "replicated",
                 ema_decay: tp.Optional[float] = None,
                 ema_for_eval: bool = True, compute_dtype=None,
                 remat: bool = False, grad_accum: int = 1,
                 nan_guard: bool = False, device=None):
        """``optimizer`` is a factory of ``train.optimizers`` (default
        ``Adam(1e-3)``).  ``device``: where the network and its batches
        live (``None``: the CUDA card).  ``seed`` seeds torch's generators
        once, here: the port's Dropout layers draw from them unless given
        their own."""
        if metrics is not None:
            raise _not_ported("metrics (with utils/metrics)", 14)
        if mesh is not None:
            raise _not_ported("a device mesh", 15)
        if param_sharding == "fsdp":
            raise _not_ported('param_sharding="fsdp"', 15)
        if param_sharding != "replicated":
            raise ValueError(f"unknown param_sharding {param_sharding!r}")
        if remat:
            raise _not_ported("remat", 5)
        self.device = resolve_device(device)
        self.network = network.to(self.device)
        self.loss_fn = loss_fn if loss_fn is not None else network.loss_fn
        self._call = _Call(self.network, self.loss_fn)
        self.compute_dtype = compute_dtype
        self.grad_accum = int(grad_accum)
        self.nan_guard = bool(nan_guard)
        self.nan_skips = 0
        self.step = 0
        torch.manual_seed(seed)
        self.params = {k: p.detach().clone().requires_grad_(True)
                       for k, p in network.named_parameters()}
        self.optimizer = (optimizer if optimizer is not None
                          else optimizers.Adam(1e-3))(self.params.items())
        self.ema_decay = None if ema_decay is None else float(ema_decay)
        self.ema_for_eval = ema_for_eval and ema_decay is not None
        # seeded at the trained params, so no debiasing is needed
        self.ema_params = (None if ema_decay is None else
                           {k: p.detach().clone()
                            for k, p in self.params.items()})
        if self.grad_accum > 1:
            self._acc = [torch.zeros_like(p) for p in self.params.values()]
            self._mini = torch.zeros((), dtype=torch.int64,
                                     device=self.device)

    # ------------------------------------------------------------------
    def _put_batch(self, batch):
        """Host arrays -> tensors on the device: a ``non_blocking`` copy
        from pinned memory on the card."""
        def put(v):
            t = torch.as_tensor(v)
            if t.device.type == "cpu" and self.device.type == "cuda":
                return t.pin_memory().to(self.device, non_blocking=True)
            return t.to(self.device)
        return _map(put, batch)

    def _loss(self, params, x, y, training):
        """loss_fn on the network's outputs, the reference's
        ``_train_call`` (training) or ``_eval_call``."""
        cd = self.compute_dtype if training else None
        if cd is not None:
            x = _cast_floats(x, cd)
            params = {k: p.to(cd) if p.is_floating_point() else p
                      for k, p in params.items()}
        return functional_call(
            self._call, {"network." + k: p for k, p in params.items()},
            (x, y, cd))

    def _train_step(self, x, y):
        self.network.train()
        stats = [b for b in self.network.buffers() if b.is_floating_point()]
        saved = [b.clone() for b in stats] if self.nan_guard else None
        ps = list(self.params.values())
        loss, out = self._loss(self.params, x, y, training=True)
        grads = torch.autograd.grad(loss, ps, allow_unused=True,
                                    materialize_grads=True)
        loss = loss.detach()
        ok = None
        if self.nan_guard:
            # one reduction: any inf or NaN poisons the sum
            total = sum(g.float().sum() for g in grads)
            ok = torch.isfinite(loss) & torch.isfinite(total)
            with torch.no_grad():
                for b, s in zip(stats, saved):
                    b.copy_(torch.where(ok, b, s))
            loss = torch.where(ok, loss, torch.full_like(loss, float("nan")))
        applied = self._apply(ps, grads, ok)
        if self.ema_params is not None:
            d = self.ema_decay
            with torch.no_grad():
                for k, e in self.ema_params.items():
                    new = e * d + self.params[k] * (1.0 - d)
                    e.copy_(new if applied is None
                            else torch.where(applied, new, e))
        return loss, out

    @torch.no_grad()
    def _apply(self, ps, grads, ok):
        """One optimizer update from ``grads``, kept only where the gate
        holds; returns the gate (``None``: always applied)."""
        gate = ok
        if self.grad_accum > 1:
            k, mini = self.grad_accum, self._mini
            # optax.MultiSteps: a running mean, an update on the k-th
            acc = [a + (g - a) / (mini + 1) for a, g in zip(self._acc, grads)]
            emit = mini == k - 1
            gate = emit if ok is None else emit & ok
            keep = [torch.where(emit, torch.zeros_like(a), a) for a in acc]
            new_mini = (mini + 1) % k
            if ok is not None:
                keep = [torch.where(ok, n, o) for n, o in zip(keep, self._acc)]
                new_mini = torch.where(ok, new_mini, mini)
            self._acc, self._mini, grads = keep, new_mini, acc
        for p, g in zip(ps, grads):
            p.grad = g
        if gate is None:
            self.optimizer.step()
        else:
            tensors = list({id(t): t for t in ps + [
                t for st in self.optimizer.state.values()
                for t in st.values() if isinstance(t, torch.Tensor)]}
                .values())                       # the count is shared
            old = [t.clone() for t in tensors]
            self.optimizer.step()
            for t, o in zip(tensors, old):
                t.copy_(torch.where(gate, t, o))
        for p in ps:
            p.grad = None
        return gate

    def _count_skips(self, losses) -> int:
        """nan_guard reports a skipped update as a NaN loss; tally them
        once per epoch (no host sync per step)."""
        if not self.nan_guard or not losses:
            return 0
        n = int(torch.isnan(torch.stack(losses)).sum())
        self.nan_skips += n
        return n

    def _mean_loss(self, losses) -> float:
        """Epoch-mean loss: a NaN under nan_guard is a skip, excluded;
        without the guard it is divergence and stays visible."""
        if not losses:
            return 0.0
        stack = torch.stack(losses)
        return float(stack.nanmean() if self.nan_guard else stack.mean())

    # ------------------------------------------------------------------
    def train(self, n_epoch: int, train_dataset, test_dataset=None,
              print_freq: int = 1, print_train_batch: bool = False,
              max_steps_per_epoch: tp.Optional[int] = None,
              progress: bool = False):
        if progress:
            raise _not_ported("progress=True", 5)
        for epoch in range(n_epoch):
            t0 = time.time()
            losses = []
            batches = device_prefetch(train_dataset, self._put_batch)
            for bi, (x, y) in enumerate(batches):
                if (max_steps_per_epoch is not None
                        and bi >= max_steps_per_epoch):
                    break
                loss, _ = self._train_step(x, y)
                self.step += 1
                losses.append(loss)
                if print_train_batch:
                    print(f"epoch {epoch + 1} batch {bi} "
                          f"loss {float(loss):.4f}")
            skipped = self._count_skips(losses)
            if (epoch + 1) % print_freq == 0:
                msg = (f"Epoch {epoch + 1} of {n_epoch} took "
                       f"{time.time() - t0:.2f}s | train loss: "
                       f"{self._mean_loss(losses):.4f}")
                if skipped:
                    msg += f" | nan_guard skipped {skipped} step(s)"
                print(msg)
                if test_dataset is not None:
                    print(f"   val: {self.evaluate(test_dataset)}")
        self._sync_to_network()
        return self

    @torch.no_grad()
    def evaluate(self, dataset, max_batches: tp.Optional[int] = None):
        self.network.eval()
        losses = []
        for bi, (x, y) in enumerate(dataset):
            if max_batches is not None and bi >= max_batches:
                break
            x, y = self._put_batch((x, y))
            losses.append(self._loss(self.eval_params, x, y,
                                     training=False)[0])
        return {"loss": float(torch.stack(losses).mean()) if losses
                else 0.0}

    @property
    def eval_params(self):
        """The EMA average when it is kept for evaluation, else the
        trained parameters."""
        return self.ema_params if self.ema_for_eval else self.params

    @torch.no_grad()
    def predict(self, inputs):
        self.network.eval()
        return functional_call(self.network, self.eval_params,
                               (self._put_batch(inputs),))

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _sync_to_network(self):
        """Write the evaluation parameters into the live network."""
        for k, p in self.network.named_parameters():
            p.copy_(self.eval_params[k])

    def save_weights(self, path: str):
        self._sync_to_network()
        torch.save(self.network.state_dict(), path)

    def save_checkpoint(self, path: str):
        raise _not_ported("save_checkpoint", 5)

    def restore_checkpoint(self, path: str):
        raise _not_ported("restore_checkpoint", 5)


Model = Trainer  # the reference's spelling
