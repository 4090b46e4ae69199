"""Optimizer factories (counterpart of ``tlxcv_tpu/train/optimizers.py``):
``Adam``, ``AdamW``, ``SGD``, ``Momentum`` and ``RMSprop`` with optax's
arithmetic, the schedules ``EpochDecay``, ``cosine_schedule`` and
``warmup_cosine``, ``no_decay_mask`` and global-norm clipping.

A factory returns a recipe, as the reference returns an optax
transformation before it meets the parameters: ``Adam(1e-3)(named_params)``
builds a ``torch.optim.Optimizer``.  The optimizers are written on
``torch.optim.Optimizer`` (parameter groups, ``state``, ``step()``,
``zero_grad()``) rather than taken from ``torch.optim.Adam`` and friends,
for two reasons:

- optax's arithmetic: ``mu_hat / (sqrt(nu_hat) + eps)`` with the bias
  corrections applied to the moments, eps inside the square root for
  RMSprop, and ``clip_by_global_norm``'s ``g · max / ‖g‖`` (not
  ``clip_grad_norm_``'s ``max / (‖g‖ + 1e-6)``);
- every piece of state, the count of applied updates included, is a
  tensor on the parameters' device, made when the optimizer is built.  A
  step that the Trainer's ``nan_guard`` or ``grad_accum`` gate skips is
  undone on the device with ``torch.where``, with no read back to the
  host, as the reference selects its optimizer state inside the jitted
  step.  ``torch.optim.Adam`` keeps its step count on the host.

A learning rate is a float or a schedule: a function of the count of
applied updates (a float32 tensor, 0 for the first update), evaluated on
the device.  Weight decay is restricted by a mask, as optax's ``mask=``:
the masked-out parameters form a second parameter group with no decay.
A learning rate per label (``lr={label: lr}``, ``lr_labels``) makes one
parameter group per label, as optax's ``multi_transform``.
"""
from __future__ import annotations

import functools
import math

import torch

__all__ = ["Adam", "AdamW", "SGD", "Momentum", "RMSprop", "EpochDecay",
           "cosine_schedule", "warmup_cosine", "no_decay_mask",
           "clip_by_global_norm"]


def no_decay_mask(named_params) -> dict:
    """Weight decay only for rank >= 2 kernels: biases and BatchNorm /
    LayerNorm scales and offsets are exempt.  Takes ``{name: tensor}`` (or
    ``module.named_parameters()``) and returns ``{name: bool}``."""
    return {k: v.ndim >= 2 for k, v in dict(named_params).items()}


def clip_by_global_norm(grads, max_norm):
    """optax's rule: ``g`` where ``‖g‖ < max_norm``, else ``(g / ‖g‖) ·
    max_norm``, ``‖g‖`` the norm over every tensor together."""
    norm = torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm)
            for g in grads]


class _Optax(torch.optim.Optimizer):
    """The common part: groups from the decay mask, the state made at
    once, the count of applied updates, clipping and the schedule."""

    def __init__(self, named_params, lr, defaults, grad_clip=None,
                 weight_decay=0.0, weight_decay_mask=None, lr_labels=None):
        named = list(dict(named_params).items())
        if not named:
            raise ValueError("the optimizer got no parameters")
        if isinstance(lr, dict):
            # optax's multi_transform: one group per label, each with its
            # own learning rate (the labels in lr's order)
            if lr_labels is None or weight_decay_mask is not None:
                raise ValueError("a learning rate per label takes lr_labels "
                                 "and no weight_decay_mask")
            labels = (lr_labels(dict(named)) if callable(lr_labels)
                      else lr_labels)
            unknown = {labels[k] for k, _ in named} - set(lr)
            if unknown:
                raise ValueError(f"labels without a learning rate: {unknown}")
            groups = [{"params": [p for k, p in named if labels[k] == name],
                       "lr": rate} for name, rate in lr.items()]
            groups = [g for g in groups if g["params"]]
        elif weight_decay and weight_decay_mask is not None:
            mask = (weight_decay_mask(dict(named))
                    if callable(weight_decay_mask) else weight_decay_mask)
            groups = [{"params": [p for k, p in named if mask[k]]},
                      {"params": [p for k, p in named if not mask[k]],
                       "weight_decay": 0.0}]
            groups = [g for g in groups if g["params"]]
        else:
            groups = [{"params": [p for _, p in named]}]
        super().__init__(groups, dict(lr=None if isinstance(lr, dict)
                                      else lr, weight_decay=weight_decay,
                                      **defaults))
        self.grad_clip = grad_clip
        first = self.param_groups[0]["params"][0]
        # one count, shared by every parameter's state
        self.count = torch.zeros((), dtype=torch.float32, device=first.device)
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p] = {"count": self.count, **self._init_state(p)}

    def _init_state(self, p):
        return {}

    def _lr(self, group, count):
        lr = group["lr"]
        return lr(count) if callable(lr) else lr

    @torch.no_grad()
    def step(self, closure=None):
        """One update from every parameter's ``.grad`` (a parameter without
        one counts as a zero gradient, as optax updates every leaf)."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        params = [p for g in self.param_groups for p in g["params"]]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if self.grad_clip:
            grads = clip_by_global_norm(grads, self.grad_clip)
        grads = dict(zip(params, grads))
        count = self.count
        for group in self.param_groups:
            ps = group["params"]
            self._update(group, ps, [grads[p] for p in ps],
                         self._lr(group, count), count)
        self.count.add_(1.0)
        return loss


class OptaxAdam(_Optax):
    """optax ``adam`` / ``adamw``: ``u = mu_hat / (sqrt(nu_hat) + eps) +
    wd · p``, ``p += -lr · u``."""

    def __init__(self, named_params, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=0.0, weight_decay_mask=None, grad_clip=None,
                 lr_labels=None):
        super().__init__(named_params, lr, dict(b1=b1, b2=b2, eps=eps),
                         grad_clip, weight_decay, weight_decay_mask,
                         lr_labels)

    def _init_state(self, p):
        return {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}

    def _update(self, group, ps, grads, lr, count):
        b1, b2, eps = group["b1"], group["b2"], group["eps"]
        mu = [self.state[p]["mu"] for p in ps]
        nu = [self.state[p]["nu"] for p in ps]
        # (1 - b) * g^k + b * t, as optax's update_moment
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1.0 - b2))
        t = count + 1.0
        mu_hat = torch._foreach_div(mu, 1.0 - b1 ** t)
        nu_hat = torch._foreach_div(nu, 1.0 - b2 ** t)
        den = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(den, eps)
        u = torch._foreach_div(mu_hat, den)
        if group["weight_decay"]:
            torch._foreach_add_(u, torch._foreach_mul(ps,
                                                      group["weight_decay"]))
        _apply(ps, u, lr)


class OptaxSGD(_Optax):
    """optax ``sgd`` (after ``add_decayed_weights``): ``g += wd · p``; with
    momentum ``t = g + m · t`` and ``u = t`` (Nesterov: ``g + m · t``);
    ``p += -lr · u``."""

    def __init__(self, named_params, lr=0.01, momentum=0.0, nesterov=False,
                 weight_decay=0.0, grad_clip=None):
        super().__init__(named_params, lr,
                         dict(momentum=momentum, nesterov=nesterov),
                         grad_clip, weight_decay)

    def _init_state(self, p):
        if self.defaults["momentum"]:
            return {"trace": torch.zeros_like(p)}
        return {}

    def _update(self, group, ps, grads, lr, count):
        if group["weight_decay"]:
            grads = torch._foreach_add(
                grads, torch._foreach_mul(ps, group["weight_decay"]))
        m = group["momentum"]
        if m:
            trace = [self.state[p]["trace"] for p in ps]
            torch._foreach_mul_(trace, m)
            torch._foreach_add_(trace, grads)     # g + m * t
            grads = (torch._foreach_add(grads, torch._foreach_mul(trace, m))
                     if group["nesterov"] else trace)
        _apply(ps, grads, lr)


class OptaxRMSprop(_Optax):
    """optax ``rmsprop`` (eps inside the square root): ``nu = (1 - d) ·
    g² + d · nu``, ``u = g · rsqrt(nu + eps)``, ``p += -lr · u``."""

    def __init__(self, named_params, lr=1e-3, decay=0.9, eps=1e-8,
                 grad_clip=None):
        super().__init__(named_params, lr, dict(decay=decay, eps=eps),
                         grad_clip)

    def _init_state(self, p):
        return {"nu": torch.zeros_like(p)}

    def _update(self, group, ps, grads, lr, count):
        d, eps = group["decay"], group["eps"]
        nu = [self.state[p]["nu"] for p in ps]
        torch._foreach_mul_(nu, d)
        torch._foreach_add_(nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1.0 - d))
        scale = torch._foreach_add(nu, eps)
        torch._foreach_rsqrt_(scale)
        _apply(ps, torch._foreach_mul(scale, grads), lr)


def _apply(ps, updates, lr):
    """``p = p + u · (-lr)`` (optax's ``scale_by_learning_rate`` and
    ``apply_updates``); lr a float or a 0-dim tensor."""
    torch._foreach_add_(ps, torch._foreach_mul(updates, -lr))


def Adam(lr=1e-3, beta_1=0.9, beta_2=0.999, eps=1e-8, weight_decay=0.0,
         grad_clip=None, weight_decay_mask=None, lr_labels=None):
    """``lr`` may be ``{label: lr}`` with ``lr_labels`` ``{name: label}``
    (or a function of ``{name: tensor}`` giving it): optax's
    ``multi_transform`` of one Adam per label; ``grad_clip`` then clips
    over every parameter together, as ``chain(clip_by_global_norm,
    multi_transform)``."""
    return functools.partial(OptaxAdam, lr=lr, b1=beta_1, b2=beta_2,
                             eps=eps, weight_decay=weight_decay,
                             weight_decay_mask=weight_decay_mask,
                             grad_clip=grad_clip, lr_labels=lr_labels)


def AdamW(lr=1e-3, weight_decay=1e-4, **kw):
    return Adam(lr, weight_decay=weight_decay, **kw)


def SGD(lr=0.01, momentum=0.0, weight_decay=0.0, nesterov=False,
        grad_clip=None):
    return functools.partial(OptaxSGD, lr=lr, momentum=momentum,
                             nesterov=nesterov, weight_decay=weight_decay,
                             grad_clip=grad_clip)


def Momentum(lr=0.01, momentum=0.9, **kw):
    return SGD(lr, momentum=momentum, **kw)


def RMSprop(lr=1e-3, decay=0.9, eps=1e-8, grad_clip=None):
    return functools.partial(OptaxRMSprop, lr=lr, decay=decay, eps=eps,
                             grad_clip=grad_clip)


def EpochDecay(base_lr, steps_per_epoch, boundaries_epochs=(17, 20),
               rate=0.1):
    """Step decay by epoch, as optax's ``piecewise_constant_schedule``:
    ×rate from each boundary step on."""
    bounds = sorted({int(e * steps_per_epoch): rate
                     for e in boundaries_epochs}.items())

    def schedule(count):
        v = torch.full_like(count, base_lr)
        for threshold, scale in bounds:
            ind = torch.clamp_min(torch.sign(threshold - count), 0.0)
            v = v * ind + (1 - ind) * scale * v
        return v

    return schedule


def cosine_schedule(base_lr, total_steps, final_scale=0.0):
    """optax's ``cosine_decay_schedule(base_lr, total_steps,
    alpha=final_scale)``."""
    if not total_steps > 0:
        raise ValueError(f"total_steps must be positive, got {total_steps}")

    def schedule(count):
        c = torch.clamp_max(count, float(total_steps))
        cos = 0.5 * (1 + torch.cos(math.pi * c / float(total_steps)))
        return base_lr * ((1 - final_scale) * cos + final_scale)

    return schedule


def warmup_cosine(base_lr, warmup_steps, total_steps, final_scale=0.0):
    """optax's ``warmup_cosine_decay_schedule(0, base_lr, warmup_steps,
    total_steps, end_value=base_lr * final_scale)``: linear from 0, then a
    cosine over the remaining steps."""
    decay = cosine_schedule(base_lr, total_steps - warmup_steps, final_scale)

    def schedule(count):
        c = torch.clamp(count, 0.0, float(warmup_steps))
        warm = (0.0 - base_lr) * (1 - c / warmup_steps) + base_lr
        return torch.where(count < warmup_steps, warm,
                           decay(count - warmup_steps))

    return schedule
