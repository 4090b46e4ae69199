"""Linear sum assignment for DETR's matcher (counterpart of
``tlxcv_tpu/ops/hungarian.py``).

- :func:`hungarian_callback`: the exact assignment by scipy's
  ``linear_sum_assignment`` on the host.  The reference reaches it through
  ``jax.pure_callback``; here the round trip is explicit: the cost goes to
  the host (a device synchronisation), each matrix through scipy, and the
  result back to the cost's device.  Its host time is recorded under the
  profiler label ``hungarian_callback`` and summed in
  ``hungarian_callback.host_seconds``.
- :func:`auction_assign`: the reference's epsilon-scaling auction on the
  device, with no host round trip (approximate).
"""
from __future__ import annotations

import time

import numpy as np
import torch

__all__ = ["hungarian_callback", "auction_assign"]


def _scipy_lsa(cost: np.ndarray) -> np.ndarray:
    """Column per row [..., R] (int32), -1 where a row is unassigned."""
    from scipy.optimize import linear_sum_assignment

    if cost.ndim == 2:
        r, c = linear_sum_assignment(cost)
        out = np.full((cost.shape[0],), -1, np.int32)
        out[r] = c.astype(np.int32)
        return out
    return np.stack([_scipy_lsa(c) for c in cost])


def hungarian_callback(cost: torch.Tensor) -> torch.Tensor:
    """Exact assignment.  cost: [..., R, C] with R <= C; returns the column
    of each row [..., R] as int32 on the cost's device, -1 for a row left
    unassigned."""
    with torch.profiler.record_function("hungarian_callback"):
        t0 = time.perf_counter()
        host = cost.detach().to("cpu", torch.float64).numpy()
        out = torch.from_numpy(_scipy_lsa(host)).to(cost.device)
        hungarian_callback.host_seconds += time.perf_counter() - t0
    return out


hungarian_callback.host_seconds = 0.0  # summed since the last reset


def auction_assign(cost: torch.Tensor, num_iters: int = 200,
                   eps: float = 1e-3) -> torch.Tensor:
    """The auction minimizing total cost, on the cost's device.  cost:
    [R, C] or a batch [B, R, C], R <= C; returns the column of each row
    ([R] or [B, R], int32), -1 where the iteration budget left a row
    unassigned.  Approximate (epsilon-optimal).

    The reference's dropped scatters (``.at[i].set(..., mode="drop")``
    with the sentinel index R) write here into one padded column that is
    sliced off, so no index wraps."""
    batched = cost.ndim == 3
    cost = cost if batched else cost[None]
    b, r, c = cost.shape
    dev = cost.device
    benefit = -cost  # the auction maximizes
    neg_inf = torch.tensor(-float("inf"), dtype=cost.dtype, device=dev)
    prices = torch.zeros((b, c), dtype=cost.dtype, device=dev)
    owner = torch.full((b, c), -1, dtype=torch.long, device=dev)
    assign = torch.full((b, r), -1, dtype=torch.long, device=dev)
    cols = torch.arange(c, device=dev).expand(b, c)
    sentinel = torch.full((b, c), r, dtype=torch.long, device=dev)
    for _ in range(num_iters):
        unassigned = assign < 0
        # each unassigned row bids for its best column
        value = benefit - prices[:, None, :]
        best_v = value.amax(-1)
        best = value.argmax(-1)  # the first of equal values, as jnp.argmax
        second_v = value.scatter(-1, best[..., None], -float("inf"))
        bid = best_v - second_v.amax(-1) + eps
        bid_mat = torch.full_like(value, -float("inf")).scatter(
            -1, best[..., None],
            torch.where(unassigned, bid, neg_inf)[..., None])
        # the highest bidder of each column wins it
        win_bid = bid_mat.amax(1)
        win_row = bid_mat.argmax(1)
        has_bid = win_bid > neg_inf
        # the previous owner of a re-auctioned column loses it
        padded = torch.cat([assign, assign.new_full((b, 1), -1)], 1)
        padded.scatter_(1, torch.where(has_bid & (owner >= 0), owner,
                                       sentinel), -1)
        owner = torch.where(has_bid, win_row, owner)
        prices = torch.where(has_bid, prices + win_bid, prices)
        padded.scatter_(1, torch.where(has_bid, win_row, sentinel), cols)
        assign = padded[:, :r]
    assign = assign.to(torch.int32)
    return assign if batched else assign[0]
