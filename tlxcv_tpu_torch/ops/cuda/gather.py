"""Row gather: the Hopper kernel's wrapper and its plain version.

Replaces the Pallas TPU kernels ``tlxcv_tpu/ops/pallas/gather.py``
(``gather_rows`` :55, async-DMA ``_kernel`` :36, and ``gather_rows_bs``
:90, BlockSpec ``_bs_kernel`` :82), which compute one function: one kernel,
``csrc/gather_rows.cu``, backs both names.  Its source note says what
bounds it on the H100 and how its design meets that.  The TPU knobs ``g``,
``wave`` and ``interpret`` have no counterpart.

``gather_rows(table, idx)`` is ``table[idx]`` for a 2-D contiguous table of
any dtype and 1-D int32 indices in ``[0, N)`` (not checked on the card:
that would need a read back to the host).  It takes the plain version for
CPU tensors; for CUDA tensors it launches the kernel or raises, never
falling back.

Its forward is the operator ``tlxcv::gather_rows`` (``library``), which
``torch.export`` records.  It is differentiable in a floating table.  The
gradient is a scatter-add of the output gradient into an f32 zero table,
cast back to the table's dtype.
The reference has no backward kernel here: its gradient of ``table[idx]``
is XLA's scatter-add, outside any Pallas kernel, and ``index_add_`` is its
counterpart.  On the card ``index_add_`` adds with atomics, so the order of
the sums into a repeated row, and so their last bits, change from run to
run.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .library import check_device, define, needs_grad

__all__ = ["gather_rows", "gather_rows_bs", "gather_rows_plain"]


def _check(table, idx):
    if table.ndim != 2:
        raise ValueError(f"table must be 2-D [N, C], got {tuple(table.shape)}")
    if idx.ndim != 1 or idx.dtype != torch.int32:
        raise ValueError(f"idx must be 1-D int32, got {tuple(idx.shape)} "
                         f"{idx.dtype}")
    if idx.device != table.device:
        raise ValueError(f"table on {table.device}, idx on {idx.device}")


def gather_rows_plain(table, idx):
    """``table[idx]`` by torch's advanced indexing."""
    _check(table, idx)
    return table[idx.long()]


def _kernel_fn():
    fn = _build.library("gather_rows").tlx_gather_rows
    if fn.argtypes is None:
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [p, p, p, ll, ll, p]
        fn.restype = ctypes.c_int
    return fn


def _error_string(rc):
    fn = _build.library("gather_rows").tlx_gather_error_string
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
    return fn(rc).decode()


def _gather_kernel(table, idx):
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows runs on CUDA or CPU tensors, got "
                         f"{table.device}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_rows takes a contiguous table and idx")
    out = table.new_empty((idx.shape[0], table.shape[1]))
    if out.numel() == 0:
        return out
    with torch.cuda.device(table.device):
        rc = _kernel_fn()(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                          idx.shape[0], table.shape[1] * table.element_size(),
                          torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gather_rows kernel launch failed: "
                           f"{_error_string(rc)} ({rc})")
    gather_rows.launches += 1
    return out


gather_rows_op = define(
    "gather_rows(Tensor table, Tensor idx) -> Tensor", gather_rows_plain,
    _gather_kernel,
    lambda table, idx: table.new_empty(idx.shape[0], table.shape[1]))


class _GatherRows(torch.autograd.Function):
    """``table[idx]`` with its gradient, a scatter-add in f32."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        return gather_rows_op(table, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        grad = torch.zeros(ctx.table_shape, dtype=torch.float32,
                           device=g.device)
        grad.index_add_(0, idx, g.float())
        return grad.to(ctx.table_dtype), None


def gather_rows(table, idx):
    """table [N, C] (any dtype, contiguous), idx [R] int32 in [0, N) ->
    [R, C], byte for byte ``table[idx]``; differentiable in a floating
    table."""
    _check(table, idx)
    check_device("gather_rows", table)
    if needs_grad(table):
        return _GatherRows.apply(table, idx)
    return gather_rows_op(table, idx)


gather_rows.launches = 0  # kernel launches since the last reset
gather_rows_bs = gather_rows  # the reference's second formulation
