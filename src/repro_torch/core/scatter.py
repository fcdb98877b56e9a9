"""Deterministic scatter-add along dim 0 — the port's colliding float
scatters, bit-reproducible on the card.

`torch.Tensor.index_add_` on CUDA adds rows that share an id with
atomics, in an order that changes from run to run, so an online update
(and an encode, a fit's leftover batch, the baselines) could differ in
its last bits between two runs on the same inputs — and a write-ahead
log's replay (`resil.wal`) must reproduce a state bit for bit.
`index_add_det_` is the replacement:

* on the CPU it *is* ``dst.index_add_(0, idx, src)``, which adds in
  index order (``dst[idx[i]] += src[i]`` for i = 0, 1, …), so every CPU
  result keeps its bits;
* on the card it sorts ``idx`` stably and launches the hand-written
  `csrc/segment_add.cu`: one thread per (run of equal ids, column)
  starts from ``dst[id, c]``, adds the run's rows in sorted (= original)
  order and writes once — the CPU's order, so the card gives the CPU's
  bits on every run.  It never falls back: a build or launch failure
  raises.

Its plain version is `torch.Tensor.index_add_` itself.  Scatters
whose result does not depend on the order stay on `index_add_`: the
collision counts of `sgd._batch_scales` add 1.0s, exact in float32 below
2²⁴; the conflict-free plain steps of `kernels/mf_sgd/ref.py` never
collide.  Not `torch.use_deterministic_algorithms`, a process-wide
switch that changes other operators and makes some raise; not
`scatter_reduce_`, which is just as atomic.

`gather_rows` is a row gather whose backward goes through
`index_add_det_`: the gathered ids repeat.

``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build, KernelTypeError, KernelValueError

__all__ = ["LAUNCHES", "SegmentPlan", "gather_rows", "index_add_det_",
           "index_add_det", "segment_plan"]

LAUNCHES = 0


class SegmentPlan(NamedTuple):
    """A stable sort of one id vector, reusable across scatters that share
    the ids (simLSH's bands all scatter by the same columns)."""
    sorted_ids: torch.Tensor   # [n] int32, ascending
    order: torch.Tensor        # [n] int64, idx[order] == sorted_ids


def segment_plan(idx: torch.Tensor) -> SegmentPlan | None:
    """The stable sort `index_add_det_` needs for ``idx`` on the card; None
    on the CPU, where none is needed."""
    if idx.device.type != "cuda":
        return None
    # ids are row numbers below 2^31: int32 keys halve the radix passes
    s = torch.sort(idx.reshape(-1).to(torch.int32), stable=True)
    return SegmentPlan(s.values, s.indices)


def index_add_det_(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor,
                   *, plan: SegmentPlan | None = None) -> torch.Tensor:
    """``dst[idx[i]] += src[i]`` in index order, in place; returns ``dst``.

    ``dst`` is 1-D or 2-D float32 (a column slice such as ``row[:, :F]``
    is fine: its row stride may exceed its width, but its columns must be
    adjacent); ``idx`` [n] integer; ``src`` [n] or [n, width].  ``plan``
    (from `segment_plan` of the same ``idx``) skips the sort."""
    global LAUNCHES
    dev = dst.device
    if dev.type == "cpu":
        return dst.index_add_(0, idx, src)
    if dev.type != "cuda":
        raise KernelValueError(f"index_add_det_: unsupported device {dev}")
    if dst.dtype != torch.float32 or src.dtype != torch.float32:
        raise KernelTypeError(
            f"index_add_det_: float32 only, got {dst.dtype} and "
            f"{src.dtype}")
    if dst.ndim not in (1, 2) or (dst.ndim == 2 and dst.stride(1) != 1
                                  and dst.shape[1] > 1):
        raise KernelValueError(
            f"index_add_det_: dst must be 1-D or 2-D with "
            f"adjacent columns, got shape {tuple(dst.shape)} "
            f"strides {dst.stride()}")
    if dst.shape[0] >= 2 ** 31:
        raise KernelValueError(
            "index_add_det_: the kernel takes int32 row ids")
    n = idx.numel()
    width = 1 if dst.ndim == 1 else dst.shape[1]
    if tuple(src.shape) != (n,) + tuple(dst.shape[1:]):
        raise KernelValueError(
            f"index_add_det_: src {tuple(src.shape)} does not "
            f"match idx [{n}] and dst {tuple(dst.shape)}")
    if idx.device != dev or src.device != dev:
        raise KernelValueError("index_add_det_: dst, idx and src must share a "
                               "device")
    if n == 0 or width == 0:
        return dst
    if plan is None:
        plan = segment_plan(idx)
    elif plan.sorted_ids.numel() != n:
        raise KernelValueError(
            "index_add_det_: the plan was made for another idx")
    src = src.contiguous()
    err = _build.library().segment_add_launch(
        dst.data_ptr(), dst.stride(0), dst.shape[0],
        plan.sorted_ids.data_ptr(), plan.order.data_ptr(), src.data_ptr(),
        n, width, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "segment_add")
    LAUNCHES += 1
    return dst


def index_add_det(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor,
                  *, plan: SegmentPlan | None = None) -> torch.Tensor:
    """Out-of-place `index_add_det_`: a copy of ``dst`` with the rows
    added."""
    return index_add_det_(dst.clone(), idx, src, plan=plan)


class _GatherRows(torch.autograd.Function):
    """``E[idx]``; the backward adds the rows' gradients into ``E``'s in
    index order (`index_add_det_`), in float32 and rounded to the
    gradient's dtype once."""

    @staticmethod
    def forward(ctx, E, idx):
        ctx.save_for_backward(idx)
        ctx.rows = E.shape[0]
        return E[idx.long()]

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        gE = torch.zeros((ctx.rows, g.shape[-1]), dtype=torch.float32,
                         device=g.device)
        index_add_det_(gE, idx.reshape(-1).long(),
                       g.reshape(-1, g.shape[-1]).float())
        return gE.to(g.dtype), None


def gather_rows(E: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``E[idx]`` ([*idx.shape, D]) with a deterministic backward: the ids
    repeat (a label token, a candidate drawn twice, the k slots of one
    token), and autograd's own backward of an index adds them with
    atomics on the card, in an order that changes from run to run."""
    return _GatherRows.apply(E, idx)
