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
  result keeps its bits; on the meta device too, where it computes
  shapes only (a dry run counts its callers, `launch/roofline.py`);
* on the card it groups ``idx`` into runs of equal ids (`segment_plan`)
  and launches the hand-written `csrc/segment_add.cu`, which works by
  (run, column tile): each (id, column) starts from ``dst[id, c]``, adds
  the run's rows in index order and writes once — the CPU's order, so
  the card gives the CPU's bits on every run.  It never falls back: a
  build or launch failure raises.

The plan: for at most `GROUP_MAX` ids one block of the grouping kernel
sorts them in shared memory and writes the run table (no `torch.sort`);
above it `torch.sort` sorts them and a second kernel writes the run
table.  `segment_plan_plain` and `segment_add_plain` are the plain
versions of the two steps (stable sort + `unique_consecutive`; the
run-by-run add in index order), for the tests and the card's checks.

Scatters whose result does not depend on the order stay on
`index_add_`: the collision counts of `sgd._batch_scales` add 1.0s,
exact in float32 below 2²⁴; the conflict-free plain steps of
`kernels/mf_sgd/ref.py` never collide.  Not
`torch.use_deterministic_algorithms`, a process-wide switch that changes
other operators and makes some raise; not `scatter_reduce_`, which is
just as atomic.

`gather_rows` is a row gather whose backward goes through
`index_add_det_`: the gathered ids repeat.

``LAUNCHES`` counts the add kernel's launches (one per `index_add_det_`
on the card), ``GROUP_LAUNCHES`` the one-block grouping kernel's,
``RUN_LAUNCHES`` the run-table kernel's after a sort, ``SORTS`` the
`torch.sort` calls `segment_plan` makes.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, KernelTypeError, KernelValueError

__all__ = ["GROUP_LAUNCHES", "GROUP_MAX", "LAUNCHES", "LONG_RUN",
           "RUN_LAUNCHES", "SORTS", "SegmentPlan", "gather_rows",
           "index_add_det_", "index_add_det", "segment_add_plain",
           "segment_plan", "segment_plan_plain", "segment_plans"]

LAUNCHES = 0
GROUP_LAUNCHES = 0
RUN_LAUNCHES = 0
SORTS = 0

# the one-block grouping kernel's largest n (`kGroupMax` in
# csrc/segment_add.cu): 512 threads rank 16 ids each, and its shared
# memory holds 12 bytes an id and 32 counters a thread, 164 KB at 8,192;
# the fit's leftover batches (512) and the online step's (4,096) fit with
# room
GROUP_MAX = 8192
# a run longer than this streams through the add kernel's staged ring
LONG_RUN = 32


class SegmentPlan(NamedTuple):
    """Runs of equal ids of one id vector, reusable across scatters that
    share the ids (simLSH's bands all scatter by the same columns).

    ``buf`` (int32 [4n + 4]) holds, in order: the grouped positions
    (stable: ``idx[order]`` ascending) [n]; each run's id [n] and first
    grouped position [n + 1] (the last start is n); the runs longer than
    ``LONG_RUN`` [n]; then R, the number of long runs and ``LONG_RUN``.
    Entries past R (past the long count) are unspecified."""
    buf: torch.Tensor
    n: int

    @property
    def order(self) -> torch.Tensor:
        return self.buf[:self.n]

    def table(self) -> tuple:
        """(run ids [R], starts [R + 1], lengths [R], long runs [L]) —
        reads R from the device."""
        n = self.n
        R, L, _ = (int(v) for v in self.buf[4 * n + 1:].tolist())
        starts = self.buf[2 * n:2 * n + R + 1]
        return (self.buf[n:n + R], starts, starts[1:] - starts[:-1],
                self.buf[3 * n + 1:3 * n + 1 + L])


class _GroupJob(ctypes.Structure):
    """`GroupJob` of csrc/segment_add.cu: one id vector to group."""
    _fields_ = [("idx", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("is64", ctypes.c_int), ("plan", ctypes.c_void_p)]


_GROUP_JOBS = 2    # id vectors a grouping launch takes (`kGroupJobs`)


def segment_plans(*idxs: torch.Tensor) -> list:
    """`segment_plan` of each of at most two id vectors.  Those of at most
    `GROUP_MAX` ids share one grouping launch (one block each): a step
    that scatters by its row ids and by its column ids groups both at
    once."""
    global GROUP_LAUNCHES, RUN_LAUNCHES, SORTS
    if len(idxs) > _GROUP_JOBS:
        raise KernelValueError(f"segment_plans: at most {_GROUP_JOBS} id "
                               f"vectors, got {len(idxs)}")
    plans = [None] * len(idxs)
    jobs, keep = [], []
    for k, idx in enumerate(idxs):
        if idx.device.type != "cuda":
            continue
        dev, n = idx.device, idx.numel()
        if n >= 2 ** 29:       # the plan's 4n + 4 int32 entries
            raise KernelValueError(f"segment_plan: {n} ids is past the "
                                   f"kernel's 2^29 - 1")
        if n > GROUP_MAX:
            # ids are row numbers below 2^31: int32 keys halve the radix
            # passes
            s = torch.sort(idx.reshape(-1).to(torch.int32), stable=True)
            SORTS += 1
            buf = torch.empty(4 * n + 4, dtype=torch.int32, device=dev)
            scratch = torch.empty(2048, dtype=torch.int32, device=dev)
            err = _build.library().segment_runs_launch(
                s.values.data_ptr(), s.indices.data_ptr(), n, LONG_RUN,
                buf.data_ptr(), scratch.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
            _build.check(err, "segment_runs")
            RUN_LAUNCHES += 1
            plans[k] = SegmentPlan(buf, n)
            continue
        if keep and dev != keep[0].device:
            raise KernelValueError("segment_plans: the id vectors one "
                                   "grouping launch takes must share a card")
        idx = idx.reshape(-1)
        if idx.dtype not in (torch.int32, torch.int64):
            idx = idx.long()
        keep.append(idx.contiguous())
        plans[k] = SegmentPlan(
            torch.empty(4 * n + 4, dtype=torch.int32, device=dev), n)
        jobs.append(_GroupJob(keep[-1].data_ptr(), n,
                              int(idx.dtype == torch.int64),
                              plans[k].buf.data_ptr()))
    if jobs:
        err = _build.library().segment_group_launch(
            (_GroupJob * len(jobs))(*jobs), len(jobs), LONG_RUN,
            torch.cuda.current_stream(keep[0].device).cuda_stream)
        _build.check(err, "segment_group")
        GROUP_LAUNCHES += 1
    return plans


def segment_plan(idx: torch.Tensor) -> SegmentPlan | None:
    """The plan `index_add_det_` needs for ``idx`` on the card, made on the
    card (one grouping launch for at most `GROUP_MAX` ids; `torch.sort`
    and the run-table launch above); None on the CPU, where none is
    needed."""
    return segment_plans(idx)[0]


def segment_plan_plain(idx: torch.Tensor) -> SegmentPlan:
    """The grouping kernels' plain version, on ``idx``'s device: a stable
    `torch.sort` and `unique_consecutive` → the same layout."""
    ids = idx.reshape(-1).to(torch.int32)
    n = ids.numel()
    s = torch.sort(ids, stable=True)
    run_ids, lengths = torch.unique_consecutive(s.values,
                                                return_counts=True)
    R = run_ids.numel()
    longs = torch.nonzero(lengths > LONG_RUN).reshape(-1)
    buf = torch.zeros(4 * n + 4, dtype=torch.int32, device=ids.device)
    buf[:n] = s.indices
    buf[n:n + R] = run_ids
    buf[2 * n + 1:2 * n + R + 1] = torch.cumsum(lengths, 0)
    buf[3 * n + 1:3 * n + 1 + longs.numel()] = longs
    buf[4 * n + 1:] = torch.tensor([R, longs.numel(), LONG_RUN])
    return SegmentPlan(buf, n)


def segment_add_plain(dst: torch.Tensor, src: torch.Tensor,
                      plan: SegmentPlan) -> torch.Tensor:
    """The add kernel's plain version, in place: run by run (all runs at
    once, one row of each a step), each (id, column) starting from
    ``dst`` and adding its run's rows in index order; returns ``dst``.
    Bit-equal to ``index_add_`` on the same plan's ids."""
    run_ids, starts, lengths, _ = plan.table()
    order = plan.order.long()
    rows = run_ids.long()
    d2 = dst[:, None] if dst.ndim == 1 else dst
    s2 = src.reshape(plan.n, d2.shape[1])
    acc = d2[rows].clone()                              # [R, width]
    for k in range(int(lengths.max()) if len(rows) else 0):
        live = lengths > k
        acc[live] = acc[live] + s2[order[starts[:-1][live] + k]]
    d2[rows] = acc
    return dst


def index_add_det_(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor,
                   *, plan: SegmentPlan | None = None) -> torch.Tensor:
    """``dst[idx[i]] += src[i]`` in index order, in place; returns ``dst``.

    ``dst`` is 1-D or 2-D float32 (a column slice such as ``row[:, :F]``
    is fine: its row stride may exceed its width, but its columns must be
    adjacent); ``idx`` [n] integer; ``src`` [n] or [n, width].  ``plan``
    (from `segment_plan` of the same ``idx``) skips the grouping."""
    global LAUNCHES
    dev = dst.device
    if dev.type in ("cpu", "meta"):
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
    elif plan.n != n or plan.buf.device != dev:
        raise KernelValueError(
            "index_add_det_: the plan was made for another idx")
    src = src.contiguous()
    err = _build.library().segment_add_launch(
        dst.data_ptr(), dst.stride(0), dst.shape[0], src.data_ptr(), n,
        width, plan.buf.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
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
