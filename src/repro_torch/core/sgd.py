"""Stochastic optimization — paper Eq. (4)/(5) updates and the Eq. (7)
learning-rate decay (`repro/core/sgd.py`), single device.

Two engines: ``mf_step`` (CUSGD++, plain MF {U, V}) and ``culsh_step``
(CULSH-MF, the six-parameter update).  The *unpacked* steps take `Params`
and return new ones, one scatter per parameter — the reference
semantics.  The *packed* steps take `PackedParams` and update its two
planes in place with one scatter each; they share the forward and the
delta computation with the unpacked steps, so the two layouts stay bit
for bit equal.

Updates are applied to a mini-batch with a scatter-add
(`scatter.index_add_det_`, which adds colliding rows in index order on
both devices, so a step is bit-reproducible on the card): on a
conflict-free batch (each i and each j at most once) this is Eq. (5)
applied in parallel, exactly; with collisions it is the batch-SGD step
scaled by 1/count.

`train_epoch` is the legacy path (``schedule="none"``): shuffled
mini-batches assembled by lookup, on the unpacked steps with per-batch
collision scaling.  `train_epoch_scheduled` is the offline hot path:
contiguous-view batches of the schedule-ordered `ScheduledData`,
conflict-free width tiers on the packed planes — through the fused CUDA
steps of `kernels/mf_sgd` with ``use_kernels`` — and the leftover
batches on the scaled step with their precomputed collision
normalizers.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import scatter
from repro_torch.core.model import (Batch, PackedParams, Params,
                                    ScheduledData, assemble, predict,
                                    predict_gathered, predict_mf,
                                    slice_batch)
from repro_torch.data.sparse import EpochSchedule, SparseMatrix, epoch_batches
from repro_torch.kernels import pick
from repro_torch.kernels.mf_sgd.kernel import (culsh_sgd_tier,
                                               culsh_sgd_tier_ref,
                                               mf_sgd_tier, mf_sgd_tier_ref)
from repro_torch.kernels.mf_sgd.ops import culsh_hyper, mf_hyper


@dataclasses.dataclass(frozen=True)
class Hyper:
    # initial learning rates (paper Table 3/5 names)
    a_b: float = 0.02
    a_bh: float = 0.02
    a_u: float = 0.02
    a_v: float = 0.02
    a_w: float = 0.001
    a_c: float = 0.001
    # regularization
    l_b: float = 0.01
    l_bh: float = 0.01
    l_u: float = 0.01
    l_v: float = 0.01
    l_w: float = 0.05
    l_c: float = 0.05
    # Eq. (7) decay
    beta: float = 0.3


def lr_decay(hp: Hyper, t: int, device="cpu") -> torch.Tensor:
    """γ_t = α / (1 + β·t^1.5) — Eq. (7); the decay factor as a float32
    0-dim tensor on ``device``."""
    tt = torch.tensor(float(t), dtype=torch.float32)
    return (1.0 / (1.0 + hp.beta * torch.pow(tt, 1.5))).to(device)


def _batch_scales(M: int, N: int, bt: Batch, conflict_free: bool, scales):
    """(si, sj, si_col, sj_col): collision normalizers and their [B, 1]
    broadcasts, so a row hit k× in a batch gets the mean update.
    ``conflict_free`` promises all counts are 1; ``scales`` supplies
    precomputed (si, sj) (the schedule's leftover batches)."""
    if scales is not None:
        si, sj = scales
        return si, sj, si[:, None], sj[:, None]
    if conflict_free:
        return 1.0, 1.0, 1.0, 1.0
    dev = bt.valid.device
    # counts add 1.0s (or 0.0s): exact in float32 below 2^24 in any order,
    # so the atomic `index_add_` gives the same bits on every run
    ci = torch.zeros(M, device=dev).index_add_(0, bt.i.long(), bt.valid)
    cj = torch.zeros(N, device=dev).index_add_(0, bt.j.long(), bt.valid)
    si = 1.0 / ci[bt.i.long()].clamp(min=1.0)
    sj = 1.0 / cj[bt.j.long()].clamp(min=1.0)
    return si, sj, si[:, None], sj[:, None]


def _error(r, pred, bce: bool):
    """e_ij: the residual (L2) or r − σ(pred) (BCE, implicit feedback)."""
    return r - (torch.sigmoid(pred) if bce else pred)


def _mf_deltas(bt: Batch, e, ui, vj, hp: Hyper, decay, si_c, sj_c):
    """(du, dv) of the CUSGD++ update — shared by both layouts."""
    gu = hp.a_u * decay
    gv = hp.a_v * decay
    vmask = bt.valid[:, None]
    du = gu * (e[:, None] * vj - hp.l_u * ui) * vmask * si_c
    dv = gv * (e[:, None] * ui - hp.l_v * vj) * vmask * sj_c
    return du, dv


def _culsh_deltas(bt: Batch, e, aux, b_i, bh_j, ui, vj, wj, cj, hp: Hyper,
                  decay, si, sj, si_c, sj_c):
    """The six Eq. (5) deltas from row-aligned gathered operands — shared
    by the unpacked and packed steps."""
    d = decay
    vmask = bt.valid[:, None]
    db = hp.a_b * d * (e - hp.l_b * b_i) * bt.valid * si
    dbh = hp.a_bh * d * (e - hp.l_bh * bh_j) * bt.valid * sj
    du = hp.a_u * d * (e[:, None] * vj - hp.l_u * ui) * vmask * si_c
    dv = hp.a_v * d * (e[:, None] * ui - hp.l_v * vj) * vmask * sj_c
    # w_{j,k} ← w + γw(|R|^{-1/2}·e·(r_nb − b̄_nb) − λw·w) on explicit slots
    dw = ((aux["sR"][:, None] * e[:, None] * aux["resid"] - hp.l_w * wj)
          * bt.expl)
    dc = (aux["sN"][:, None] * e[:, None] - hp.l_c * cj) * bt.impl
    dw = hp.a_w * d * dw * vmask * sj_c
    dc = hp.a_c * d * dc * vmask * sj_c
    return db, dbh, du, dv, dw, dc


def mf_step(p: Params, bt: Batch, hp: Hyper, decay, bce: bool = False,
            conflict_free: bool = False) -> Params:
    """CUSGD++: u_i ← u_i + γ(e·v_j − λu·u_i), v symmetric (new Params)."""
    i, j = bt.i.long(), bt.j.long()
    e = _error(bt.r, predict_mf(p, bt), bce) * bt.valid
    ui, vj = p.U[i], p.V[j]
    _, _, si_c, sj_c = _batch_scales(p.U.shape[0], p.V.shape[0], bt,
                                     conflict_free, None)
    du, dv = _mf_deltas(bt, e, ui, vj, hp, decay, si_c, sj_c)
    return dataclasses.replace(p, U=scatter.index_add_det(p.U, i, du),
                               V=scatter.index_add_det(p.V, j, dv))


def mf_step_packed(pp: PackedParams, bt: Batch, hp: Hyper, decay,
                   bce: bool = False, conflict_free: bool = False,
                   scales=None) -> PackedParams:
    """CUSGD++ on the packed planes, in place: one gather and one scatter
    per side, U/V columns only.  Bit-identical to `mf_step`."""
    F = pp.F
    i, j = bt.i.long(), bt.j.long()
    ui = pp.row[i, :F]
    vj = pp.col[j, :F]
    e = _error(bt.r, (ui * vj).sum(1), bce) * bt.valid
    _, _, si_c, sj_c = _batch_scales(pp.row.shape[0], pp.col.shape[0], bt,
                                     conflict_free, scales)
    du, dv = _mf_deltas(bt, e, ui, vj, hp, decay, si_c, sj_c)
    scatter.index_add_det_(pp.row[:, :F], i, du)
    scatter.index_add_det_(pp.col[:, :F], j, dv)
    return pp


def culsh_batch_deltas(p: Params, bt: Batch, hp: Hyper, decay,
                       bce: bool = False, conflict_free: bool = False,
                       bh_nb: torch.Tensor | None = None):
    """The Eq. (5) step's scatter operands on the unpacked layout → (i, j,
    (db, dbh, du, dv, dw, dc)): the row deltas go to ids ``i``, the
    column deltas to ``j`` (`culsh_step` adds them; the online update
    masks them first)."""
    i, j = bt.i.long(), bt.j.long()
    pred, aux = predict(p, bt, bh_nb=bh_nb)
    e = _error(bt.r, pred, bce) * bt.valid
    si, sj, si_c, sj_c = _batch_scales(p.U.shape[0], p.V.shape[0], bt,
                                       conflict_free, None)
    return i, j, _culsh_deltas(
        bt, e, aux, p.b[i], p.bh[j], p.U[i], p.V[j], p.W[j], p.C[j], hp,
        decay, si, sj, si_c, sj_c)


def culsh_step(p: Params, bt: Batch, hp: Hyper, decay, bce: bool = False,
               conflict_free: bool = False,
               bh_nb: torch.Tensor | None = None) -> Params:
    """CULSH-MF: the fused Eq. (5) update of {b, b̂, U, V, W, C} (new
    Params, six scatters).  ``conflict_free`` promises each i and j at
    most once, making the summed scatter exactly the parallel Eq. (5)."""
    i, j, (db, dbh, du, dv, dw, dc) = culsh_batch_deltas(
        p, bt, hp, decay, bce, conflict_free, bh_nb)
    pi, pj = scatter.segment_plan(i), scatter.segment_plan(j)
    add = lambda t, ids, d, plan: scatter.index_add_det(t, ids, d, plan=plan)
    return dataclasses.replace(
        p, b=add(p.b, i, db, pi), bh=add(p.bh, j, dbh, pj),
        U=add(p.U, i, du, pi), V=add(p.V, j, dv, pj),
        W=add(p.W, j, dw, pj), C=add(p.C, j, dc, pj))


def culsh_step_packed(pp: PackedParams, bt: Batch, hp: Hyper, decay,
                      bce: bool = False, conflict_free: bool = False,
                      bh_nb: torch.Tensor | None = None,
                      scales=None) -> PackedParams:
    """CULSH-MF on the packed planes, in place: one [B, F+1] row-plane
    scatter and one [B, F+2K+1] col-plane scatter.  Bit-identical to
    `culsh_step`.  ``scales`` supplies precomputed (si, sj)."""
    F, K = pp.F, pp.K
    i, j = bt.i.long(), bt.j.long()
    row = pp.row[i]                                        # [B, F+1]
    col = pp.col[j]                                        # [B, F+2K+1]
    ui, b_i = row[:, :F], row[:, F]
    vj, wj = col[:, :F], col[:, F:F + K]
    cj, bh_j = col[:, F + K:F + 2 * K], col[:, F + 2 * K]
    bh_of_nb = pp.bh[bt.nb.long()] if bh_nb is None else bh_nb
    pred, aux = predict_gathered(pp.mu, b_i, bh_j, ui, vj, wj, cj,
                                 bh_of_nb, bt.rnb, bt.expl, bt.impl)
    e = _error(bt.r, pred, bce) * bt.valid
    si, sj, si_c, sj_c = _batch_scales(pp.row.shape[0], pp.col.shape[0], bt,
                                       conflict_free, scales)
    db, dbh, du, dv, dw, dc = _culsh_deltas(
        bt, e, aux, b_i, bh_j, ui, vj, wj, cj, hp, decay, si, sj, si_c, sj_c)
    scatter.index_add_det_(pp.row, i, torch.cat([du, db[:, None]], dim=1))
    scatter.index_add_det_(pp.col, j,
                           torch.cat([dv, dw, dc, dbh[:, None]], dim=1))
    return pp


def train_epoch(p: Params, sp: SparseMatrix, JK: torch.Tensor,
                key: torch.Tensor, epoch: int, hp: Hyper, *,
                batch: int = 4096, mf_only: bool = False,
                bce: bool = False) -> Params:
    """One epoch of shuffled mini-batches on the unpacked step → new
    Params (the legacy ``schedule="none"`` path).

    The general-case engine: per-batch `assemble` (a `lookup` per
    neighbour slot) and collision rescaling, correct for any batching;
    the batch order is `epoch_batches(key)`, the JAX package's.  Its
    scatters collide; `scatter.index_add_det_` adds them in index order,
    so an epoch is bit-reproducible on the card as on the CPU."""
    dev = sp.vals.device
    idx, valid = epoch_batches(key.to(dev), sp.nnz, batch)
    decay = lr_decay(hp, epoch, dev)
    step = mf_step if mf_only else culsh_step
    for bidx, bvalid in zip(idx, valid):
        p = step(p, assemble(sp, JK, bidx, bvalid), hp, decay, bce)
    return p


def _cf_scan(pp: PackedParams, sd: ScheduledData, starts: np.ndarray,
             valid: torch.Tensor, hp: Hyper, decay, hpv, *, width: int,
             mf_only: bool, bce: bool, conflict_free: bool,
             use_kernels: bool, scales=None,
             impl: str = "auto") -> PackedParams:
    """Run one schedule tier: batch k is the window at host offset
    ``starts[k]`` with mask ``valid[k]``.  A conflict-free tier with
    ``use_kernels`` goes through the fused step (CUSGD++ for ``mf_only``,
    else CULSH-MF) that ``impl`` picks (`kernels.pick`: the kernel
    wrapper, or its plain version with ``"ref"``), validated once per
    tier (on the card one launch per batch, no `Batch` built); everything
    else through the packed step."""
    if use_kernels and conflict_free:
        tier = pick(impl, pp.row.device,
                    *((mf_sgd_tier, mf_sgd_tier_ref) if mf_only
                      else (culsh_sgd_tier, culsh_sgd_tier_ref)))
        step = tier(pp, sd, valid, hpv, width=width, starts=starts, bce=bce)
        for k, s in enumerate(starts.tolist()):
            step(s, k)
        return pp
    packed = mf_step_packed if mf_only else culsh_step_packed
    for k, s in enumerate(starts.tolist()):
        sc = None if scales is None else (scales[0][k], scales[1][k])
        packed(pp, slice_batch(sd, s, width, valid[k]), hp, decay, bce,
               conflict_free=conflict_free, scales=sc)
    return pp


def train_epoch_scheduled(pp: PackedParams, sd: ScheduledData,
                          sched: EpochSchedule, key: torch.Tensor,
                          epoch: int, hp: Hyper, *, mf_only: bool = False,
                          bce: bool = False, use_kernels: bool = False,
                          impl: str = "auto") -> PackedParams:
    """One epoch over a tiered conflict-free schedule, updating ``pp`` in
    place (the offline hot path).

    Each width tier runs its batches in a per-epoch order, `prng.
    permutation(keys[2 + t])`, exactly the JAX package's; the leftover
    batches follow in the order of ``keys[1]`` on the scaled step, never
    through the kernels.  Batch order, tier starts and masks are drawn
    and permuted on the host once per epoch, so no step reads the device;
    the kernel hyper vector is built once per epoch on the device.  The
    block-aligned shard tier (``sched.shards > 1``) is not ported and
    raises.  ``impl`` picks the fused step of ``use_kernels`` (see
    `_cf_scan`)."""
    if sched.shard_span:
        raise NotImplementedError("the block-aligned shard tier is not "
                                  "ported; schedule with shards=1")
    dev = pp.row.device
    decay = lr_decay(hp, epoch, dev)
    hpv = None
    if use_kernels:
        hpv = (mf_hyper(hp, decay, dev) if mf_only
               else culsh_hyper(hp, decay, pp.mu))
    keys = prng.split(key, 2 + len(sched.tier_starts))
    kw = dict(mf_only=mf_only, bce=bce)
    on_dev = lambda a: torch.as_tensor(a, device=dev)
    for t, (starts, valid) in enumerate(zip(sched.tier_starts,
                                            sched.tier_valid)):
        if not starts.shape[0]:
            continue
        order = prng.permutation(keys[2 + t], starts.shape[0]).numpy()
        _cf_scan(pp, sd, starts[order], on_dev(valid[order]).float(), hp,
                 decay, hpv, width=sched.widths[t], conflict_free=True,
                 use_kernels=use_kernels, impl=impl, **kw)
    if sched.lo_starts.shape[0]:
        order = prng.permutation(keys[1], sched.lo_starts.shape[0]).numpy()
        _cf_scan(pp, sd, sched.lo_starts[order],
                 on_dev(sched.lo_valid[order]).float(), hp, decay, hpv,
                 width=sched.widths[0], conflict_free=False,
                 use_kernels=False,
                 scales=(on_dev(sched.lo_scale_i[order]),
                         on_dev(sched.lo_scale_j[order])), **kw)
    return pp
