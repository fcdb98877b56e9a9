"""Online learning for incremental data — paper Alg. 4
(`repro/core/online.py`).

New rows Ī and new columns J̄ arrive with interactions ΔΩ (new rows may
rate old *and* new columns).  The update:

  1. fold ΔΩ into the cached pre-sign accumulators S_j (old columns
     re-sign; new ones get fresh accumulators) —
     `simlsh.update_accumulators`;
  2. re-bucket → Top-K for the *new* columns over the whole set Ĵ (old
     columns keep their neighbours, per the paper);
  3. grow {U, b} by M̄ rows and {V, b̂, W, C} by N̄ columns;
  4. train only the new parameters on ΔΩ — the old ones are frozen (the
     paper's "remains unchanged"): each step's deltas are masked to ids
     ≥ the old sizes before they are scattered, so an old row is never
     written with anything but an exact zero.

Unlike the offline hot path this keeps the lookup `assemble` (neighbour
ratings come from Ω̂ via ``lookup_sp``) and the collision-scaled step (ΔΩ
batches are plain shuffles, not scheduler output).  The merged matrix is
maintained incrementally (`sparse.merge_coo`).

Every key is split as the JAX package splits it, so the same inputs give
the same batches, J^K and initial draws.  The colliding scatters go
through `scatter.index_add_det_`, which adds in index order on both
devices, so an update is bit-reproducible on the card as on the CPU (the
write-ahead log's replay, `resil.wal`, relies on it).

`micro_epoch` is the always-on loop's training unit: one scheduled epoch
over the merged Ω̂ that trains *all* parameters (`sgd.
train_epoch_scheduled` with its defaults, the plain packed steps).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs, prng
from repro_torch.core import scatter, simlsh, topk
from repro_torch.core.model import (Batch, Params, assemble,
                                    build_scheduled_data, pack_params,
                                    unpack_params)
from repro_torch.core.sgd import (Hyper, culsh_batch_deltas, lr_decay,
                                  train_epoch_scheduled)
from repro_torch.data.sparse import (SparseMatrix, conflict_free_schedule,
                                     epoch_batches, from_coo, merge_coo)
from repro_torch.resil.guard import (DivergenceError, GuardConfig,
                                     check_divergence)
from repro_torch.resil.validate import check_delta


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class OnlineState:
    params: Params
    S: torch.Tensor       # [q, N, p·G] simLSH accumulators
    JK: torch.Tensor      # [N, K]
    sp: SparseMatrix      # all interactions seen so far
    M: int
    N: int
    # the prng key the accumulators were *encoded* with — ΔΩ must be
    # hashed with the same Φ family, else new items land in random buckets
    hash_key: torch.Tensor | None = None
    # per-update bookkeeping from the last `online_update`, read back from
    # the obs spans
    stats: dict = dataclasses.field(default_factory=dict)


def grow_params(p: Params, M_new: int, N_new: int, key) -> Params:
    """Append M_new − M rows and N_new − N columns: U and V rows drawn
    ~ normal · 1/√F from the two keys split off ``key`` (the JAX
    package's draws, to a few ulp), b, b̂, W and C zero.  New tensors; the
    input's are untouched."""
    F, K = p.U.shape[1], p.W.shape[1]
    dM, dN = M_new - p.U.shape[0], N_new - p.V.shape[0]
    dev = p.U.device
    ku, kv = prng.split(key.to(dev))
    s = torch.tensor(np.float32(1.0) / np.sqrt(np.float32(F)), device=dev)
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
    return Params(
        U=torch.cat([p.U, s * prng.normal(ku, (dM, F))]),
        V=torch.cat([p.V, s * prng.normal(kv, (dN, F))]),
        b=torch.cat([p.b, z(dM)]), bh=torch.cat([p.bh, z(dN)]),
        W=torch.cat([p.W, z(dN, K)]), C=torch.cat([p.C, z(dN, K)]),
        mu=p.mu)


def masked_culsh_step(p: Params, bt: Batch, hp: Hyper, decay, M_old: int,
                      N_old: int) -> Params:
    """The Eq. (5) step that moves only the parameters of *new* rows and
    columns, on ``p``'s tensors in place (returns ``p``).

    It stays on the scaled (``conflict_free=False``) step: ΔΩ batches are
    plain shuffles, so a new row or column can repeat within a batch and
    the collision rescaling matters.  Each delta whose id is old is
    replaced by an exact zero (`torch.where`, so a non-finite delta
    cannot reach a frozen row) before the scatter: the new rows get the
    JAX package's ``old + m·(new − old)`` values up to rounding, and no
    old row changes."""
    i, j, (db, dbh, du, dv, dw, dc) = culsh_batch_deltas(
        p, bt, hp, decay, conflict_free=False)
    new_i = (i >= M_old)[:, None]
    new_j = (j >= N_old)[:, None]
    keep = lambda d, m: torch.where(m, d, torch.zeros((), device=d.device))
    pi, pj = scatter.segment_plan(i), scatter.segment_plan(j)
    add = scatter.index_add_det_
    add(p.U, i, keep(du, new_i), plan=pi)
    add(p.b, i, keep(db, new_i[:, 0]), plan=pi)
    add(p.V, j, keep(dv, new_j), plan=pj)
    add(p.bh, j, keep(dbh, new_j[:, 0]), plan=pj)
    add(p.W, j, keep(dw, new_j), plan=pj)
    add(p.C, j, keep(dc, new_j), plan=pj)
    return p


def online_update(st: OnlineState, new_rows, new_cols, new_vals,
                  cfg: simlsh.SimLSHConfig, hp: Hyper, key, *,
                  M_new: int, N_new: int, K: int, epochs: int = 3,
                  batch: int = 4096,
                  guard: GuardConfig | None = GuardConfig(),
                  registry: obs.Registry | None = None) -> OnlineState:
    """Alg. 4 end to end.  ``new_*`` are the ΔΩ triples in the grown id
    space (numpy arrays or tensors); the new state lives on the device of
    ``st``'s parameters.

    The stages are nested obs spans under ``online.update`` (``resign``,
    ``merge``, ``topk``, ``train``), which `OnlineState.stats` reads back.
    The ΔΩ triples are validated first: a poison batch (NaN values,
    negative or out-of-range ids, shrinking M/N) raises `PoisonBatchError`
    before any state is touched.  After training, ``guard`` checks the
    grown slices; a trip raises `DivergenceError` before the new state is
    built, so the caller's ``st`` is the rollback."""
    if st.hash_key is None:
        raise ValueError(
            "OnlineState.hash_key is unset — pass the key the accumulators "
            "were encoded with (FitResult.hash_key), else ΔΩ is hashed with "
            "a different Φ family and incremental signatures are garbage")
    check_delta(new_rows, new_cols, new_vals,
                M_new=M_new, N_new=N_new, M_old=st.M, N_old=st.N)
    reg = registry if registry is not None else obs.scoped()
    dev = st.params.U.device
    k_grow, k_topk, k_train = prng.split(key, 3)
    as_dev = lambda a, t: torch.as_tensor(a).to(device=dev, dtype=t)
    rows, cols, vals = (as_dev(new_rows, torch.int32),
                        as_dev(new_cols, torch.int32),
                        as_dev(new_vals, torch.float32))
    delta = from_coo(rows, cols, vals, (M_new, N_new), device=dev)

    with reg.span("online.update"):
        # (1)(2) incremental hashing + re-sign — lines 1–6 (same Φ family)
        with reg.span("online.resign"):
            S2, sigs = simlsh.update_accumulators(
                st.S, rows, cols, vals, cfg, st.hash_key, N_new)
            _sync(dev)

        with reg.span("online.merge"):
            sp_all = merge_coo(st.sp, rows, cols, vals, (M_new, N_new))
            _sync(dev)

        # (3) Top-K: old columns keep their lists; new ones search Ĵ
        with reg.span("online.topk"):
            JK = st.JK
            if N_new > st.N:
                JK_all = topk.topk_from_signatures(
                    sigs, k_topk.to(dev), K=K, band_cap=cfg.band_cap)
                JK = torch.cat([st.JK, JK_all[st.N:]], dim=0)
            _sync(dev)

        # (4)(5) train only the new parameters on ΔΩ — lines 10–15
        with reg.span("online.train"):
            p = grow_params(st.params, M_new, N_new, k_grow)
            for ep in range(epochs):
                idx, valid = epoch_batches(
                    prng.fold_in(k_train, ep).to(dev), delta.nnz,
                    min(batch, delta.nnz))
                decay = lr_decay(hp, ep, dev)
                for bidx, bvalid in zip(idx, valid):
                    # bidx indexes ΔΩ's own triples; the neighbour ratings
                    # come from the merged Ω̂
                    bt = assemble(delta, JK, bidx, bvalid, lookup_sp=sp_all)
                    masked_culsh_step(p, bt, hp, decay, st.M, st.N)
            _sync(dev)

        if guard is not None:
            probs = check_divergence(p, st.params, M_old=st.M, N_old=st.N,
                                     cfg=guard)
            if probs:
                reg.counter_add("online.guard_trips")
                raise DivergenceError(
                    "online update rolled back — trained parameters "
                    "diverged: " + "; ".join(probs))

    reg.counter_add("online.updates")
    reg.counter_add("online.delta_nnz", delta.nnz)
    reg.event("online.update", delta_nnz=delta.nnz, merged_nnz=sp_all.nnz,
              M_new=M_new, N_new=N_new, new_cols=N_new - st.N,
              new_rows=M_new - st.M)
    last = lambda name: reg.span_durations(name)[-1]
    return OnlineState(params=p, S=S2, JK=JK, sp=sp_all, M=M_new, N=N_new,
                       hash_key=st.hash_key,
                       stats=dict(merge_seconds=last("online.merge"),
                                  resign_seconds=last("online.resign"),
                                  topk_seconds=last("online.topk"),
                                  train_seconds=last("online.train"),
                                  update_seconds=last("online.update"),
                                  delta_nnz=delta.nnz,
                                  merged_nnz=sp_all.nnz))


# ---------------------------------------------------------------------------
# micro-epochs over the merged Ω̂ — the always-on loop's training workload
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MicroSchedule:
    """Conflict-free schedule and schedule-ordered data for micro-epochs
    over one merged Ω̂.  Valid only for the exact `SparseMatrix` it was
    built from (``sp`` is the cache token: Ω̂ changes identity on every
    merge).  Deterministic given (sp, batch, seed)."""
    sched: object          # data.sparse.EpochSchedule
    sd: object             # model.ScheduledData
    sp: SparseMatrix
    batch: int
    seed: int


def build_micro_schedule(sp: SparseMatrix, JK: torch.Tensor, *,
                         batch: int = 4096, seed: int = 0) -> MicroSchedule:
    """Schedule the merged matrix for `micro_epoch` (one device: the loop
    shares it with serving)."""
    sched = conflict_free_schedule(
        sp.rows.cpu().numpy(), sp.cols.cpu().numpy(),
        batch=min(batch, max(sp.nnz, 1)), shards=0, M=sp.M, N=sp.N,
        seed=seed)
    sd = build_scheduled_data(sp, JK, sched)
    return MicroSchedule(sched=sched, sd=sd, sp=sp, batch=batch, seed=seed)


def micro_epoch(st: OnlineState, hp: Hyper, key, *, epoch: int = 0,
                sched: MicroSchedule | None = None, batch: int = 4096,
                registry: obs.Registry | None = None) -> OnlineState:
    """One scheduled training epoch over the merged Ω̂ that continues
    training *all* parameters (unlike `online_update`, which freezes the
    old ones), through `sgd.train_epoch_scheduled` on the plain packed
    steps.  S, J^K and Ω̂ are untouched (training moves no ids), so the
    returned state shares them with ``st``; ``st.params`` is unchanged
    (the epoch trains fresh packed planes)."""
    reg = registry if registry is not None else obs.scoped()
    dev = st.params.U.device
    if sched is None or sched.sp is not st.sp:
        with reg.span("online.micro.schedule"):
            sched = build_micro_schedule(st.sp, st.JK, batch=batch)
            _sync(dev)
    with reg.span("online.micro"):
        pp = train_epoch_scheduled(pack_params(st.params), sched.sd,
                                   sched.sched, key.cpu(), epoch, hp)
        p = unpack_params(pp)
        _sync(dev)
    reg.counter_add("online.micro_epochs")
    return OnlineState(params=p, S=st.S, JK=st.JK, sp=st.sp, M=st.M, N=st.N,
                       hash_key=st.hash_key,
                       stats=dict(st.stats,
                                  micro_seconds=reg.span_durations(
                                      "online.micro")[-1]))
