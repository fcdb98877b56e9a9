"""End-to-end trainer for CULSH-MF (`repro/train/trainer.py`), single
device, on the conflict-free schedule.

Wires the pipeline of paper Fig. 2:
  R (COO) → simLSH signatures (Eq. 3) → bucket Top-K J^K → tiered
  conflict-free schedule → packed-plane Eq. (5) SGD epochs → RMSE.

Every random draw comes from `repro_torch.prng` keys split exactly as the
JAX package splits them, so the same seed gives the same signatures,
J^K, schedule and batch order.  ``schedule="none"`` is the legacy
per-batch-search path (`sgd.train_epoch`, `model.rmse`); ``ckpt_dir``
resumes from the newest complete checkpoint and, with ``ckpt_every``,
saves one every that many epochs (`train/checkpoint.py`).  The
comparator neighbour methods and more than one shard raise
`NotImplementedError`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import obs, prng
from repro_torch.core import model, sgd, simlsh, topk
from repro_torch.data.sparse import (SparseMatrix, conflict_free_schedule,
                                     from_coo)
from repro_torch.device import resolve_device
from repro_torch.train import checkpoint as ckpt

UNPORTED_METHODS = ("gsm", "rand", "rp_cos", "minhash")


@dataclasses.dataclass
class FitConfig:
    F: int = 32
    K: int = 32
    epochs: int = 12
    batch: int = 4096
    method: str = "simlsh"      # simlsh | none (plain MF); the JAX
                                # package's gsm | rand | rp_cos | minhash
                                # are not ported
    lsh: simlsh.SimLSHConfig = dataclasses.field(
        default_factory=simlsh.SimLSHConfig)
    hp: sgd.Hyper = dataclasses.field(default_factory=sgd.Hyper)
    seed: int = 0
    ckpt_dir: str | None = None
    ckpt_every: int = 0          # epochs; 0 = off
    eval_every: int = 1
    loss: str = "l2"             # l2 | bce (implicit feedback, paper §5.4)
    schedule: str = "auto"       # auto | conflict_free | none — 'none' is
                                 # the legacy per-batch-search path
    cf_batch: int = 512          # conflict-free batch width
    tiers: int = 4               # schedule width tiers
    tier_shrink: float = 0.5     # tier width ratio
    min_fill_frac: float = 0.5   # last-tier re-pack threshold
    shards: int | str = "auto"   # 'auto' = 1 here (single device)
    use_kernels: bool = False    # conflict-free batches through the fused
                                 # kernels/mf_sgd step (its plain version
                                 # on CPU tensors)


@dataclasses.dataclass
class FitResult:
    params: model.Params
    JK: torch.Tensor | None
    history: list            # [(epoch, seconds, rmse)] — seconds are the
                             # accumulated `train.epoch` span times
    neighbour_seconds: float
    S: torch.Tensor | None = None   # simLSH accumulators (online cache)
    hash_key: torch.Tensor | None = None  # the key S was encoded with
    prep_seconds: float = 0.0       # schedule + schedule-ordered data +
                                    # eval cache
    schedule_stats: dict | None = None
    registry: obs.Registry | None = None  # every timing above is read
                                          # from its spans


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_neighbours(sp: SparseMatrix, cfg: FitConfig, key):
    """Neighbour search → (JK or None, S or None, signature key)."""
    k_sig, k_top = prng.split(key)
    if cfg.method == "none":
        return None, None, k_sig
    if cfg.method in UNPORTED_METHODS:
        raise NotImplementedError(f"method={cfg.method!r} is not ported; "
                                  f"use 'simlsh' or 'none'")
    if cfg.method != "simlsh":
        raise ValueError(f"unknown method {cfg.method}")
    sigs, S = simlsh.encode(sp, cfg.lsh, k_sig, return_accumulators=True)
    JK = topk.topk_from_signatures(sigs, k_top, K=cfg.K,
                                   band_cap=cfg.lsh.band_cap)
    return JK, S, k_sig


def _check_ported(cfg: FitConfig) -> None:
    if cfg.schedule not in ("auto", "conflict_free", "none"):
        raise ValueError(f"unknown schedule {cfg.schedule}")
    if cfg.shards != "auto" and int(cfg.shards) > 1:
        raise NotImplementedError("more than one shard (the block-rotation "
                                  "tier) is not ported")


def fit(train_coo, test_coo, shape, cfg: FitConfig,
        log: Callable[[str], None] | None = None,
        registry: obs.Registry | None = None, device=None) -> FitResult:
    """Fit CULSH-MF (or plain MF with ``method="none"``) on the COO
    triples ``train_coo`` and report the test RMSE of ``test_coo`` after
    every ``eval_every`` epochs.  Runs on ``cuda`` unless ``device`` says
    otherwise.  All timings are read back from the obs registry's spans
    (the shared registry when enabled, else a private one)."""
    _check_ported(cfg)
    dev = resolve_device(device)
    reg = registry if registry is not None else obs.scoped()
    key = prng.PRNGKey(cfg.seed)
    k_nb, k_init, k_ep = prng.split(key, 3)
    sp = from_coo(*train_coo, shape, device=dev)
    te_r, te_c, te_v = (torch.as_tensor(a, dtype=t, device=dev) for a, t in
                        zip(test_coo, (torch.int32, torch.int32,
                                       torch.float32)))

    with reg.span("train.neighbours"):
        JK, S, k_sig = build_neighbours(sp, cfg, k_nb)
        _sync(dev)
    nb_secs = reg.span_durations("train.neighbours")[-1]
    mf_only = cfg.method == "none"
    if JK is None:  # plain MF: a placeholder J^K for the data layout
        JK = torch.zeros((sp.N, cfg.K), dtype=torch.int32, device=dev)

    params = model.init_from_data(k_init, sp, cfg.F, cfg.K)
    start_epoch = 0
    if cfg.ckpt_dir:
        restored = ckpt.try_restore(cfg.ckpt_dir, params)
        if restored is not None:
            params, start_epoch = restored
    scheduled = cfg.schedule != "none"
    bce = cfg.loss == "bce"

    # once-per-fit precomputation of the scheduled path: the tiered
    # conflict-free schedule, the schedule-ordered data and the eval cache
    prep_secs = 0.0
    sched_stats = None
    ec = None
    if scheduled:
        with reg.span("train.prep"):
            with reg.span("train.prep.schedule"):
                sched = conflict_free_schedule(
                    sp.rows.cpu().numpy(), sp.cols.cpu().numpy(),
                    batch=min(cfg.cf_batch, cfg.batch), tiers=cfg.tiers,
                    tier_shrink=cfg.tier_shrink,
                    min_fill_frac=cfg.min_fill_frac, shards=1, M=sp.M,
                    N=sp.N, seed=cfg.seed)
            with reg.span("train.prep.pack"):
                sd = model.build_scheduled_data(sp, JK, sched,
                                                mf_only=mf_only)
                _sync(dev)
            if cfg.eval_every:
                with reg.span("train.prep.eval_cache"):
                    ec = model.build_eval_cache(sp, JK, te_r, te_c,
                                                mf_only=mf_only)
                    _sync(dev)
        prep_secs = reg.span_durations("train.prep")[-1]
        sched_stats = dict(
            sched.stats(), prep_sec=prep_secs,
            prep_per_epoch=prep_secs / max(cfg.epochs - start_epoch, 1))
        if log:
            log(f"schedule: {sched_stats['nb_cf']} cf + "
                f"{sched_stats['nb_lo']} leftover batches "
                f"(cf_frac={sched_stats['cf_frac']:.2f}, "
                f"fill={sched_stats['fill']:.2f}, prep={prep_secs:.2f}s)")
        state = model.pack_params(params)
        to_public = model.unpack_params
        run = lambda q, ep: sgd.train_epoch_scheduled(
            q, sd, sched, prng.fold_in(k_ep, ep), ep, cfg.hp,
            mf_only=mf_only, bce=bce, use_kernels=cfg.use_kernels)
    else:
        state = params
        to_public = lambda q: q
        run = lambda q, ep: sgd.train_epoch(
            q, sp, JK, prng.fold_in(k_ep, ep), ep, cfg.hp, batch=cfg.batch,
            mf_only=mf_only, bce=bce)

    history = []
    t_train = 0.0
    for ep in range(start_epoch, cfg.epochs):
        with reg.span("train.epoch"):
            state = run(state, ep)
            _sync(dev)
        t_train += reg.span_durations("train.epoch")[-1]
        reg.counter_add("train.epochs")
        if cfg.eval_every and (ep + 1) % cfg.eval_every == 0:
            with reg.span("train.epoch.eval"):
                p_eval = to_public(state)
                if ec is not None:  # per-epoch eval from the cached gathers
                    r = float(model.rmse_cached(p_eval, ec, te_r, te_c, te_v,
                                                mf_only=mf_only))
                else:
                    r = float(model.rmse(p_eval, sp, JK, te_r, te_c, te_v,
                                         mf_only=mf_only))
            history.append((ep, t_train, r))
            reg.event("train.eval", epoch=ep, t_train=t_train, rmse=r)
            if log:
                log(f"epoch {ep:3d}  t={t_train:7.2f}s  rmse={r:.4f}")
        if cfg.ckpt_dir and cfg.ckpt_every and (ep + 1) % cfg.ckpt_every == 0:
            with reg.span("train.ckpt"):
                ckpt.save(cfg.ckpt_dir, to_public(state), step=ep + 1)
    ckpt.wait()

    return FitResult(to_public(state), JK, history, nb_secs, S,
                     hash_key=k_sig, prep_seconds=prep_secs,
                     schedule_stats=sched_stats, registry=reg)
