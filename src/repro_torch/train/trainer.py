"""End-to-end trainer for CULSH-MF (`repro/train/trainer.py`) on the
conflict-free schedule.

Wires the pipeline of paper Fig. 2:
  R (COO) → simLSH signatures (Eq. 3) → bucket Top-K J^K → tiered
  conflict-free schedule → packed-plane Eq. (5) SGD epochs → RMSE.

Every random draw comes from `repro_torch.prng` keys split exactly as the
JAX package splits them, so the same seed gives the same signatures,
J^K, schedule and batch order.  ``schedule="none"`` is the legacy
per-batch-search path (`sgd.train_epoch`, `model.rmse`); ``ckpt_dir``
resumes from the newest complete checkpoint and, with ``ckpt_every``,
saves one every that many epochs (`train/checkpoint.py`).  ``method``
picks the neighbour search: simLSH, or one of the paper's comparators
(exact GSM, random-K, RP_cos, minHash; `core/gsm.py`,
`core/baselines.py`), each feeding its J^K into the same epochs.
``shards`` > 1 gives the schedule a block-aligned D×D tier that trains
over a shard mesh of D devices (`launch.mesh`; logical shards of one
device where ``REPRO_TORCH_LOGICAL_DEVICES`` allows them), with the
parameters in the schedule's block-padded id space.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import obs, prng
from repro_torch.core import baselines, gsm, model, sgd, simlsh, topk
from repro_torch.data.sparse import (SparseMatrix, conflict_free_schedule,
                                     from_coo)
from repro_torch.device import resolve_device
from repro_torch.kernels import IMPLS, _build
from repro_torch.launch.mesh import device_count, make_shard_mesh
from repro_torch.train import checkpoint as ckpt


@dataclasses.dataclass
class FitConfig:
    F: int = 32
    K: int = 32
    epochs: int = 12
    batch: int = 4096
    method: str = "simlsh"      # simlsh | gsm | rand | rp_cos | minhash
                                # | none (plain MF)
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
    shards: int | str = "auto"   # block-aligned shard tier: 'auto' = the
                                 # device count (`launch.mesh.
                                 # device_count`); clamped to the count,
                                 # M and N; 1 = no shard tier
    use_kernels: bool = False    # conflict-free batches through the fused
                                 # kernels/mf_sgd step (its plain version
                                 # on CPU tensors)
    kernel_impl: str = "auto"    # auto | cuda | ref (`kernels.pick`):
                                 # auto launches the kernel on the card,
                                 # ref runs its plain version anywhere

    def __post_init__(self):
        if self.kernel_impl not in IMPLS:
            raise ValueError(f"kernel_impl must be one of {IMPLS} (the "
                             f"kernels are CUDA), got {self.kernel_impl!r}")


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
    compile_seconds: float = 0.0    # building/loading the kernel library
                                    # inside this fit (0.0 when already
                                    # loaded, or on the CPU)
    schedule_stats: dict | None = None
    registry: obs.Registry | None = None  # every timing above is read
                                          # from its spans


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_neighbours(sp: SparseMatrix, cfg: FitConfig, key):
    """Neighbour search → (JK or None, S or None, signature key)."""
    k_sig, k_top = prng.split(key)
    S = None
    if cfg.method == "none":
        return None, None, k_sig
    if cfg.method == "simlsh":
        sigs, S = simlsh.encode(sp, cfg.lsh, k_sig, return_accumulators=True)
        JK = topk.topk_from_signatures(sigs, k_top, K=cfg.K,
                                       band_cap=cfg.lsh.band_cap)
    elif cfg.method == "gsm":
        JK = gsm.gsm_topk(sp, K=cfg.K)
    elif cfg.method == "rand":
        JK = baselines.rand_topk(k_top, sp.N, cfg.K, device=sp.rows.device)
    elif cfg.method in ("rp_cos", "minhash"):
        signatures = (baselines.rp_cos_signatures if cfg.method == "rp_cos"
                      else baselines.minhash_signatures)
        JK = baselines.signatures_topk(signatures(sp, cfg.lsh, k_sig),
                                       k_top, K=cfg.K,
                                       band_cap=cfg.lsh.band_cap)
    else:
        raise ValueError(f"unknown method {cfg.method}")
    return JK, S, k_sig


def fit(train_coo, test_coo, shape, cfg: FitConfig,
        log: Callable[[str], None] | None = None,
        registry: obs.Registry | None = None, device=None) -> FitResult:
    """Fit CULSH-MF (or plain MF with ``method="none"``) on the COO
    triples ``train_coo`` and report the test RMSE of ``test_coo`` after
    every ``eval_every`` epochs.  Runs on ``cuda`` unless ``device`` says
    otherwise.  All timings are read back from the obs registry's spans
    (the shared registry when enabled, else a private one)."""
    if cfg.schedule not in ("auto", "conflict_free", "none"):
        raise ValueError(f"unknown schedule {cfg.schedule}")
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
    # the shard tier trains over a mesh only when D > 1 devices exist
    n_dev = device_count(dev)
    shards = n_dev if cfg.shards == "auto" else int(cfg.shards)
    shards = max(1, min(shards, n_dev, sp.M, sp.N))
    mesh = make_shard_mesh(shards, dev) if scheduled and shards > 1 else None

    # once-per-fit precomputation of the scheduled path: the tiered
    # conflict-free schedule, the schedule-ordered data and the eval cache
    prep_secs = 0.0
    sched_stats = None
    ec = None
    shd = None
    if scheduled:
        with reg.span("train.prep"):
            with reg.span("train.prep.schedule"):
                sched = conflict_free_schedule(
                    sp.rows.cpu().numpy(), sp.cols.cpu().numpy(),
                    batch=min(cfg.cf_batch, cfg.batch), tiers=cfg.tiers,
                    tier_shrink=cfg.tier_shrink,
                    min_fill_frac=cfg.min_fill_frac, shards=shards, M=sp.M,
                    N=sp.N, seed=cfg.seed)
            with reg.span("train.prep.pack"):
                sd = model.build_scheduled_data(sp, JK, sched,
                                                mf_only=mf_only)
                shd = model.build_shard_data(sp, JK, sched, mf_only=mf_only)
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
        # the training state lives in the schedule's block-padded id space
        # (the identity on one shard); the public Params at eval,
        # checkpoint and result
        state = model.pack_params(model.remap_params(params, sched))
        to_public = lambda q: model.unmap_params(model.unpack_params(q),
                                                 sched)
        run = lambda q, ep: sgd.train_epoch_scheduled(
            q, sd, sched, prng.fold_in(k_ep, ep), ep, cfg.hp, shd=shd,
            mf_only=mf_only, bce=bce, use_kernels=cfg.use_kernels,
            impl=cfg.kernel_impl, mesh=mesh)
    else:
        state = params
        to_public = lambda q: q
        run = lambda q, ep: sgd.train_epoch(
            q, sp, JK, prng.fold_in(k_ep, ep), ep, cfg.hp, batch=cfg.batch,
            mf_only=mf_only, bce=bce)

    # the kernel library is built and loaded on first use; do it here, so
    # its seconds land in compile_seconds and not in the first epoch
    compile_secs = 0.0
    if (scheduled and cfg.use_kernels and cfg.kernel_impl != "ref"
            and dev.type == "cuda" and not _build.loaded()):
        with reg.span("train.compile"):
            _build.library()
        compile_secs = reg.span_durations("train.compile")[-1]

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
                     compile_seconds=compile_secs,
                     schedule_stats=sched_stats, registry=reg)
