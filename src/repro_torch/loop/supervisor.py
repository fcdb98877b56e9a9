"""The always-on supervisor: serve / train / drift / publish, one device
(`repro/loop/supervisor.py`).

`OnlineLoop` runs the paper's online claim as a single cooperative
process.  Time is cut into **slices**; each slice walks a fixed state
machine over the one device budget:

    serve ─→ train ─→ drift ─→ publish ─→ checkpoint ─→ watchdog
      │        │        │         │           │
      │        │        │         │           └ every ckpt_every slices:
      │        │        │         │             atomic progress cut + WAL prune
      │        │        │         └ bounded staleness: push the trained
      │        │        │           state into the service when the
      │        │        │           serve-behind-train lag or wall-clock
      │        │        │           staleness crosses its cap
      │        │        └ every drift_every slices: held-out RMSE window;
      │        │          a trip publishes + rebuilds the index
      │        └ apply queued ΔΩ + bounded micro-epochs (skipped under
      │          ingest backpressure), one atomic WAL "slice" entry
      └ at most serve_flushes micro-batches, then every flush in flight
        synced — the explicit phase hand-off of one device budget

Crash safety is the design center.  A slice's mutations — the ΔΩ deltas
it applies and the micro-epochs it runs — are logged as **one** WAL
entry *before* they are applied (append-then-apply, the
`resil.wal.OnlineUpdater` discipline), so at every kill point the log
covers at least the in-memory state.  The entry is the slice's atomic
unit on both sides:

  * **live**: the slice-boundary divergence guard (a diverging
    micro-epoch rolls back the *slice*, not one update) rejects the
    whole entry — ``updater.state`` is left exactly the pre-slice
    `OnlineState` object, the seq still advances;
  * **replay**: `recover()` re-runs the entry through the same
    `_apply_slice` — same state, same triples, same keys, same epoch
    cursor, and every colliding scatter added in index order
    (`core.scatter.index_add_det_`, on the card as on the CPU) — so
    guard trips re-trip identically and the recovered state is
    **bit-identical** to an uninterrupted run on the same device.

Loop progress (slice counter, micro-epoch cursor) rides in the same
crash-atomic checkpoint as the model state (``loop_slice`` /
``loop_micro`` int64 leaves next to `wal.state_tree`), cut at the
current WAL seq — the pending-delta watermark — so resume starts from a
consistent (state, log, cursor) triple.  The loop owns the checkpoint
cadence: the embedded updater's own periodic checkpoints are disabled
(they would write a state-only tree the loop template cannot restore).

The files are the JAX package's: a slice entry holds ``mkey`` (the
micro-epochs' key as ``uint32[2]`` words) and ``d{i}_rows`` /
``d{i}_cols`` / ``d{i}_vals`` / ``d{i}_key`` per delta beside the same
``__meta__`` fields, and the checkpoint tree has the same leaves in the
same order, so a loop directory either package wrote recovers in the
other.

Failure handling is degrade-not-die: a failed or stalled slice trips
the watchdog and the loop serves the **frozen** model for
``freeze_slices`` slices (training suspended, serving answers from the
last published params) instead of exiting.  The three fault sites in
the loop body — ``loop.slice`` / ``loop.drift`` / ``loop.ckpt`` — are
pure crash windows: no state mutation is in flight at any of them, which
is what makes a kill there recoverable bit-identically.

The state lives where the updater's `OnlineState` does (the card unless
the caller built it on the CPU); `build_service` serves on that device.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch import obs, prng
from repro_torch.core import model, simlsh
from repro_torch.core.online import (OnlineState, build_micro_schedule,
                                     micro_epoch, online_update)
from repro_torch.device import resolve_device
from repro_torch.resil import faults
from repro_torch.resil.guard import (DivergenceError, GuardConfig,
                                     check_divergence)
from repro_torch.resil.validate import PoisonBatchError, check_delta
from repro_torch.resil.wal import (OnlineUpdater, _key_tensor, _template,
                                   key_words, state_from_tree, state_tree)
from repro_torch.serve import index as lsh_index
from repro_torch.serve.service import RecsysService, ServeConfig
from repro_torch.train import checkpoint


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    """Slice scheduler knobs.  Defaults target the bench/test scale;
    production tunes ``serve_flushes``/``micro_epochs`` to the actual
    flush-vs-epoch cost ratio on the device."""
    serve_flushes: int = 2       # micro-batches dispatched per slice
    micro_epochs: int = 1        # scheduled training rounds per slice
    micro_batch: int = 4096      # schedule batch for the micro-epochs
    deltas_per_slice: int = 4    # ΔΩ updates applied per slice (the rest
                                 # stay queued → backpressure)
    backpressure_queue: int = 4  # queue depth at which micro-epochs are
                                 # skipped in favour of draining ΔΩ
    max_lag: int = 2             # publish after this many unpublished
                                 # slice mutations (serve-behind-train cap)
    max_staleness_s: float = 30.0  # …or after this much wall-clock
    ckpt_every: int = 2          # slices between atomic progress cuts
    drift_every: int = 2         # slices between held-out RMSE probes
    drift_window: int = 8        # RMSE window the trip compares against
    drift_tol: float = 0.10      # trip when rmse > (1+tol) × window min
    watchdog_s: float = 60.0     # slice wall-time budget before freezing
    freeze_slices: int = 2       # slices served frozen after a trip
    tail_cap: int = 128          # index tail for `build_service`
    seed: int = 0                # micro-epoch PRNG stream (keys are
                                 # WAL-logged, so replay never re-derives)


def _loop_template() -> dict:
    """Checkpoint structure: the state tree + the loop cursors.  Loop
    checkpoints and `wal._template` ones are not interchangeable — the
    leaf sets differ — which is why the loop disables the updater's own
    cadence and owns every checkpoint under its root."""
    return dict(_template(), loop_slice=0, loop_micro=0)


def _slice_guard(p_new, p_old, guard: GuardConfig) -> None:
    """Slice-boundary divergence check: the micro-epochs train *all*
    params (not just grown slices), so compare whole-param RMS
    (``M_old=N_old=0``) against the pre-micro scale."""
    probs = check_divergence(p_new, p_old, M_old=0, N_old=0, cfg=guard)
    if probs:
        raise DivergenceError(
            "slice-boundary guard tripped after micro-epochs — slice "
            "rolled back: " + "; ".join(probs))


def _apply_slice(state: OnlineState, deltas: list, *, rounds: int,
                 epoch0: int, mkey, lsh, hp, K: int, epochs: int,
                 batch: int, micro_batch: int,
                 guard: GuardConfig | None,
                 registry: obs.Registry | None = None, sched=None):
    """One slice's training work, shared verbatim by the live path and
    WAL replay (the replay contract *is* this function).

    ``deltas`` is ``[(rows, cols, vals, key_words, M_new, N_new), ...]``
    — already validated (poison batches are quarantined before logging);
    ``mkey`` is the micro-epochs' key as ``uint32[2]`` words.  Applies
    each ΔΩ through `online_update` (per-delta guard trips are
    replay-stable rejections, counted and skipped), then runs ``rounds``
    micro-epochs over the merged Ω̂ from the logged key/epoch cursor,
    then the slice-boundary guard.  Raises `DivergenceError` with the
    caller's ``state`` untouched; returns ``(new_state, sched)`` with
    the (possibly rebuilt) micro schedule for reuse while Ω̂ is stable.
    """
    reg = registry if registry is not None else obs.scoped()
    st = state
    for (r, c, v, k, M_new, N_new) in deltas:
        try:
            st = online_update(st, r, c, v, lsh, hp, _key_tensor(k),
                               M_new=int(M_new), N_new=int(N_new), K=K,
                               epochs=epochs, batch=batch, guard=guard,
                               registry=reg)
        except DivergenceError:
            reg.counter_add("resil.guard_trips")
    if rounds:
        if sched is None or sched.sp is not st.sp:
            sched = build_micro_schedule(st.sp, st.JK, batch=micro_batch)
        pre = st
        key = _key_tensor(mkey)
        for i in range(rounds):
            st = micro_epoch(st, hp, prng.fold_in(key, i), epoch=epoch0 + i,
                             sched=sched, batch=micro_batch, registry=reg)
        if guard is not None:
            _slice_guard(st.params, pre.params, guard)
    return st, sched


class OnlineLoop:
    """Cooperative serve/train supervisor over one `OnlineUpdater` (the
    crash-safe state) and one single-device `RecsysService` (the request
    plane).  See the module docstring for the slice state machine.

    The loop takes ownership of the updater's persistence root: its
    periodic checkpoints are disabled (``ckpt_every`` → ∞) and every
    durable cut goes through `OnlineLoop.checkpoint` so restore always
    sees the loop template.  Direct `updater.update()` calls between
    slices remain safe (same WAL, same seq space) but `recover()` must
    then replay them too — which it does, dispatching on entry kind.
    """

    def __init__(self, updater: OnlineUpdater, service: RecsysService,
                 cfg: LoopConfig = LoopConfig(), *, holdout=None,
                 registry: obs.Registry | None = None,
                 _slice: int = 0, _micro: int = 0):
        if service._shard_state is not None:
            raise ValueError(
                "OnlineLoop needs a single-device RecsysService — sharded "
                "serving is read-only (ShardedIngestUnsupported) and cannot "
                "adopt published states; run the loop on a shards=0 service "
                "and rebuild the sharded tier from its checkpoints")
        self.updater = updater
        self.svc = service
        self.cfg = cfg
        self.holdout = holdout          # (rows, cols, vals) held-out stream
        self.obs = registry if registry is not None else obs.scoped()
        # the loop owns the checkpoint cadence (loop template, see above)
        self.updater.ckpt_every = 10 ** 9
        self._slice = _slice            # completed-slice counter
        self._micro = _micro            # micro-epoch cursor (lr schedule)
        self._deltas: collections.deque = collections.deque()
        self._sched = None              # cached MicroSchedule for stable Ω̂
        self._frozen = 0                # slices left in frozen-model serving
        self._lag = 0                   # applied-but-unpublished mutations
        self._stale_t0: float | None = None
        self._published_N = int(service.params.V.shape[0])
        self._drift_rmse: collections.deque = collections.deque(
            maxlen=cfg.drift_window)

    # ---- public surface ---------------------------------------------------

    @property
    def state(self) -> OnlineState:
        return self.updater.state

    @property
    def slice_count(self) -> int:
        return self._slice

    def staleness_s(self) -> float:
        """Wall-clock age of the oldest applied-but-unpublished mutation
        (0.0 when serving is fully caught up with training)."""
        return (0.0 if self._stale_t0 is None
                else time.perf_counter() - self._stale_t0)

    def offer_delta(self, rows, cols, vals, key, *, M_new: int,
                    N_new: int) -> None:
        """Queue a ΔΩ batch for the next train phase (host-side, never
        blocks the serve phase).  ``key`` is a port key or the JAX
        package's ``uint32[2]`` words; it is queued, and logged, as the
        words.  Depth feeds backpressure."""
        host = lambda a: (a.cpu().numpy() if isinstance(a, torch.Tensor)
                          else np.asarray(a))
        self._deltas.append((host(rows), host(cols), host(vals),
                             key_words(key), int(M_new), int(N_new)))
        self.obs.gauge_set("loop.ingest_queue", float(len(self._deltas)))

    def run(self, n_slices: int, *, degrade: bool = True) -> "OnlineLoop":
        """Run ``n_slices`` slices.  With ``degrade`` (the production
        default) a failed slice — injected fault, real bug — trips the
        watchdog and the loop keeps serving frozen; ``degrade=False``
        propagates (the chaos suite's simulated kill -9)."""
        for _ in range(n_slices):
            try:
                self.run_slice()
            except Exception:  # noqa: BLE001 — degrade, never die
                if not degrade:
                    raise
                self.obs.counter_add("loop.slice_failures")
                self._freeze()
        return self

    def run_slice(self) -> "OnlineLoop":
        """One slice of the state machine.  Exceptions propagate (callers
        wanting degrade-not-die semantics go through `run`)."""
        cfg, reg = self.cfg, self.obs
        t0 = time.perf_counter()
        # crash window: nothing is in flight between slices — a kill here
        # recovers bit-identically (nothing to redo past the WAL)
        faults.fire("loop.slice")
        with reg.span("loop.slice"):
            self._serve_phase()
            if self._frozen > 0:
                self._frozen -= 1
                reg.gauge_set("loop.frozen", float(self._frozen > 0))
            else:
                try:
                    with reg.span("loop.train"):
                        self._train_phase()
                except DivergenceError:
                    # slice-boundary rollback: state is pre-slice, the WAL
                    # entry re-trips on replay (replay-stable rejection)
                    reg.counter_add("loop.guard_trips")
                except Exception:  # noqa: BLE001 — poisoned slice:
                    # degrade to frozen-model serving instead of dying
                    reg.counter_add("loop.slice_failures")
                    self._freeze()
            self._drift_phase()
            self._maybe_publish()
            if cfg.ckpt_every and (self._slice + 1) % cfg.ckpt_every == 0:
                self.checkpoint()
        self._slice += 1
        reg.gauge_set("loop.slice", float(self._slice))
        dur = time.perf_counter() - t0
        if cfg.watchdog_s and dur > cfg.watchdog_s and not self._frozen:
            # stalled slice (e.g. an injected stall at a serve site):
            # suspend training before the stall compounds into lag
            reg.counter_add("loop.watchdog_trips")
            self._freeze()
        return self

    # ---- phases -----------------------------------------------------------

    def _serve_phase(self) -> None:
        reg = self.obs
        with reg.span("loop.serve"):
            self.svc.flush_some(self.cfg.serve_flushes)
        stale = self.staleness_s()
        reg.observe("loop.staleness_s", stale)      # p99 over the run
        reg.gauge_set("loop.staleness_s", stale)
        reg.gauge_set("loop.lag", float(self._lag))
        reg.gauge_set("loop.frozen", float(self._frozen > 0))

    def _train_phase(self) -> None:
        cfg, up, reg = self.cfg, self.updater, self.obs
        # backpressure: a deep ingest queue steals this slice's micro-epoch
        # budget — drain ΔΩ first, train again once the queue is shallow
        rounds = (0 if len(self._deltas) >= cfg.backpressure_queue
                  else cfg.micro_epochs)
        take = []
        while self._deltas and len(take) < cfg.deltas_per_slice:
            take.append(self._deltas.popleft())
        reg.gauge_set("loop.ingest_queue", float(len(self._deltas)))
        # quarantine before logging: poison ΔΩ never enters the redo log
        good, cur_m, cur_n = [], up.state.M, up.state.N
        for d in take:
            r, c, v, k, m_new, n_new = d
            try:
                check_delta(r, c, v, M_new=m_new, N_new=n_new,
                            M_old=cur_m, N_old=cur_n)
            except PoisonBatchError:
                reg.counter_add("loop.quarantined")
                continue
            good.append(d)
            cur_m, cur_n = m_new, n_new
        if not good and not rounds:
            return
        # one atomic WAL entry for the whole slice, logged before applying
        seq = up.seq + 1
        epoch0 = self._micro
        mkey = key_words(prng.fold_in(prng.PRNGKey(cfg.seed), seq))
        meta = dict(up._static_meta(), kind="slice", seq=seq,
                    slice=self._slice, n_deltas=len(good),
                    deltas=[dict(M_new=d[4], N_new=d[5]) for d in good],
                    rounds=rounds, epoch0=epoch0,
                    micro_batch=cfg.micro_batch)
        arrays = {"mkey": mkey}
        for i, (r, c, v, k, _, _) in enumerate(good):
            arrays.update({f"d{i}_rows": r, f"d{i}_cols": c,
                           f"d{i}_vals": v, f"d{i}_key": k})
        with reg.span("resil.wal.append"):
            up.wal.append(seq, arrays, meta)
        reg.counter_add("resil.wal.appends")
        # the entry is durable from here: the seq advances no matter how
        # applying it ends, because replay owns the entry's outcome (a
        # guard trip re-trips; only a *transient* mid-apply fault can make
        # replay succeed where live failed — recovery then keeps the WAL's
        # version, preferring no data loss over mirroring a degraded run)
        up.seq = seq
        try:
            st2, sched = _apply_slice(
                up.state, good, rounds=rounds, epoch0=epoch0, mkey=mkey,
                lsh=up.lsh, hp=up.hp, K=up.K, epochs=up.epochs,
                batch=up.batch, micro_batch=cfg.micro_batch, guard=up.guard,
                registry=reg, sched=self._sched)
        finally:
            self._micro += rounds       # cursor advances on every outcome,
                                        # matching what replay will do
        up.state = st2
        self._sched = sched
        self._note_mutation()
        reg.counter_add("loop.slices_trained")

    def _drift_phase(self) -> None:
        cfg, reg = self.cfg, self.obs
        if self.holdout is None or not cfg.drift_every:
            return
        if (self._slice + 1) % cfg.drift_every:
            return
        # crash window: drift only *reads* state (the probe, the window)
        faults.fire("loop.drift")
        st = self.updater.state
        dev = st.params.U.device
        r, c, v = (torch.as_tensor(a, dtype=t, device=dev) for a, t in zip(
            self.holdout, (torch.int32, torch.int32, torch.float32)))
        with reg.span("loop.drift"):
            rmse = float(model.rmse(st.params, st.sp, st.JK, r, c, v))
        reg.gauge_set("loop.drift_rmse", rmse)
        window = self._drift_rmse
        tripped = (len(window) >= 2
                   and rmse > min(window) * (1.0 + cfg.drift_tol))
        window.append(rmse)
        if tripped:
            reg.counter_add("loop.drift_rebuilds")
            reg.event("loop.drift_trip", rmse=rmse, slice=self._slice)
            # the stream moved under the model: make serving current, then
            # rebuild the index from today's accumulators (validate-then-
            # swap on the rebuilder thread; serving never pauses)
            self._publish()
            self.svc.request_rebuild(simlsh.pack_bits(st.S >= 0))
            window.clear()              # re-baseline after the rebuild

    def _maybe_publish(self) -> None:
        cfg = self.cfg
        if not self._lag:
            return
        if (self._lag >= cfg.max_lag
                or (cfg.max_staleness_s
                    and self.staleness_s() >= cfg.max_staleness_s)):
            self._publish()

    def _publish(self) -> None:
        """Hand the trained state to the service (drain → re-sign → swap →
        tail-ingest → re-warm, all inside `ingest_online_update`)."""
        if not self._lag:
            return
        st = self.updater.state
        with self.obs.span("loop.publish"):
            self.svc.ingest_online_update(st, N_old=self._published_N)
        self._published_N = st.N
        self._lag = 0
        self._stale_t0 = None
        self.obs.counter_add("loop.publishes")
        self.obs.gauge_set("loop.lag", 0.0)
        self.obs.gauge_set("loop.staleness_s", 0.0)

    def checkpoint(self) -> None:
        """Atomic progress cut: model state + loop cursors in one
        crash-atomic `train.checkpoint` step at the current WAL seq (the
        pending-delta watermark), then prune the entries it covers."""
        up, reg = self.updater, self.obs
        # crash window: before the durable cut — a kill here recovers from
        # the *previous* checkpoint plus the unpruned WAL suffix
        faults.fire("loop.ckpt")
        with reg.span("loop.ckpt"):
            tree = dict(state_tree(up.state),
                        loop_slice=np.int64(self._slice + 1),
                        loop_micro=np.int64(self._micro))
            checkpoint.save(up.ckpt_dir, tree, step=up.seq, sync=True)
        up.wal.prune(up.seq)
        up._ckpt_seq = up.seq
        reg.counter_add("loop.ckpts")

    def _note_mutation(self) -> None:
        self._lag += 1
        if self._stale_t0 is None:
            self._stale_t0 = time.perf_counter()

    def _freeze(self) -> None:
        """Degrade to frozen-model serving: the next ``freeze_slices``
        slices skip the train phase entirely; the service keeps answering
        from the last published params."""
        self._frozen = max(self._frozen, self.cfg.freeze_slices)
        self.obs.counter_add("loop.freezes")
        self.obs.gauge_set("loop.frozen", 1.0)

    # ---- construction / recovery ------------------------------------------

    @staticmethod
    def build_service(state: OnlineState, serve_cfg: ServeConfig, *,
                      tail_cap: int = 128,
                      registry: obs.Registry | None = None) -> RecsysService:
        """A warm single-device service from an `OnlineState`, on the
        state's device: re-sign the accumulators, build the index, warm
        the pipelines (on the card this builds and loads the kernels).
        Used at first construction and by `recover` (the request plane
        is rebuilt fresh — only the model state is durable)."""
        dev = state.params.U.device
        sigs = simlsh.pack_bits(state.S >= 0)
        idx = lsh_index.build_index(sigs, tail_cap=tail_cap, device=dev)
        return RecsysService(state.params, idx, state.sp, serve_cfg,
                             JK=state.JK, registry=registry,
                             device=dev).warmup()

    @classmethod
    def recover(cls, root: str, lsh, hp, serve_cfg: ServeConfig, *, K: int,
                epochs: int = 3, batch: int = 4096,
                cfg: LoopConfig = LoopConfig(),
                guard: GuardConfig | None = GuardConfig(),
                base_state: OnlineState | None = None, holdout=None,
                registry: obs.Registry | None = None,
                device=None) -> "OnlineLoop":
        """Resume after a crash: newest complete loop checkpoint + WAL
        replay (slice entries through `_apply_slice`, plain updater
        entries through `online_update`), then a fresh warm service from
        the recovered state.  The static arguments must match what the
        entries were logged with — `recover` refuses a mismatch rather
        than replay a different program.  ``base_state`` seeds a run that
        crashed before its first checkpoint.  A restored checkpoint lands
        on ``device``: by default ``base_state``'s device when one is
        given, else the card.  Replay keeps the micro schedule while Ω̂
        is stable, as the live loop does, and hands it to the recovered
        loop.  The spans ``loop.recover.restore``, ``resil.wal.replay``
        (one per entry) and ``loop.recover.service`` split the time to
        recover."""
        reg = registry if registry is not None else obs.scoped()
        if device is None and base_state is not None:
            device = base_state.params.U.device
        ckpt_dir = os.path.join(root, "ckpt")
        with reg.span("loop.recover.restore"):
            restored = checkpoint.try_restore(ckpt_dir, _loop_template())
            if restored is not None:
                tree, step = restored
                slice_ = int(tree.pop("loop_slice"))
                micro = int(tree.pop("loop_micro"))
                state = state_from_tree(tree, resolve_device(device))
            elif base_state is not None:
                state, step, slice_, micro = base_state, 0, 0, 0
            else:
                raise FileNotFoundError(
                    f"no complete loop checkpoint under {ckpt_dir} and no "
                    f"base_state to replay from")
        up = OnlineUpdater(state, lsh, hp, root=root, K=K, epochs=epochs,
                           batch=batch, ckpt_every=10 ** 9, guard=guard,
                           registry=reg, _seq=step, _ckpt_seq=step)
        want = up._static_meta()
        sched = None
        for e in up.wal.entries(after=step):
            for k, v in want.items():
                if e.meta.get(k) != v:
                    raise ValueError(
                        f"WAL entry {e.seq} was logged with {k}="
                        f"{e.meta.get(k)!r} but recover() got {v!r} — "
                        f"replay with the original static arguments")
            kind = e.meta.get("kind")
            if kind == "slice":
                deltas = [(e.arrays[f"d{i}_rows"], e.arrays[f"d{i}_cols"],
                           e.arrays[f"d{i}_vals"], e.arrays[f"d{i}_key"],
                           e.meta["deltas"][i]["M_new"],
                           e.meta["deltas"][i]["N_new"])
                          for i in range(e.meta["n_deltas"])]
                with reg.span("resil.wal.replay"):
                    try:
                        up.state, sched = _apply_slice(
                            up.state, deltas, rounds=e.meta["rounds"],
                            epoch0=e.meta["epoch0"],
                            mkey=e.arrays["mkey"], lsh=lsh, hp=hp, K=K,
                            epochs=epochs, batch=batch,
                            micro_batch=e.meta["micro_batch"], guard=guard,
                            registry=reg, sched=sched)
                    except DivergenceError:
                        reg.counter_add("loop.guard_trips")  # replay-stable
                micro = e.meta["epoch0"] + e.meta["rounds"]
                slice_ = max(slice_, e.meta["slice"] + 1)
            elif kind is None:
                # a plain OnlineUpdater.update entry in the shared seq space
                with reg.span("resil.wal.replay"):
                    try:
                        up.state = online_update(
                            up.state, e.arrays["rows"], e.arrays["cols"],
                            e.arrays["vals"], lsh, hp,
                            _key_tensor(e.arrays["key"]),
                            M_new=e.meta["M_new"], N_new=e.meta["N_new"],
                            K=K, epochs=epochs, batch=batch, guard=guard,
                            registry=reg)
                    except DivergenceError:
                        reg.counter_add("resil.guard_trips")
            else:
                raise ValueError(f"WAL entry {e.seq} has unknown kind "
                                 f"{kind!r} — written by a newer layout?")
            up.seq = e.seq
            reg.counter_add("resil.wal.replayed")
        with reg.span("loop.recover.service"):
            svc = cls.build_service(up.state, serve_cfg,
                                    tail_cap=cfg.tail_cap)
        loop = cls(up, svc, cfg, holdout=holdout, registry=reg,
                   _slice=slice_, _micro=micro)
        loop._sched = sched
        return loop
