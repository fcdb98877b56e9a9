"""Request-batching serving loop: retrieval → candidate scoring → top-N
(`repro/serve/service.py`, single-device walk path).

A `RecsysService` owns the trained parameters (packed once into the
`ServePlanes` scoring layout), the persistent `LSHIndex`, and two
pipelines:

  * ``candidate`` — `recommend_walked_kernel`: seeds → window descriptors
    → the `lsh_retrieve` kernel (walk + dedup) → the `candidate_score`
    kernel (gather, score, top-N).  On the card these are two chained
    CUDA kernels; on the CPU the same function runs their plain
    versions.
  * ``full`` — exact `μ + b_i + b̂ + U Vᵀ` top-N over every item, the
    O(N) baseline kept for recall measurement.

Requests are micro-batched: `submit` queues user ids and flushes a
fixed-shape batch whenever ``micro_batch`` are pending (the final partial
batch is padded).  Flushes are dispatch-ahead: flush k+1 is enqueued on
the device before flush k is synced, so the host-side assembly and copy
out of one flush overlap the device work of the next.  Latency is
measured per flush from dispatch to result readiness, and QPS divides by
non-overlapping busy time.  Every metric lives in the service's private
`obs.Registry`, which `stats()` reads.

The ingestion plane (paper Alg. 4): `ingest` puts new items into the
index tail; when the tail would overflow it hands the full signature set
to a background rebuild (`resil.rebuild`, validate-then-swap, on its own
CUDA stream) while index v keeps serving, or rebuilds synchronously with
``background_rebuild=False``; `ingest_online_update` adopts a
`core.online.online_update` result (grown parameters, merged
interactions, new columns' signatures).

Resilience (the JAX package's): the admission queue is bounded
(``max_pending``) with deadline-aware shedding (``deadline_s``) into a
host-side popularity answer; a flush that fails at dispatch or at sync
falls back to the exact `full_topn` — counted in ``stats()["fallbacks"]``,
never quiet, and never for a kernel's own `KernelError`, which propagates;
poison ingest batches are quarantined before any state is touched.  The shed / degraded / dropped / fallback / quarantine counters
live in the service registry and surface through `stats()`.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import simlsh
from repro_torch.core.model import Params, ServePlanes, pack_serve_planes
from repro_torch.core.topk import SENTINEL
from repro_torch.data.sparse import SparseMatrix
from repro_torch.device import resolve_device
from repro_torch.kernels import IMPLS, KernelError
from repro_torch.kernels.candidate_score.ops import score_candidates
# a module import: `lsh_retrieve.ops` imports this package's index, so it
# may be mid-import when this module loads
from repro_torch.kernels.lsh_retrieve import ops as lsh_ops
from repro_torch.resil import faults
from repro_torch.resil.rebuild import IndexRebuilder
from repro_torch.resil.validate import (_MAX_ID, PoisonBatchError,
                                        check_accumulators,
                                        check_ingest_batch)
from repro_torch.serve import index as lsh_index
from repro_torch.serve.index import LSHIndex, padded_flat_ids

_LATER = "is not ported yet: it belongs to a later slice of the port ({})"


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    mode: str = "candidate"   # candidate | full
    topn: int = 10
    micro_batch: int = 256
    # retrieval knobs
    C: int = 512              # candidate slots per user
    n_seeds: int = 8          # seed items per user
    cap: int = 8              # bucket-mates taken per band per seed
    n_popular: int = 64       # global popularity shortlist size (0 = off)
    seed_window: int = 64
    band_budget: int = 512    # > 0 = the window-walk retrieval path; the
                              # kernel path walks whole windows, so only
                              # 0 vs > 0 matters here
    tile_b: int = 8           # plain scorer's gather tile (users)
    impl: str = "auto"        # auto | cuda | ref — auto launches the CUDA
                              # kernels on the card and runs their plain
                              # versions on the CPU
    # resilience knobs
    max_pending: int = 0      # admission bound on queued users (0 = off);
                              # overflow sheds the *oldest* chunks into the
                              # degraded popularity path.  Keep it ≥ a few
                              # micro_batches or steady traffic sheds too
    deadline_s: float = 0.0   # queue-wait deadline (0 = off): chunks older
                              # than this at dispatch time are shed instead
                              # of scored — bounded staleness over stalls
    background_rebuild: bool = True  # overflow rebuilds run on a worker
                              # thread (its own CUDA stream) behind a
                              # validate-then-swap gate (resil.rebuild);
                              # False = synchronous rebuild on the ingest
                              # path
    rebuild_retries: int = 3  # failed/invalid background builds are retried
                              # this many times before giving up (the old
                              # index keeps serving either way)
    # knob of a later slice: any value but the default raises
    shards: int | str = 0

    def __post_init__(self):
        if self.mode not in ("candidate", "full"):
            raise ValueError(f"mode must be 'candidate' or 'full', got "
                             f"{self.mode!r}")
        if self.impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got "
                             f"{self.impl!r}")
        if self.shards != 0:
            raise NotImplementedError(
                "sharded serving (shards != 0) " + _LATER.format(
                    "multi-device tiers"))
        if self.band_budget == 0:
            raise NotImplementedError(
                "the legacy pool+dedup retrieval (band_budget=0) "
                + _LATER.format("legacy serving paths"))


def full_topn(params: Params, user_ids: torch.Tensor, *, topn: int):
    """Exact dense scoring — every item, every user.  The O(N) baseline.

    Equal scores keep the lower item id first, as `lax.top_k` orders
    them: the selection is a `topk` over int64 keys that pack the score's
    order-preserving int32 image above the complement of the item id, so
    every key is distinct and its order is (score desc, id asc)."""
    u = user_ids.long()
    scores = (params.mu + params.b[u][:, None] + params.bh[None, :]
              + params.U[u] @ params.V.T) + 0.0       # −0 → +0: equal keys
    bits = scores.view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    N = scores.shape[1]
    rank = torch.arange(N - 1, -1, -1, dtype=torch.int64,
                        device=scores.device)                  # N−1−id
    item = torch.topk((ordered << 32) | rank, topn, dim=1).indices
    return torch.gather(scores, 1, item), item.to(torch.int32)


def popular_shortlist(params: Params, n: int) -> torch.Tensor:
    """Items with the highest baseline offset b̂_j — the candidates the bias
    part of Eq. (1) ranks high regardless of the user's neighbourhood.
    Equal offsets keep the lower id first (stable sort), as `lax.top_k`."""
    order = torch.sort(params.bh, descending=True, stable=True).indices
    return order[:n].to(torch.int32).contiguous()


def recommend_walked_kernel(planes: ServePlanes, index: LSHIndex,
                            sp: SparseMatrix, user_ids: torch.Tensor,
                            popular: torch.Tensor | None,
                            ids_flat: torch.Tensor, *, n_seeds: int,
                            cap: int, C: int, window: int, tail_scan: bool,
                            topn: int, tile_b: int, impl: str = "auto"):
    """The walk path: the `lsh_retrieve` kernel walks + dedups the bucket
    windows and hands its [B, C] ids straight to the `candidate_score`
    kernel.  ``ids_flat`` is the service-cached `padded_flat_ids` plane.
    → (scores [B, topn], items [B, topn])."""
    cand = lsh_ops.retrieve_candidates(
        index, sp, user_ids, n_seeds=n_seeds, cap=cap, C=C, popular=popular,
        window=window, tail_scan=tail_scan, impl=impl, ids_flat=ids_flat)
    return score_candidates(planes, user_ids, cand, topn=topn,
                            tile_b=tile_b, impl=impl)


class RecsysService:
    def __init__(self, params: Params, index: LSHIndex, sp: SparseMatrix,
                 cfg: ServeConfig, *, registry: obs.Registry | None = None,
                 device=None):
        dev = resolve_device(device)
        self.device = dev
        self.params = params.to(dev)
        self.planes = pack_serve_planes(self.params)     # built once
        self.index = index.to(dev)
        self.sp = sp.to(dev)
        self.cfg = cfg
        self.popular = (popular_shortlist(self.params, cfg.n_popular)
                        if cfg.n_popular else None)
        # a PRIVATE registry: two services' same-named metrics never
        # blend; completed spans still mirror onto the process timeline
        self.obs = registry if registry is not None else obs.Registry(
            enabled=True, mirror=obs.get())
        self._pending: collections.deque = collections.deque()
        self._n_pending = 0
        # dispatched-but-unsynced flushes: (user_ids, n_real, t0_ns,
        # (scores, items), done event or None, degraded)
        self._inflight: collections.deque = collections.deque()
        self._results: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._last_ready_ns = 0
        self._params_adopted = time.perf_counter()
        # resilience state: the background rebuild slot, and the host
        # mirror (μ, b, b̂, shortlist) of the degraded popularity path
        # (invalidated on a parameter swap)
        self._rebuilder: IndexRebuilder | None = None
        self._rebuild_sigs = None        # full sigs of the build in flight
        self._rebuild_attempts = 0
        self._rebuild_t0 = 0.0
        self._host_bias = None
        # cached SENTINEL-apron id plane, keyed by index identity
        self._ids_flat = None
        self._ids_flat_for = None

    # ---- core pipelines ----

    def _flat_ids(self) -> torch.Tensor:
        if self._ids_flat_for is not self.index:
            self._ids_flat = padded_flat_ids(self.index, cap=self.cfg.cap)
            self._ids_flat_for = self.index
        return self._ids_flat

    def _recommend(self, user_ids: torch.Tensor):
        cfg = self.cfg
        if cfg.mode == "full":
            return full_topn(self.params, user_ids, topn=cfg.topn)
        return recommend_walked_kernel(
            self.planes, self.index, self.sp, user_ids, self.popular,
            self._flat_ids(), n_seeds=cfg.n_seeds, cap=cfg.cap, C=cfg.C,
            window=cfg.seed_window, tail_scan=self.index.tail_fill > 0,
            topn=cfg.topn, tile_b=cfg.tile_b, impl=cfg.impl)

    def _done_event(self):
        """An event recorded after the work just enqueued (None on CPU,
        where every call has already finished)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def warmup(self):
        """Run one flush-shaped batch before the timed traffic (on the
        card this also builds and loads the kernels).  It runs outside
        every fallback: a kernel that fails to build or launch raises
        here."""
        ids = torch.zeros((self.cfg.micro_batch,), dtype=torch.int32,
                          device=self.device)
        self._recommend(ids)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    # ---- request plane ----

    def submit(self, user_ids) -> None:
        """Queue a request (any shape); flushes whole micro-batches.

        Admission control (``cfg.max_pending``): when the queue exceeds
        the bound, the *oldest* queued users are shed into the degraded
        popularity path — under overload the service answers with bounded
        staleness instead of letting queue wait grow without limit."""
        self._poll_rebuild()
        arr = np.atleast_1d(np.asarray(user_ids, np.int32))
        self._pending.append((arr, time.perf_counter()))
        self._n_pending += arr.shape[0]
        if self.cfg.max_pending and self._n_pending > self.cfg.max_pending:
            self._shed_over_bound()
        self.obs.gauge_set("serve.queue_depth", self._n_pending)
        while self._n_pending >= self.cfg.micro_batch:
            self._flush_one()

    def flush(self) -> None:
        """Drain everything pending (final partial batch is padded) and
        sync every dispatched flush."""
        self._poll_rebuild()
        while self._n_pending:
            self._flush_one()
        while self._inflight:
            self._sync_oldest()

    def flush_some(self, max_flushes: int) -> int:
        """Dispatch at most ``max_flushes`` micro-batches, then sync
        everything in flight so the device is idle when the caller's next
        phase starts.  Work beyond the budget stays queued; returns the
        number of flushes dispatched."""
        self._poll_rebuild()
        n = 0
        while self._n_pending and n < max_flushes:
            self._flush_one()
            n += 1
        while self._inflight:
            self._sync_oldest()
        return n

    # ---- load shedding / degraded serving ----

    def _host_degraded(self, users: np.ndarray):
        """Host-side popularity answer: items = the global shortlist,
        scores = the bias part of Eq. (1) (μ + b_u + b̂_j) — no retrieval,
        no device dispatch.  None when ``n_popular`` is off (callers then
        drop instead of degrading)."""
        if self.popular is None:
            return None
        if self._host_bias is None:
            p = self.params
            self._host_bias = (float(p.mu), p.b.cpu().numpy(),
                               p.bh.cpu().numpy(),
                               self.popular.cpu().numpy())
        mu, b, bh, popular = self._host_bias
        topn = self.cfg.topn
        pop = popular[:topn]
        n, w = users.shape[0], pop.shape[0]
        safe_u = np.clip(users, 0, b.shape[0] - 1)
        items = np.full((n, topn), SENTINEL, np.int32)
        items[:, :w] = pop[None, :]
        scores = np.full((n, topn), -np.inf, np.float32)
        scores[:, :w] = mu + b[safe_u][:, None] + bh[pop][None, :]
        return scores, items

    def _shed_chunks(self, chunks: list) -> None:
        """Turn shed request chunks into one degraded pseudo-flush so
        `take_results` keeps submission order (shed chunks are always a
        FIFO prefix of the queue, so enqueueing the entry now — before
        the next real dispatch — preserves ordering)."""
        users = chunks[0] if len(chunks) == 1 else np.concatenate(chunks)
        reg = self.obs
        reg.counter_add("serve.shed_users", users.shape[0])
        res = self._host_degraded(users)
        if res is None:          # no popularity shortlist → drop, loudly
            reg.counter_add("serve.dropped_users", users.shape[0])
            return
        reg.counter_add("serve.degraded_users", users.shape[0])
        self._inflight.append((users, users.shape[0], time.perf_counter_ns(),
                               res, None, True))

    def _shed_over_bound(self) -> None:
        bound = self.cfg.max_pending
        shed: list = []
        while self._pending and self._n_pending > bound:
            a, t_sub = self._pending.popleft()
            excess = self._n_pending - bound
            if a.shape[0] > excess:      # split: shed only the overflow
                self._pending.appendleft((a[excess:], t_sub))
                a = a[:excess]
            shed.append(a)
            self._n_pending -= a.shape[0]
        if shed:
            self._shed_chunks(shed)

    def _shed_expired(self, now: float) -> None:
        """Deadline shedding: queue-wait is monotone along the FIFO, so
        expired chunks are exactly the queue prefix."""
        dl = self.cfg.deadline_s
        shed: list = []
        while self._pending and now - self._pending[0][1] > dl:
            a, _ = self._pending.popleft()
            self._n_pending -= a.shape[0]
            shed.append(a)
        if shed:
            self._shed_chunks(shed)

    def _flush_one(self) -> None:
        """Dispatch one micro-batch; sync the *previous* flush only after
        this one is enqueued (double-buffered dispatch-ahead).

        Resilience: expired chunks are shed *before* filling the batch
        (deadline shedding), and a failure while the flush is dispatched
        — an injected ``serve.flush`` fault, or any other error outside
        the kernels — falls back to the exact O(N) `full_topn` (counter
        ``serve.fallback_full``, ``stats()["fallbacks"]``).  The fallback
        is counted, never quiet, and it never answers for a kernel: a
        `KernelError` (a kernel that fails to build or launch, or a
        wrapper that refuses its operands) propagates, and a sticky CUDA
        error raises again from `full_topn`."""
        mb = self.cfg.micro_batch
        reg = self.obs
        with reg.span("serve.flush.dispatch"):
            # consume only as many queued arrays as one micro-batch needs
            now = time.perf_counter()
            if self.cfg.deadline_s:
                self._shed_expired(now)
            chunks, n, t_last = [], 0, now
            while self._pending and n < mb:
                a, t_sub = self._pending.popleft()
                reg.observe("serve.queue_wait", now - t_sub)
                chunks.append(a)
                n += a.shape[0]
                t_last = t_sub
            if not chunks:           # everything this flush would have
                return               # taken was shed past its deadline
            flat = chunks[0] if len(chunks) == 1 else np.concatenate(chunks)
            take = flat[:mb]
            if flat.size > mb:
                # overflow comes entirely from the last chunk popped
                self._pending.appendleft((flat[mb:], t_last))
            n_real = take.size
            self._n_pending -= n_real
            reg.gauge_set("serve.queue_depth", self._n_pending)
            if n_real < mb:  # pad the final partial batch to the fixed shape
                take = np.concatenate([take, np.zeros(mb - n_real, np.int32)])
            ids = torch.from_numpy(take).to(self.device, non_blocking=True)
            try:
                faults.fire("serve.flush")    # before the timer: injected
                # stalls read as queue wait, not scoring latency
                t0_ns = time.perf_counter_ns()
                out = self._recommend(ids)               # async on the card
            except KernelError:
                raise
            except Exception:  # noqa: BLE001 — degrade, never stall
                reg.counter_add("serve.fallback_full")
                t0_ns = time.perf_counter_ns()
                out = full_topn(self.params, ids, topn=self.cfg.topn)
            done = self._done_event()
        self._inflight.append((take, n_real, t0_ns, out, done, False))
        reg.counter_add("serve.flushes")
        while len(self._inflight) > 1:
            self._sync_oldest()

    def _sync_oldest(self) -> None:
        take, n_real, t0_ns, (scores, items), done, degraded = \
            self._inflight.popleft()
        reg = self.obs
        if degraded:
            # shed pseudo-flush: computed on the host at shed time; it
            # never touched the device, so it adds no flush latency or
            # busy time (p50/p99 stay about the real pipeline)
            reg.counter_add("serve.users", n_real)
            self._results.append((take[:n_real], scores[:n_real],
                                  items[:n_real]))
            return
        try:
            if done is not None:
                done.synchronize()
        except Exception:  # noqa: BLE001 — a deferred device failure:
            # recompute through the exact baseline rather than lose the
            # batch.  Only torch's device errors reach here (a KernelError
            # raises at dispatch), and a kernel's fault on the card is a
            # sticky CUDA error, which raises again from full_topn
            reg.counter_add("serve.fallback_full")
            scores, items = full_topn(
                self.params, torch.from_numpy(take).to(self.device),
                topn=self.cfg.topn)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        now_ns = time.perf_counter_ns()
        # latency: dispatch → result readiness (includes time queued
        # behind the previous flush); busy wall: overlap counted once
        reg.record_span("serve.flush", t0_ns, now_ns - t0_ns)
        reg.counter_add("serve.busy_seconds",
                        (now_ns - max(self._last_ready_ns, t0_ns)) * 1e-9)
        self._last_ready_ns = now_ns
        reg.counter_add("serve.users", n_real)
        self._results.append((take[:n_real],
                              scores[:n_real].cpu().numpy(),
                              items[:n_real].cpu().numpy()))

    def take_results(self):
        """[(user_ids, scores, items)] for every flush since the last take,
        in dispatch order, padding stripped.  Shed chunks appear as
        degraded pseudo-flushes in the same submission order; only
        *dropped* requests (``n_popular == 0`` under shedding) produce no
        rows."""
        out, self._results = self._results, []
        return out

    def stats(self) -> dict:
        """Serving stats, read entirely from the obs registry.  The
        resilience counters: ``shed`` = admission/deadline victims,
        ``degraded`` = shed users answered by the popularity path,
        ``dropped`` = shed with no shortlist, ``fallbacks`` = flushes
        answered by exact `full_topn`, ``quarantined`` = poison ingest
        batches refused, ``ingest_rejected`` = ingests refused by a
        read-only tier (none is ported, so 0), ``index_stale`` = an
        overflow awaits its background rebuild's swap."""
        reg = self.obs
        flush_s = reg.span_durations("serve.flush")
        secs = np.asarray(flush_s) if flush_s else np.zeros((1,))
        busy = reg.counter("serve.busy_seconds")
        users = int(reg.counter("serve.users"))
        return dict(
            mode=self.cfg.mode,
            batches=int(reg.counter("serve.flushes")),
            users=users,
            qps=users / busy if busy else 0.0,
            p50_ms=float(np.percentile(secs, 50) * 1e3),
            p95_ms=float(np.percentile(secs, 95) * 1e3),
            p99_ms=float(np.percentile(secs, 99) * 1e3),
            queue=self._n_pending,
            ingest_to_servable_s=reg.gauge("serve.ingest_to_servable_s",
                                           0.0),
            shed=int(reg.counter("serve.shed_users")),
            degraded=int(reg.counter("serve.degraded_users")),
            dropped=int(reg.counter("serve.dropped_users")),
            fallbacks=int(reg.counter("serve.fallback_full")),
            quarantined=int(reg.counter("serve.quarantined")),
            ingest_rejected=int(reg.counter("serve.ingest_rejected")),
            index_stale=bool(reg.gauge("serve.index_stale", 0.0)),
            model_age_s=time.perf_counter() - self._params_adopted,
            device=str(self.device),
        )

    # ---- background rebuild (double-buffered validate-then-swap) ----

    def _start_rebuild(self, full_sigs) -> None:
        if self._rebuilder is None:
            self._rebuilder = IndexRebuilder(self.obs)
        full_sigs = torch.as_tensor(full_sigs).to(self.device)
        self._rebuild_sigs = full_sigs       # kept for bounded auto-retry
        self._rebuild_attempts = 0
        self._rebuild_t0 = time.perf_counter()
        # stale: the tail overflowed, so items past base+tail are not yet
        # retrievable — cleared when the validated v+1 swaps in
        self.obs.gauge_set("serve.index_stale", 1.0)
        self._rebuilder.submit(full_sigs, tail_cap=self.index.tail_cap)

    def _poll_rebuild(self) -> None:
        """Called at the serving loop's edges (submit, flush, ingest):
        swap in a validated rebuild, or retry / roll back a failed one.
        Index v serves on in every branch — flushes in flight captured
        its tensors, which nothing writes in place, and a failed or
        invalid build is simply never taken.  On the card the serving
        stream waits on the worker's post-validation event (inside
        `IndexRebuilder.take`) before the swap."""
        if self._rebuilder is None:
            return
        status, idx, err = self._rebuilder.take()
        if status == "ready":
            self.index = idx
            self._rebuild_sigs = None
            with self.obs.span("serve.rebuild.swap"):
                self.warmup()
            self.obs.counter_add("serve.rebuild.swaps")
            self.obs.gauge_set("serve.index_stale", 0.0)
            self.obs.gauge_set("serve.ingest_to_servable_s",
                               time.perf_counter() - self._rebuild_t0)
        elif status == "failed":
            self._rebuild_attempts += 1
            if (self._rebuild_sigs is not None
                    and self._rebuild_attempts < self.cfg.rebuild_retries):
                self.obs.counter_add("serve.rebuild.retries")
                self._rebuilder.submit(self._rebuild_sigs,
                                       tail_cap=self.index.tail_cap)
            else:
                # rollback is the default: keep serving v; the index stays
                # stale (missing post-overflow items) and says so loudly
                self.obs.counter_add("serve.rebuild.gave_up")
                self._rebuild_sigs = None

    def request_rebuild(self, full_sigs) -> None:
        """Hand the full [q, N] signature set to the background rebuilder;
        serving continues on index v and the validated v+1 swaps in at a
        later flush boundary (`_poll_rebuild`)."""
        self._poll_rebuild()
        self._start_rebuild(full_sigs)

    # ---- ingestion plane (paper Alg. 4) ----

    def ingest(self, new_sigs, new_ids, full_sigs=None) -> None:
        """Insert new items into the index tail; rebuild on overflow
        (which needs ``full_sigs`` [q, N_total], the new items included).

        With ``cfg.background_rebuild`` (the default) an overflow hands
        ``full_sigs`` to the background rebuilder and returns at once:
        the service keeps serving index v (marked stale) and swaps in the
        validated v+1 at a later flush boundary.  Otherwise the rebuild
        is synchronous and served when this returns.  Poison batches
        (wrong dtype, NaN rows, negative or duplicate ids) raise
        `PoisonBatchError` before any state is touched and count
        ``serve.quarantined``.  Crossing the empty-tail boundary, or a
        synchronous rebuild, changes the flush's shapes, so the service
        re-warms here — in ingestion time, not in the next request's
        latency."""
        t0_ns = time.perf_counter_ns()
        try:
            check_ingest_batch(new_sigs, new_ids, q=self.index.q)
        except PoisonBatchError:
            self.obs.counter_add("serve.quarantined")
            raise
        faults.fire("serve.ingest")
        self._poll_rebuild()
        n = int(new_ids.shape[0])
        background = False
        with self.obs.span("serve.ingest"):
            had_tail = self.index.tail_fill > 0
            rebuilt = lsh_index.needs_rebuild(self.index, n)
            if rebuilt:
                if full_sigs is None:
                    raise ValueError(
                        "tail overflow and no full_sigs to rebuild")
                background = self.cfg.background_rebuild
                if background:
                    self._start_rebuild(full_sigs)
                else:
                    with self.obs.span("serve.ingest.rebuild"):
                        self.index = lsh_index.rebuild(self.index,
                                                       full_sigs)
            else:
                with self.obs.span("serve.ingest.insert"):
                    self.index = lsh_index.insert(self.index, new_sigs,
                                                  new_ids)
            if not background and (rebuilt or (self.index.tail_fill > 0)
                                   != had_tail):
                with self.obs.span("serve.ingest.warmup"):
                    self.warmup()
        self.obs.counter_add("serve.ingests")
        self.obs.counter_add("serve.ingested_items", n)
        # on the background path `_poll_rebuild` sets ingest→servable to
        # the overflow → swap latency once v+1 lands
        if not background:
            self.obs.gauge_set("serve.ingest_to_servable_s",
                               (time.perf_counter_ns() - t0_ns) * 1e-9)

    def ingest_online_update(self, state, N_old: int) -> None:
        """Adopt a `core.online.online_update` result: swap in the grown
        parameters and interactions, and add only the *new* columns to
        the index, re-signed from the updated accumulators (Alg. 4 lines
        1–6).  Old columns keep their buckets (the paper's "remains
        unchanged").  NaN-poisoned new accumulator columns raise
        `PoisonBatchError` (counted in ``serve.quarantined``) before
        anything is touched; the handoff's seconds, drain to re-warm, are
        ``serve.ingest_to_servable_s``."""
        t0_ns = time.perf_counter_ns()
        try:
            check_accumulators(state.S, N_old)
        except PoisonBatchError:
            self.obs.counter_add("serve.quarantined")
            raise
        if state.N > _MAX_ID:
            raise ValueError("item ids must stay below 2^30 (the dedup hash "
                             "of the lsh_retrieve kernel)")
        with self.obs.span("serve.ingest_online"):
            self.flush()    # drain in-flight work against the old planes
            with self.obs.span("serve.ingest_online.resign"):
                sigs = simlsh.pack_bits(state.S.to(self.device) >= 0)
            # swap the grown state in before the index ingest, so its
            # warmup runs on the new planes
            with self.obs.span("serve.ingest_online.swap"):
                self.params = state.params.to(self.device)
                self._params_adopted = time.perf_counter()
                self.planes = pack_serve_planes(self.params)
                self._host_bias = None     # the degraded path's mirror
                self.sp = state.sp.to(self.device)
                if self.cfg.n_popular:
                    self.popular = popular_shortlist(self.params,
                                                     self.cfg.n_popular)
            if state.N > N_old:
                self.ingest(sigs[:, N_old:].contiguous(),
                            torch.arange(N_old, state.N, dtype=torch.int32,
                                         device=self.device),
                            full_sigs=sigs)
            with self.obs.span("serve.ingest_online.warmup"):
                self.warmup()
        self.obs.gauge_set("serve.ingest_to_servable_s",
                           (time.perf_counter_ns() - t0_ns) * 1e-9)
