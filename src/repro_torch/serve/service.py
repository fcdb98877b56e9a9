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
index tail, or rebuilds the index synchronously when the tail would
overflow; `ingest_online_update` adopts a `core.online.online_update`
result (grown parameters, merged interactions, new columns' signatures).
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
from repro_torch.data.sparse import SparseMatrix
from repro_torch.device import resolve_device
from repro_torch.kernels import IMPLS
from repro_torch.kernels.candidate_score.ops import score_candidates
# a module import: `lsh_retrieve.ops` imports this package's index, so it
# may be mid-import when this module loads
from repro_torch.kernels.lsh_retrieve import ops as lsh_ops
from repro_torch.resil import faults
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
    # knobs of later slices: any value but the default raises
    shards: int | str = 0
    max_pending: int = 0
    deadline_s: float = 0.0

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
        if self.max_pending or self.deadline_s:
            raise NotImplementedError(
                "load shedding (max_pending, deadline_s) "
                + _LATER.format("resilience"))


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
        # dispatched-but-unsynced flushes:
        # (user_ids, n_real, t0_ns, (scores, items), done event or None)
        self._inflight: collections.deque = collections.deque()
        self._results: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._last_ready_ns = 0
        self._params_adopted = time.perf_counter()
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
        card this also builds and loads the kernels)."""
        ids = torch.zeros((self.cfg.micro_batch,), dtype=torch.int32,
                          device=self.device)
        self._recommend(ids)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    # ---- request plane ----

    def submit(self, user_ids) -> None:
        """Queue a request (any shape); flushes whole micro-batches."""
        arr = np.atleast_1d(np.asarray(user_ids, np.int32))
        self._pending.append((arr, time.perf_counter()))
        self._n_pending += arr.shape[0]
        self.obs.gauge_set("serve.queue_depth", self._n_pending)
        while self._n_pending >= self.cfg.micro_batch:
            self._flush_one()

    def flush(self) -> None:
        """Drain everything pending (final partial batch is padded) and
        sync every dispatched flush."""
        while self._n_pending:
            self._flush_one()
        while self._inflight:
            self._sync_oldest()

    def flush_some(self, max_flushes: int) -> int:
        """Dispatch at most ``max_flushes`` micro-batches, then sync
        everything in flight so the device is idle when the caller's next
        phase starts.  Work beyond the budget stays queued; returns the
        number of flushes dispatched."""
        n = 0
        while self._n_pending and n < max_flushes:
            self._flush_one()
            n += 1
        while self._inflight:
            self._sync_oldest()
        return n

    def _flush_one(self) -> None:
        """Dispatch one micro-batch; sync the *previous* flush only after
        this one is enqueued (double-buffered dispatch-ahead)."""
        mb = self.cfg.micro_batch
        reg = self.obs
        with reg.span("serve.flush.dispatch"):
            # consume only as many queued arrays as one micro-batch needs
            now = time.perf_counter()
            chunks, n, t_last = [], 0, now
            while self._pending and n < mb:
                a, t_sub = self._pending.popleft()
                reg.observe("serve.queue_wait", now - t_sub)
                chunks.append(a)
                n += a.shape[0]
                t_last = t_sub
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
            t0_ns = time.perf_counter_ns()
            ids = torch.from_numpy(take).to(self.device, non_blocking=True)
            out = self._recommend(ids)                   # async on the card
            done = self._done_event()
        self._inflight.append((take, n_real, t0_ns, out, done))
        reg.counter_add("serve.flushes")
        while len(self._inflight) > 1:
            self._sync_oldest()

    def _sync_oldest(self) -> None:
        take, n_real, t0_ns, (scores, items), done = self._inflight.popleft()
        if done is not None:
            done.synchronize()
        now_ns = time.perf_counter_ns()
        reg = self.obs
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
        in dispatch order, padding stripped."""
        out, self._results = self._results, []
        return out

    def stats(self) -> dict:
        """Serving stats, read entirely from the obs registry."""
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
            quarantined=int(reg.counter("serve.quarantined")),
            model_age_s=time.perf_counter() - self._params_adopted,
            device=str(self.device),
        )

    # ---- ingestion plane (paper Alg. 4) ----

    def ingest(self, new_sigs, new_ids, full_sigs=None) -> None:
        """Insert new items into the index tail; rebuild on overflow
        (which needs ``full_sigs`` [q, N_total], the new items included).

        The rebuild is synchronous: the service serves the rebuilt index
        when this returns.  (The JAX package's default hands it to a
        background rebuilder; the port behaves as the JAX package does
        with ``background_rebuild=False`` until its resilience slice.)
        Poison batches (wrong dtype, NaN rows, negative or duplicate ids)
        raise `PoisonBatchError` before any state is touched and count
        ``serve.quarantined``.  Crossing the empty-tail boundary, or a
        rebuild, changes the flush's shapes, so the service re-warms here
        — in ingestion time, not in the next request's latency."""
        t0_ns = time.perf_counter_ns()
        try:
            check_ingest_batch(new_sigs, new_ids, q=self.index.q)
        except PoisonBatchError:
            self.obs.counter_add("serve.quarantined")
            raise
        faults.fire("serve.ingest")
        n = int(new_ids.shape[0])
        with self.obs.span("serve.ingest"):
            had_tail = self.index.tail_fill > 0
            rebuilt = lsh_index.needs_rebuild(self.index, n)
            if rebuilt:
                if full_sigs is None:
                    raise ValueError(
                        "tail overflow and no full_sigs to rebuild")
                with self.obs.span("serve.ingest.rebuild"):
                    self.index = lsh_index.rebuild(self.index, full_sigs)
            else:
                with self.obs.span("serve.ingest.insert"):
                    self.index = lsh_index.insert(self.index, new_sigs,
                                                  new_ids)
            if rebuilt or (self.index.tail_fill > 0) != had_tail:
                with self.obs.span("serve.ingest.warmup"):
                    self.warmup()
        self.obs.counter_add("serve.ingests")
        self.obs.counter_add("serve.ingested_items", n)
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

    def request_rebuild(self, *args, **kwargs):
        raise NotImplementedError("RecsysService.request_rebuild "
                                  + _LATER.format("resilience"))
