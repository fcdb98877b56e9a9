"""Request-batching serving loop: retrieval → candidate scoring → top-N
(`repro/serve/service.py`).

A `RecsysService` owns the trained parameters (packed once into the
`ServePlanes` scoring layout), the persistent `LSHIndex`, and the
serving pipelines, routed by `ServeConfig` as the JAX package routes
them (`RecsysService._recommend`):

  * ``band_budget > 0`` — the walk path.  On the card (``impl="auto"``
    or ``"cuda"``), `recommend_walked_kernel`: seeds → window
    descriptors → the `lsh_retrieve` kernel (walk + dedup) → the
    `candidate_score` kernel (gather, score, top-N); with
    ``interpret=True``, or ``impl="cuda"`` on the CPU, the same function
    runs their plain versions.  On the CPU (``impl="auto"``) or with
    ``impl="ref"``, `recommend_walked`: merged interval descriptors
    enumerated under the budget, the pool scored with its duplicates,
    duplicate-masked top-N — plain PyTorch on any device, the path the
    JAX package runs on its CPU by default.
  * ``band_budget = 0`` — `recommend_candidates`, the legacy pool +
    dedup oracle: the bucket-mate / seed / J^K / tail union
    deduplicated by one hashed sort, scored by the `candidate_score`
    kernel (its plain version on the CPU or with ``impl="ref"``).
  * ``mode="full"`` (or a catalog at most ``route_full_below`` items) —
    exact `μ + b_i + b̂ + U Vᵀ` top-N over every item, `full_topn`.
  * ``shards`` > 1 (walk path only) — `recommend_sharded`: the items cut
    into D nnz-balanced ranges, each shard's col block and local index
    on its device of a shard mesh (`launch.mesh`), the walk and scoring
    per shard in plain PyTorch, and the partial top-Ns merged by a log₂D
    butterfly (`merge_topn`).  Read-only: ingestion raises
    `ShardedIngestUnsupported`.

Requests are micro-batched: `submit` queues user ids and flushes a
fixed-shape batch whenever ``micro_batch`` are pending (the final partial
batch is padded).  Flushes are dispatch-ahead: flush k+1 is enqueued on
the device before flush k is synced, so the host-side assembly and copy
out of one flush overlap the device work of the next.  Latency is
measured per flush from dispatch to result readiness, and QPS divides by
non-overlapping busy time.  Every metric lives in the service's private
`obs.Registry`, which `stats()` reads; `profile_flush` runs one flush
stage by stage under nested spans.

The ingestion plane (paper Alg. 4): `ingest` puts new items into the
index tail; when the tail would overflow it hands the full signature set
to a background rebuild (`resil.rebuild`, validate-then-swap, on its own
CUDA stream) while index v keeps serving, or rebuilds synchronously with
``background_rebuild=False``; `ingest_online_update` adopts a
`core.online.online_update` result (grown parameters, merged
interactions, J^K, new columns' signatures).

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
from repro_torch.core.model import (Params, ServePlanes, pack_serve_planes,
                                    shard_col_plane)
from repro_torch.core.topk import SENTINEL, topk_first_index
from repro_torch.data.sparse import SparseMatrix
from repro_torch.device import resolve_device
from repro_torch.kernels import IMPLS, KernelError
from repro_torch.kernels.candidate_score.ops import score_candidates
from repro_torch.kernels.candidate_score.ref import NEG
# a module import: `lsh_retrieve.ops` imports this package's index, so it
# may be mid-import when this module loads
from repro_torch.kernels.lsh_retrieve import ops as lsh_ops
from repro_torch.launch import mesh as shard_mesh
from repro_torch.resil import faults
from repro_torch.resil.rebuild import IndexRebuilder
from repro_torch.resil.validate import (_MAX_ID, PoisonBatchError,
                                        check_accumulators,
                                        check_ingest_batch)
from repro_torch.serve import index as lsh_index
from repro_torch.serve.index import (_EMPTY_SIG, LSHIndex, ShardedLSHIndex,
                                     padded_flat_ids)
from repro_torch.serve.retrieve import (_walk_gather, candidate_pool,
                                        enumerate_windows,
                                        finalize_candidates,
                                        retrieve_for_users, seed_items,
                                        shard_seed_sigs, shard_walk_local,
                                        tail_hits, translate_local_ids,
                                        walk_candidates, window_descriptors)


class ShardedIngestUnsupported(NotImplementedError):
    """Online ingestion was attempted on a sharded service.  Sharded
    serving is read-only — the per-shard index and col-plane partitions
    are built once from a complete catalog.  Run the ingest on a
    single-device service (``dataclasses.replace(cfg, shards=0)``), whose
    tail + rebuild path absorbs it, and construct a new sharded service
    from the grown state.  Rejections count ``serve.ingest_rejected``."""


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The JAX package's `ServeConfig` less ``interpret``, which selects
    the Pallas interpreter and has no counterpart here."""
    mode: str = "candidate"   # candidate | full
    topn: int = 10
    micro_batch: int = 256
    # retrieval knobs
    C: int = 512              # candidate slots per user
    n_seeds: int = 8          # seed items per user
    cap: int = 8              # bucket-mates taken per band per seed
    n_popular: int = 64       # global popularity shortlist size (0 = off)
    seed_window: int = 64
    use_jk: bool = True       # include seeds' training Top-K lists (the
                              # legacy path; the service's JK argument)
    fold_mates: bool = True   # fold per-(seed, band) bucket runs pairwise
                              # (halves the dedup sort width; see
                              # retrieve._fold_prefix_runs)
    pool_width: int = 0       # generic pre-dedup pool compaction width
                              # (0 = off; see retrieve.compact_pool)
    band_budget: int = 512    # > 0 = the window-walk retrieval path (the
                              # default pipeline): the lsh_retrieve kernel
                              # walks whole windows (band_budget is not
                              # read there), and with impl="ref" merged
                              # per-band intervals are enumerated under
                              # this shared per-user slot budget
                              # (retrieve.walk_candidates), duplicates
                              # folded at top-n selection.  0 = the legacy
                              # pool+dedup retrieval (the exact oracle).
                              # Size it near the p90 merged-interval mass
                              # (~q·n_seeds·3 at cap=8 on zipf catalogs):
                              # budget truncation drops whole trailing
                              # windows, which costs recall fast
    shards: int | str = 0     # sharded serving tier: 0 = off (the
                              # single-device paths); "auto" = the largest
                              # power of two ≤ the device count
                              # (`launch.mesh.device_count`); an int =
                              # exactly that many shards (a power of two;
                              # more than the devices raises).  Walk path
                              # only (band_budget > 0) and read-only
    shard_budget: int = 0     # per-shard walk slot budget (0 = auto:
                              # resolved_shard_budget)
    route_full_below: int = 0 # candidate-mode routing escape hatch: serve
                              # via exact full_topn when the catalog has at
                              # most this many items (candidate retrieval
                              # has a fixed per-user cost that exceeds the
                              # O(N) scan on small catalogs; the JAX
                              # package measured the crossover ≈ 48·C
                              # items on its CPU).  -1 = that auto
                              # threshold; 0 = off (the default)
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
    # kernel knobs
    tile_b: int = 8           # plain scorer's gather tile (users)
    walk_tile_b: int = 16     # gather tile of the plain walk path's pool
                              # scoring (recommend_walked)
    interpret: bool | None = None  # None = auto (the kernels' plain
                              # versions only on the CPU); True runs the
                              # kernel walk's plain versions on any device
                              # (the JAX package's Pallas interpret mode)
    impl: str = "auto"        # auto | cuda | ref — auto picks ref on the
                              # CPU and the CUDA kernels on the card (the
                              # JAX package's scorer_impl); ref is the
                              # plain walk path (band_budget > 0) or the
                              # plain scorer (band_budget = 0), on any
                              # device; cuda is the kernel walk / scorer

    def __post_init__(self):
        if self.mode not in ("candidate", "full"):
            raise ValueError(f"mode must be 'candidate' or 'full', got "
                             f"{self.mode!r}")
        if self.impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got "
                             f"{self.impl!r}")

    def scorer_impl(self, device) -> str:
        """``impl`` with ``"auto"`` resolved for tensors on ``device``:
        ``"ref"`` on the CPU, ``"cuda"`` on the card (the JAX package's
        `scorer_impl`, which reads the backend where this reads the
        device)."""
        if self.impl != "auto":
            return self.impl
        return "ref" if torch.device(device).type == "cpu" else "cuda"

    def interpret_mode(self, device) -> bool:
        """Whether the kernel walk runs its kernels' plain versions:
        ``interpret``, or on the CPU when it is None."""
        if self.interpret is not None:
            return self.interpret
        return torch.device(device).type == "cpu"

    def kernel_impl(self, device) -> str:
        """The ``impl`` the serving ops get: ``"ref"`` (the plain
        versions) for the plain scorer; in interpret mode the kernels'
        plain versions — on the CPU through their wrappers (``"auto"``,
        which run them for CPU tensors, so a wrapper's error still
        raises through the flush there:
        `test_service_kernel_error_is_never_answered_by_the_fallback`),
        on the card directly (``"ref"``); else ``"cuda"`` (the kernels,
        which raise off the card)."""
        if self.scorer_impl(device) == "ref":
            return "ref"
        if self.interpret_mode(device):
            return "auto" if torch.device(device).type == "cpu" else "ref"
        return "cuda"

    def resolved_pool_width(self) -> int:
        return self.pool_width

    def resolved_shard_budget(self, shards: int) -> int:
        """The per-shard walk budget: ``shard_budget``, or 2× the shard's
        share of ``band_budget`` rounded up to 32, at least 64 (a
        shard's bucket-head windows do not centre on the seed, so it
        needs more slack than budget/D; the JAX package measured recall
        ~0.02 below the single-device walk at 1.5× and within ±0.001 at
        2×)."""
        if self.shard_budget:
            return self.shard_budget
        per = -(-2 * self.band_budget // max(shards, 1))
        return max(64, -(-per // 32) * 32)


def full_topn(params: Params, user_ids: torch.Tensor, *, topn: int):
    """Exact dense scoring — every item, every user.  The O(N) baseline.

    Equal scores keep the lower item id first, as `lax.top_k` orders
    them (`topk.topk_first_index`).  A user id past the rows reads the
    last one (the JAX package's clamped gather)."""
    u = user_ids.long().clamp(0, params.U.shape[0] - 1)
    scores = (params.mu + params.b[u][:, None] + params.bh[None, :]
              + params.U[u] @ params.V.T) + 0.0       # −0 → +0: equal keys
    item = topk_first_index(scores, topn)
    return torch.gather(scores, 1, item), item.to(torch.int32)


def popular_shortlist(params: Params, n: int) -> torch.Tensor:
    """Items with the highest baseline offset b̂_j — the candidates the bias
    part of Eq. (1) ranks high regardless of the user's neighbourhood.
    Equal offsets keep the lower id first (stable sort), as `lax.top_k`."""
    order = torch.sort(params.bh, descending=True, stable=True).indices
    return order[:n].to(torch.int32).contiguous()


def recommend_candidates(planes: ServePlanes, index: LSHIndex,
                         sp: SparseMatrix, user_ids: torch.Tensor,
                         JK: torch.Tensor | None,
                         popular: torch.Tensor | None, *, n_seeds: int,
                         cap: int, C: int, window: int, pool_width: int,
                         fold_mates: bool, tail_scan: bool, topn: int,
                         tile_b: int, impl: str = "auto"):
    """The legacy pool + dedup path (``band_budget=0``): the
    `retrieve_for_users` candidates scored by the `candidate_score`
    kernel (on the card; its plain version on the CPU or with
    ``impl="ref"``).  → (scores [B, topn], items [B, topn])."""
    cand = retrieve_for_users(index, sp, user_ids, n_seeds=n_seeds, cap=cap,
                              C=C, JK=JK, popular=popular, window=window,
                              pool_width=pool_width, fold_mates=fold_mates,
                              tail_scan=tail_scan)
    return score_candidates(planes, user_ids, cand, topn=topn, tile_b=tile_b,
                            impl=impl)


def _pool_scores(urow: torch.Tensor, plane: torch.Tensor, cand: torch.Tensor,
                 *, tile_b: int) -> torch.Tensor:
    """Scores of a [B, W] id pool with its duplicates, ``tile_b`` users
    at a time (a [tile_b, W, F+1] gather, never the [B, W, F] cube).
    SENTINEL slots score NEG."""
    F = plane.shape[1] - 1
    out = []
    for t0 in range(0, cand.shape[0], tile_b):
        u, c = urow[t0:t0 + tile_b], cand[t0:t0 + tile_b]
        rows = plane[c.clamp(0, plane.shape[0] - 1).long()]
        s = (torch.einsum("bf,bcf->bc", u[:, :F], rows[..., :F])
             + rows[..., F] + u[:, F][:, None])
        out.append(torch.where(c == SENTINEL, NEG, s))
    return torch.cat(out) if out else urow.new_empty(cand.shape)


def _score_pool(planes: ServePlanes, user_ids: torch.Tensor,
                cand: torch.Tensor, popular: torch.Tensor | None, *,
                tile_b: int):
    """Walked pool + popularity shortlist → (scores [B, W(+P)], cand
    [B, W(+P)]).  The shortlist is batch-constant, so its scores are ONE
    [B, F]·[F, P] product, never a per-user gather.  A user id past the
    rows reads the last one (the JAX package's clamped gather)."""
    F = planes.F
    urow = planes.row[user_ids.long().clamp(0, planes.row.shape[0] - 1)]
    urow[:, F] += planes.mu                       # bias col := μ + b_i
    s = _pool_scores(urow, planes.col, cand, tile_b=tile_b)
    if popular is None:
        return s, cand
    B, P = cand.shape[0], popular.shape[0]
    prow = planes.col[popular.long()]                            # [P, F+1]
    ps = (urow[:, :F] @ prow[:, :F].T + prow[None, :, F]
          + urow[:, F][:, None])
    return (torch.cat([s, ps], dim=1),
            torch.cat([cand, popular[None, :].expand(B, P)], dim=1))


def _select_topn_masked(s: torch.Tensor, cand: torch.Tensor, *, topn: int):
    """Duplicate-masked top-n over a pool that was never deduplicated:
    ``topn`` rounds of full-width argmax, each masking every slot that
    holds the picked *id*, so cross-band duplicates (and the popular ∩
    walk overlap) collapse here instead of in a [B, W] sort.  Ties pick
    the lowest slot (`argmax` returns the first maximal index, on either
    device); an exhausted row emits SENTINEL at NEG."""
    bi = torch.arange(s.shape[0], device=s.device)
    outs, outi = [], []
    for _ in range(topn):
        i = torch.argmax(s, dim=1)
        sv = s[bi, i]
        picked = cand[bi, i]
        outs.append(sv)
        outi.append(torch.where(sv > NEG, picked,
                                torch.full_like(picked, SENTINEL)))
        s = torch.where(cand == picked[:, None], NEG, s)
    return torch.stack(outs, 1), torch.stack(outi, 1)


def recommend_walked(planes: ServePlanes, index: LSHIndex, sp: SparseMatrix,
                     user_ids: torch.Tensor, popular: torch.Tensor | None, *,
                     n_seeds: int, cap: int, budget: int, window: int,
                     tail_k: int, topn: int, tile_b: int):
    """The plain walk path (``impl="ref"``, the JAX package's CPU
    default): window descriptors → budgeted slot enumeration → pool
    scoring with duplicates intact → duplicate-masked top-n.  Plain
    PyTorch on either device; no kernel is launched.  ``tail_k`` is the
    tail scan width (`RecsysService._tail_k`); 0 skips the tail."""
    ids, seeds = walk_candidates(index, sp, user_ids, n_seeds=n_seeds,
                                 cap=cap, budget=budget, window=window)
    if tail_k:
        ids = torch.cat([ids, tail_hits(index, seeds, k=tail_k)], dim=1)
    s, cand = _score_pool(planes, user_ids, ids, popular, tile_b=tile_b)
    return _select_topn_masked(s, cand, topn=topn)


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


def merge_topn(sa: torch.Tensor, ia: torch.Tensor, sb: torch.Tensor,
               ib: torch.Tensor, *, topn: int):
    """Merge two top-n partial lists into the top-n of their union:
    (scores, ids) pairs [B, n] → [B, topn].

    The order is the JAX package's two-key `lax.sort` over (−score, id):
    score descending, then id ascending, with ±0 equal and every NaN
    last — so the merge is associative and commutative, and the
    butterfly reduce does not depend on how the catalog was split.  Each
    pair becomes one int64 key (the order-preserving int32 image of the
    canonical −score above the id's unsigned image), so no tie is left
    to the sort.  (NEG, SENTINEL) padding sinks below every real score;
    the two sides' real ids must be disjoint (shards partition the
    catalog)."""
    s = torch.cat([sa, sb], dim=1)
    i = torch.cat([ia, ib], dim=1)
    # the comparator's canonical keys: −0 → +0, and one NaN, which sorts
    # last
    neg = -s
    neg = torch.where(neg == 0, torch.zeros_like(neg), neg)
    neg = torch.where(torch.isnan(neg), torch.full_like(neg, float("nan")),
                      neg)
    bits = neg.contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    key = (ordered << 32) | (i.to(torch.int64) + 2 ** 31)
    order = torch.sort(key, dim=1).indices[:, :topn]
    return torch.gather(s, 1, order), torch.gather(i, 1, order)


@dataclasses.dataclass(frozen=True)
class _Shard:
    """One serving shard's state, on its device of the mesh: the col
    block, the local index arrays, and its id range as host ints."""
    device: torch.device
    col: torch.Tensor      # [block, F+1] — global rows lo … lo+n_local−1
    ssig: torch.Tensor     # [q, block] int32
    sids: torch.Tensor     # [q, block] int32 local ids
    slot: torch.Tensor     # [q, block] int32
    lo: int
    n_local: int


@dataclasses.dataclass(frozen=True)
class ShardedServing:
    """The sharded tier of a `RecsysService`: the stacked index (on the
    service's device, for validation), the mesh, and each shard's col
    block and local index (`_Shard`) on its device."""
    index: ShardedLSHIndex
    mesh: shard_mesh.ShardMesh
    parts: tuple

    @property
    def shards(self) -> int:
        return self.mesh.size


def recommend_sharded(planes: ServePlanes, sp: SparseMatrix,
                      user_ids: torch.Tensor, popular: torch.Tensor | None,
                      parts, *, n_seeds: int, cap: int, budget: int,
                      window: int, topn: int, tile_b: int):
    """The sharded flush over the shards ``parts`` (`_Shard`s).  On the
    service's device: the seeds and the user rows with μ added.  Per
    shard: the seeds' band signatures it owns (`shard_seed_sigs`), summed
    over the shards (`launch.mesh.psum`) and masked where no shard owns
    the seed; the walk of its local buckets under ``budget``
    (`shard_walk_local`) and its part of the popularity shortlist, scored
    against its col block (`_pool_scores`) and selected in global ids
    (`_select_topn_masked`).  Then log₂D butterfly rounds: each shard
    takes its XOR partner's partial (`launch.mesh.ppermute`) and merges
    (`merge_topn`).  Shard 0's answer → (scores, items) [B, topn].
    Plain PyTorch: no kernel is launched."""
    seeds = seed_items(sp, user_ids, n_seeds=n_seeds, window=window)
    F = planes.F
    urow = planes.row[user_ids.long().clamp(0, planes.row.shape[0] - 1)]
    urow[:, F] += planes.mu                       # bias col := μ + b_i
    seeds_d = [seeds.to(sh.device) for sh in parts]      # replicated
    contrib = []
    for sh, sd in zip(parts, seeds_d):
        with shard_mesh.on(sh.device):
            contrib.append(shard_seed_sigs(sh.ssig, sh.slot, sd, sh.lo,
                                           sh.n_local))
    qsigs = shard_mesh.psum(contrib)
    ps, pi = [], []
    for sh, sd, qs in zip(parts, seeds_d, qsigs):
        with shard_mesh.on(sh.device):
            qs = torch.where((sd != SENTINEL)[None], qs,
                             torch.full_like(qs, _EMPTY_SIG))
            local = shard_walk_local(sh.ssig, sh.sids, qs, sh.n_local,
                                     cap=cap, budget=budget)
            if popular is not None:
                # the shard scores the shortlist items it owns; the union
                # over the shards is the whole shortlist
                pl = popular.to(sh.device) - sh.lo
                pl = torch.where((pl >= 0) & (pl < sh.n_local), pl,
                                 torch.full_like(pl, SENTINEL))
                local = torch.cat(
                    [local, pl[None, :].expand(local.shape[0], -1)], dim=1)
            s = _pool_scores(urow.to(sh.device), sh.col, local,
                             tile_b=tile_b)
            a, b = _select_topn_masked(s, translate_local_ids(local, sh.lo),
                                       topn=topn)
        ps.append(a)
        pi.append(b)
    D, k = len(parts), 1
    while k < D:
        perm = [(d, d ^ k) for d in range(D)]
        qs_, qi_ = shard_mesh.ppermute(ps, perm), shard_mesh.ppermute(pi, perm)
        merged = []
        for d, sh in enumerate(parts):
            with shard_mesh.on(sh.device):
                merged.append(merge_topn(ps[d], pi[d], qs_[d], qi_[d],
                                         topn=topn))
        ps, pi = (list(x) for x in zip(*merged))
        k *= 2
    return ps[0], pi[0]


class RecsysService:
    def __init__(self, params: Params, index: LSHIndex, sp: SparseMatrix,
                 cfg: ServeConfig, JK: torch.Tensor | None = None, *,
                 registry: obs.Registry | None = None, device=None):
        dev = resolve_device(device)
        self.device = dev
        self.params = params.to(dev)
        self.planes = pack_serve_planes(self.params)     # built once
        self.index = index.to(dev)
        self.sp = sp.to(dev)
        self.cfg = cfg
        # the seeds' Top-K lists join the legacy path's pool
        self.JK = (torch.as_tensor(JK).to(dev, torch.int32)
                   if JK is not None and cfg.use_jk else None)
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
        self.profiled = None             # profile_flush's staged answer
        # the sharded tier (ServeConfig.shards), built once from the same
        # (params, index, sp) the single-device paths serve
        self._shard_state: ShardedServing | None = None
        shards = (shard_mesh.serve_shard_count(cfg.shards, dev)
                  if cfg.mode != "full" else 1)
        if shards > 1:
            self._init_shards(shards)

    def _init_shards(self, shards: int) -> None:
        """Cut the items into nnz-balanced shards and place each shard's
        col block and local index on its device of the mesh."""
        cfg = self.cfg
        if not cfg.band_budget:
            raise ValueError("sharded serving requires the walk path "
                             "(band_budget > 0); the legacy pool+dedup "
                             "pipeline is single-device only")
        if self.index.tail_fill:
            raise ValueError("sharded serving requires an empty index tail "
                             "— rebuild before sharding (online ingest is "
                             "single-device only)")
        mesh = shard_mesh.make_shard_mesh(shards, self.device)
        counts = np.bincount(self.sp.cols.cpu().numpy(),
                             minlength=self.planes.n_items)
        bounds = lsh_index.shard_bounds(counts, shards)
        sidx = lsh_index.build_sharded_index(
            lsh_index.signatures_of(self.index), shards=shards,
            bounds=bounds)
        col_stack = shard_col_plane(self.planes.col, bounds)
        parts = tuple(
            _Shard(device=dev, col=col_stack[d].to(dev),
                   ssig=sidx.sorted_sigs[d].to(dev),
                   sids=sidx.sorted_ids[d].to(dev),
                   slot=sidx.slot_of[d].to(dev), lo=int(bounds[d]),
                   n_local=int(bounds[d + 1] - bounds[d]))
            for d, dev in enumerate(mesh.devices))
        self._shard_state = ShardedServing(index=sidx, mesh=mesh,
                                           parts=parts)

    # ---- core pipelines ----

    def _flat_ids(self) -> torch.Tensor:
        if self._ids_flat_for is not self.index:
            self._ids_flat = padded_flat_ids(self.index, cap=self.cfg.cap)
            self._ids_flat_for = self.index
        return self._ids_flat

    def route_decision(self) -> dict:
        """The small-catalog routing verdict: candidate retrieval costs a
        fixed ~C-proportional amount per user, so below a catalog-size
        crossover the exact O(N) scan is faster *and* exact.
        ``decision`` reports what the heuristic picks even when routing
        is off (``enabled=False``)."""
        cfg = self.cfg
        thr = cfg.route_full_below if cfg.route_full_below > 0 else 48 * cfg.C
        n = self.planes.n_items
        decision = ("full" if cfg.mode == "candidate" and n <= thr
                    else cfg.mode)
        return dict(enabled=cfg.route_full_below != 0, threshold=int(thr),
                    n_items=int(n), decision=decision)

    def _tail_k(self) -> int:
        """Tail scan width of the plain walk path: the resident tail
        prefix (slots fill in insertion order) rounded up to 16; 0 skips
        the scan while the tail is empty."""
        n = self.index.tail_fill
        return 0 if not n else min(self.index.tail_cap, -(-n // 16) * 16)

    def _recommend(self, user_ids: torch.Tensor):
        """The JAX package's routing, branch for branch, on ``impl``
        resolved for the service's device (``"auto"`` on the CPU is the
        plain walk path; the sharded tier is the same plain program for
        every ``impl``)."""
        cfg = self.cfg
        impl = cfg.kernel_impl(self.device)
        if cfg.mode == "full" or (cfg.route_full_below and
                                  self.route_decision()["decision"] == "full"):
            return full_topn(self.params, user_ids, topn=cfg.topn)
        if self._shard_state is not None:
            D = self._shard_state.shards
            return recommend_sharded(
                self.planes, self.sp, user_ids, self.popular,
                self._shard_state.parts, n_seeds=cfg.n_seeds, cap=cfg.cap,
                budget=cfg.resolved_shard_budget(D), window=cfg.seed_window,
                topn=cfg.topn, tile_b=cfg.walk_tile_b)
        if cfg.band_budget and cfg.scorer_impl(self.device) == "ref":
            return recommend_walked(
                self.planes, self.index, self.sp, user_ids, self.popular,
                n_seeds=cfg.n_seeds, cap=cfg.cap, budget=cfg.band_budget,
                window=cfg.seed_window, tail_k=self._tail_k(), topn=cfg.topn,
                tile_b=cfg.walk_tile_b)
        if cfg.band_budget:
            return recommend_walked_kernel(
                self.planes, self.index, self.sp, user_ids, self.popular,
                self._flat_ids(), n_seeds=cfg.n_seeds, cap=cfg.cap, C=cfg.C,
                window=cfg.seed_window, tail_scan=self.index.tail_fill > 0,
                topn=cfg.topn, tile_b=cfg.tile_b, impl=impl)
        return recommend_candidates(
            self.planes, self.index, self.sp, user_ids, self.JK, self.popular,
            n_seeds=cfg.n_seeds, cap=cfg.cap, C=cfg.C, window=cfg.seed_window,
            pool_width=cfg.resolved_pool_width(), fold_mates=cfg.fold_mates,
            tail_scan=self.index.tail_fill > 0, topn=cfg.topn,
            tile_b=cfg.tile_b, impl=impl)

    def _barrier(self) -> None:
        """Wait for the device's queued work (nothing to wait for on the
        CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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
        self._barrier()
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
            self._barrier()
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
        batches refused, ``ingest_rejected`` = ingests refused by the
        read-only sharded tier, ``index_stale`` = an overflow awaits its
        background rebuild's swap.  ``route`` is `route_decision`;
        ``shards`` is the sharded tier's D, 1 on the single-device
        paths."""
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
            # small-catalog routing: the verdict is always reported;
            # `enabled` says whether _recommend acts on it
            route=self.route_decision(),
            shards=(self._shard_state.shards
                    if self._shard_state is not None else 1),
            device=str(self.device),
        )

    def profile_flush(self, user_ids=None) -> dict:
        """One *staged* flush with nested host spans — the observability
        view of the hot path.  The stages run as separate calls with a
        readiness barrier (`torch.cuda.synchronize` on the card) after
        each, so the span tree carries real wall times: serve.flush →
        retrieve(.desc → .walk) → score → select on the plain walk path,
        retrieve(.desc → .walk) → score on the kernel walk path,
        retrieve(.pool → .dedup) → score on the legacy path, score alone
        in full mode, and the sharded flush whole (its per-shard stages
        and collectives are one program).  A profiling tool, not a
        serving mode.  Returns {span name: seconds} for this run; the
        staged answer (scores, items) is kept in ``self.profiled``."""
        cfg = self.cfg
        reg = self.obs
        if user_ids is None:
            user_ids = np.arange(cfg.micro_batch, dtype=np.int32)
        ids = torch.from_numpy(np.atleast_1d(np.asarray(
            user_ids, np.int32))).to(self.device)
        sync = self._barrier
        names = ["serve.flush"]
        with reg.span("serve.flush"):
            if cfg.mode == "full":
                with reg.span("serve.flush.score"):
                    out = full_topn(self.params, ids, topn=cfg.topn)
                    sync()
                names += ["serve.flush.score"]
            elif self._shard_state is not None:
                with reg.span("serve.flush.sharded"):
                    out = self._recommend(ids)
                    sync()
                names += ["serve.flush.sharded"]
            elif cfg.band_budget and cfg.scorer_impl(self.device) == "ref":
                # plain walk: desc → walk → score → select (the dedup
                # happens inside select; there is no dedup stage)
                tail_k = self._tail_k()
                with reg.span("serve.flush.retrieve"):
                    with reg.span("serve.flush.retrieve.desc"):
                        seeds = seed_items(self.sp, ids, n_seeds=cfg.n_seeds,
                                           window=cfg.seed_window)
                        starts, counts = window_descriptors(
                            self.index, seeds, cap=cfg.cap)
                        sync()
                    with reg.span("serve.flush.retrieve.walk"):
                        pos = enumerate_windows(starts, counts,
                                                budget=cfg.band_budget)
                        walked = _walk_gather(self.index, pos)
                        if tail_k:
                            walked = torch.cat(
                                [walked, tail_hits(self.index, seeds,
                                                   k=tail_k)], dim=1)
                        sync()
                with reg.span("serve.flush.score"):
                    s, cand = _score_pool(self.planes, ids, walked,
                                          self.popular,
                                          tile_b=cfg.walk_tile_b)
                    sync()
                with reg.span("serve.flush.select"):
                    out = _select_topn_masked(s, cand, topn=cfg.topn)
                    sync()
                names += ["serve.flush.retrieve",
                          "serve.flush.retrieve.desc",
                          "serve.flush.retrieve.walk",
                          "serve.flush.score", "serve.flush.select"]
            else:
                with reg.span("serve.flush.retrieve"):
                    if cfg.band_budget:
                        # kernel walk: the lsh_retrieve kernel IS the
                        # walk + dedup stage
                        stages = ("desc", "walk")
                        with reg.span("serve.flush.retrieve.desc"):
                            desc = lsh_ops.walk_descriptors(
                                self.index, self.sp, ids,
                                n_seeds=cfg.n_seeds, cap=cfg.cap,
                                window=cfg.seed_window,
                                tail_scan=self.index.tail_fill > 0)
                            sync()
                        with reg.span("serve.flush.retrieve.walk"):
                            cand = lsh_ops.walk_topc(
                                *desc, self._flat_ids(), self.popular,
                                C=cfg.C, cap=cfg.cap,
                                impl=cfg.kernel_impl(self.device))
                            sync()
                    else:
                        stages = ("pool", "dedup")
                        with reg.span("serve.flush.retrieve.pool"):
                            pool = candidate_pool(
                                self.index, self.sp, ids,
                                n_seeds=cfg.n_seeds, cap=cfg.cap, JK=self.JK,
                                window=cfg.seed_window,
                                fold_mates=cfg.fold_mates,
                                tail_scan=self.index.tail_fill > 0)
                            sync()
                        with reg.span("serve.flush.retrieve.dedup"):
                            cand = finalize_candidates(
                                pool, C=cfg.C, popular=self.popular,
                                pool_width=cfg.resolved_pool_width())
                            sync()
                with reg.span("serve.flush.score"):
                    out = score_candidates(self.planes, ids, cand,
                                           topn=cfg.topn, tile_b=cfg.tile_b,
                                           impl=cfg.kernel_impl(self.device))
                    sync()
                names += ["serve.flush.retrieve",
                          *(f"serve.flush.retrieve.{n}" for n in stages),
                          "serve.flush.score"]
        self.profiled = out
        return {n: reg.span_durations(n)[-1] for n in names}

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

    def _refuse_if_sharded(self, advice: str) -> None:
        """The sharded tier is read-only: count the rejection and raise."""
        if self._shard_state is not None:
            self.obs.counter_add("serve.ingest_rejected")
            raise ShardedIngestUnsupported(f"sharded serving is read-only: "
                                           f"{advice}")

    def request_rebuild(self, full_sigs) -> None:
        """Hand the full [q, N] signature set to the background rebuilder;
        serving continues on index v and the validated v+1 swaps in at a
        later flush boundary (`_poll_rebuild`).  Single-device only: the
        sharded tier is rebuilt by constructing a new service."""
        self._refuse_if_sharded(
            "request the rebuild on a single-device service and construct "
            "a new sharded service from the swapped index")
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
        latency.  A sharded service refuses (`ShardedIngestUnsupported`)."""
        self._refuse_if_sharded(
            "apply this ingest on a single-device service (tail insert + "
            "rebuild on overflow) and construct a new sharded service from "
            "the rebuilt index, or hand full_sigs to request_rebuild() on "
            "that single-device service")
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
        ``serve.ingest_to_servable_s``.  A sharded service refuses
        (`ShardedIngestUnsupported`)."""
        self._refuse_if_sharded(
            "run the online-update handoff on a single-device service "
            "(shards=0) and construct a new sharded service from the grown "
            "state — or route the full re-signed signature set through "
            "request_rebuild() there")
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
                if self.JK is not None:
                    self.JK = state.JK.to(self.device)
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
