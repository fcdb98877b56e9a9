"""Batched candidate retrieval — the ANN stage of the serving pipeline
(`repro/serve/retrieve.py`, single device).

A user's candidates are the bucket-mates (across all bands) of their
*seed items* — their highest-rated observed items — plus tail items
(online inserts not yet folded into the sorted core) that collide with
any seed in any band.  Three pipelines build them:

  * the **kernel walk** (`kernels/lsh_retrieve/ops.py`): the seeds become
    window descriptors (`index.window_slices`) and the `lsh_retrieve`
    kernel walks and deduplicates them; `seed_items` and `tail_hits` are
    the stages around it;
  * the **plain walk** (`walk_candidates`): merged per-band interval
    descriptors (`window_descriptors`) enumerated under a shared per-user
    slot budget (`enumerate_windows`).  Cross-band duplicates remain;
    `service._select_topn_masked` folds them at top-N selection;
  * the **legacy pool + dedup** oracle (`retrieve_for_users`): the union
    of bucket-mates (`candidate_pool`, folded pairwise by
    `_fold_prefix_runs`), the seeds, their Top-K lists J^K and colliding
    tail items, deduplicated by ONE sort of invertible 30-bit hashes
    (`dedup_candidates`) into a fixed [B, C], with the popularity
    shortlist in reserved trailing slots (`finalize_candidates`).

The sharded tier walks each shard's local buckets by *signature*
(`shard_seed_sigs`, `sig_window_descriptors`, `shard_walk_local`) and
lifts the survivors to global ids (`translate_local_ids`).

All of it is integer work, bit-equal to the JAX package on either device.
"""
from __future__ import annotations

import torch

from repro_torch.core.topk import SENTINEL
from repro_torch.data.sparse import SparseMatrix
from repro_torch.serve.index import (_EMPTY_SIG, LSHIndex, _sig_of_items,
                                     lookup_items)

# invertible 30-bit multiplicative hash (2654435761·x mod 2³⁰) and its
# inverse; item ids stay below 2³⁰.  The products are taken in int64, so
# nothing relies on int32 overflow: their low 30 bits are the wrapped
# int32 products' low 30 bits
_MASK30 = 0x3FFFFFFF
_HASH = -1640531535
_UNHASH = 244002641
# interval sort key for invalid seeds: larger than any flat slot position
# (q·N < 2³⁰ by the build_index id bound), so they sink to the tail
_BIG = 1 << 30


def _full(shape, value, like: torch.Tensor) -> torch.Tensor:
    return torch.full(shape, value, dtype=torch.int32, device=like.device)


def seed_items(sp: SparseMatrix, user_ids: torch.Tensor, *, n_seeds: int,
               window: int = 64) -> torch.Tensor:
    """Top-rated observed items per user.  [B] → seeds [B, n_seeds],
    SENTINEL-padded for users with fewer than n_seeds ratings.

    A user's entries are a contiguous run of the row-sorted COO arrays;
    a fixed ``window`` of it is scanned.  Ratings tie often (they are
    clipped to [1, 5]), so the selection is a *stable* descending sort:
    equal ratings keep the lower position first, the tie rule of
    `lax.top_k` in the JAX package."""
    start = torch.searchsorted(sp.rows, user_ids, right=False, out_int32=True)
    end = torch.searchsorted(sp.rows, user_ids, right=True, out_int32=True)
    pos = start[:, None] + torch.arange(window, dtype=torch.int32,
                                        device=user_ids.device)    # [B, W]
    ok = pos < end[:, None]
    pos = pos.clamp(0, sp.rows.shape[0] - 1).long()
    vals = torch.where(ok, sp.vals[pos],
                       torch.tensor(float("-inf"), device=user_ids.device))
    items = torch.where(ok, sp.cols[pos],
                        torch.tensor(SENTINEL, dtype=torch.int32,
                                     device=user_ids.device))
    top, idx = torch.sort(vals, dim=1, descending=True, stable=True)
    k = min(n_seeds, window)
    top, idx = top[:, :k], idx[:, :k]
    seeds = torch.gather(items, 1, idx)
    return torch.where(torch.isfinite(top), seeds,
                       torch.full_like(seeds, SENTINEL))


# ---------------------------------------------------------------------------
# The legacy pool + dedup pipeline (``band_budget=0``, the exact oracle).
# ---------------------------------------------------------------------------


def _compact_left(keys: torch.Tensor, width: int) -> torch.Tensor:
    """Left-compact each row's non-SENTINEL entries into ``width`` slots,
    preserving order: output slot k gathers the k-th survivor, found by
    binary-searching the survivor-count cumsum.  Entries past ``width``
    survivors are dropped."""
    B, L = keys.shape
    pos = torch.cumsum(keys != SENTINEL, dim=1, dtype=torch.int32)  # [B, L]
    k = torch.arange(1, width + 1, dtype=torch.int32, device=keys.device)
    src = torch.searchsorted(pos, k.expand(B, width).contiguous(),
                             right=False)
    out = torch.gather(keys, 1, src.clamp(max=L - 1))
    return torch.where(k[None, :] <= pos[:, -1:], out,
                       torch.full_like(out, SENTINEL))


def _fold_prefix_runs(runs: torch.Tensor) -> torch.Tensor:
    """[B, R, cap] of *prefix-compacted* runs (valid entries contiguous
    from slot 0, the `lookup_items` output invariant) → [B, ⌈R/2⌉,
    3·cap/2]: each pair of runs merges into one ``1.5·cap``-wide run,
    the left run's prefix first.  The prefix invariant makes the k-th
    survivor's position computable, so the fold is one elementwise index
    computation and one gather.  A pair with more than ``1.5·cap``
    survivors drops the overflow; an odd last run passes through, padded
    to the fold width."""
    B, R, cap = runs.shape
    w = 3 * cap // 2
    pairs = runs[:, :R - R % 2, :].reshape(B, R // 2, 2 * cap)
    c0 = (pairs[..., :cap] != SENTINEL).sum(-1, keepdim=True).to(
        torch.int32)                                    # left-run survivors
    j = torch.arange(w, dtype=torch.int32, device=runs.device)
    right = torch.clamp(cap + j - c0, max=2 * cap - 1)  # keep src in bounds
    out = torch.gather(pairs, 2, torch.where(j < c0, j, right).long())
    out = torch.where((j < c0) | (cap + j - c0 < 2 * cap), out,
                      torch.full_like(out, SENTINEL))
    if R % 2:
        odd = torch.cat([runs[:, R - 1:, :],
                         _full((B, 1, w - cap), SENTINEL, runs)], dim=2)
        out = torch.cat([out, odd], dim=1)
    return out


def compact_pool(pool: torch.Tensor, *, width: int) -> torch.Tensor:
    """[B, L] SENTINEL-strewn id pool → [B, width], valid ids
    left-compacted in pool order.  Rows with more than ``width`` valid
    entries drop the overflow in pool order (a biased truncation, so
    callers keep ``width`` above the typical valid count; the unbiased
    hashed truncation happens in `dedup_candidates`)."""
    return _compact_left(pool, width)


def dedup_candidates(cands: torch.Tensor, *, C: int,
                     exclude_sorted: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """[B, L] SENTINEL-padded id lists → [B, C] unique ids, SENTINEL-padded.

    Ids in ``exclude_sorted`` (ascending) are dropped.  One sort: the key
    is the invertible multiplicative hash mod 2³⁰ with padding and
    excluded slots folded in as SENTINEL, so a single sort groups
    duplicates (equal hashes ⇔ equal ids), fixes an unbiased truncation
    order past C (no id range is systematically evicted) and pushes
    padding last.  The first occurrences are left-compacted and mapped
    back through the hash's modular inverse."""
    B, L = cands.shape
    valid = cands != SENTINEL
    if exclude_sorted is not None:
        p = torch.searchsorted(exclude_sorted, cands).clamp(
            0, exclude_sorted.shape[0] - 1)
        valid &= exclude_sorted[p] != cands
    h = torch.where(valid, (cands.long() * _HASH) & _MASK30,
                    SENTINEL).to(torch.int32)
    h = torch.sort(h, dim=1).values                     # the single sort
    prev = torch.cat([_full((B, 1), -1, h), h[:, :-1]], dim=1)
    h = torch.where(h != prev, h, torch.full_like(h, SENTINEL))
    h = _compact_left(h, C)
    return torch.where(h == SENTINEL, h,
                       ((h.long() * _UNHASH) & _MASK30).to(torch.int32))


def candidate_pool(index: LSHIndex, sp: SparseMatrix, user_ids: torch.Tensor,
                   *, n_seeds: int, cap: int, JK: torch.Tensor | None = None,
                   window: int = 64, fold_mates: bool = True,
                   tail_scan: bool = True) -> torch.Tensor:
    """The pre-dedup candidate union: seeds, their bucket-mates (folded),
    their Top-K lists and colliding tail items — [B, L] SENTINEL-strewn.
    Separate from `finalize_candidates` so `RecsysService.profile_flush`
    can time the pool apart from the dedup sort."""
    B = user_ids.shape[0]
    seeds = seed_items(sp, user_ids, n_seeds=n_seeds, window=window)  # [B, S]
    # an empty (or absent) tail means every seed id lives in the sorted
    # core — lookup can take the slot-only fast path
    base_only = (not tail_scan) or index.tail_cap == 0
    mates = lookup_items(index, seeds.reshape(-1), cap=cap,
                         include_tail=False, assume_base=base_only)
    mates = mates.reshape(B, -1, cap)             # [B, S·q, cap] prefix runs
    if fold_mates:
        mates = _fold_prefix_runs(mates)
    pools = [mates.reshape(B, -1), seeds]
    if JK is not None:
        nb = JK[seeds.clamp(0, JK.shape[0] - 1).long()]        # [B, S, K]
        nb = torch.where((seeds != SENTINEL)[:, :, None], nb,
                         torch.full_like(nb, SENTINEL))
        pools.append(nb.reshape(B, -1))
    if index.tail_cap and tail_scan:
        pools.append(tail_hits(index, seeds))
    return torch.cat(pools, dim=1)


def finalize_candidates(pool: torch.Tensor, *, C: int,
                        popular: torch.Tensor | None = None,
                        pool_width: int = 0) -> torch.Tensor:
    """Pool → [B, C] unique candidates: the optional pre-compaction to
    ``pool_width``, the single-sort dedup, and the popularity shortlist
    in reserved trailing slots."""
    B = pool.shape[0]
    if 0 < pool_width < pool.shape[1]:
        pool = compact_pool(pool, width=pool_width)
    if popular is None:
        return dedup_candidates(pool, C=C)
    P = popular.shape[0]
    if C <= P:
        raise ValueError(f"candidate budget C={C} must exceed the shortlist "
                         f"P={P}")
    core = dedup_candidates(pool, C=C - P,
                            exclude_sorted=torch.sort(popular).values)
    return torch.cat([core, popular[None, :].expand(B, P)], dim=1)


def retrieve_for_users(index: LSHIndex, sp: SparseMatrix,
                       user_ids: torch.Tensor, *, n_seeds: int, cap: int,
                       C: int, JK: torch.Tensor | None = None,
                       popular: torch.Tensor | None = None, window: int = 64,
                       pool_width: int = 0, fold_mates: bool = True,
                       tail_scan: bool = True) -> torch.Tensor:
    """user_ids [B] → candidate item ids [B, C] int32, SENTINEL-padded:
    `candidate_pool` then `finalize_candidates`.  ``fold_mates`` folds
    the per-(seed, band) runs pairwise; ``tail_scan=False`` skips the
    tail pool (pass it when the tail is empty); ``pool_width > 0``
    pre-compacts the pool before the dedup sort."""
    pool = candidate_pool(index, sp, user_ids, n_seeds=n_seeds, cap=cap,
                          JK=JK, window=window, fold_mates=fold_mates,
                          tail_scan=tail_scan)
    return finalize_candidates(pool, C=C, popular=popular,
                               pool_width=pool_width)


def retrieve_for_items(index: LSHIndex, item_ids: torch.Tensor, *, cap: int,
                       C: int) -> torch.Tensor:
    """Item-to-item retrieval (related-items widgets): [B] → [B, C]."""
    return dedup_candidates(lookup_items(index, item_ids, cap=cap), C=C)


# ---------------------------------------------------------------------------
# The plain walk path (``band_budget > 0``, ``impl="ref"``).
# ---------------------------------------------------------------------------


def _merge_intervals(st: torch.Tensor, en: torch.Tensor, base: torch.Tensor):
    """Sort + overlap-trim per-band interval lists.  st/en [q, B, S]
    (slot-space starts/ends, `_BIG` marking invalid intervals) →
    (starts, counts) [B, q·S], ``starts`` lifted to flat positions by
    ``base`` [q, 1, 1].  Windows of one band are sorted by start and
    overlaps trimmed (interval k begins at ``max(start_k, max(end_0..
    k-1))``), so within a band every slot appears at most once.

    The JAX package co-sorts the pairs with a bitonic network, whose
    order among equal starts is not stable.  It does not need to be:
    a window's start lies in its own bucket, so equal starts share the
    bucket and hence the end, and every sort gives the same pairs."""
    q, B, S = st.shape
    st, order = torch.sort(st, dim=2, stable=True)
    en = torch.gather(en, 2, order)
    run_en = torch.cummax(en, dim=2).values
    pmax = torch.cat([torch.zeros_like(en[:, :, :1]), run_en[:, :, :-1]],
                     dim=2)
    ns = torch.maximum(st, pmax)
    cnt = torch.clamp(torch.clamp(en, max=_BIG) - ns, min=0)
    invalid = st >= _BIG
    cnt = torch.where(invalid, 0, cnt)
    ns = torch.where(invalid, 0, ns + base)
    starts = ns.permute(1, 0, 2).reshape(B, q * S)
    counts = cnt.permute(1, 0, 2).reshape(B, q * S)
    return starts, counts


def window_descriptors(index: LSHIndex, seeds: torch.Tensor, *, cap: int):
    """Merged per-(user, band) bucket-window intervals.

    seeds [B, S] → (starts, counts), both [B, q·S] int32.  Each seed
    contributes its `lookup_items`-geometry window (centred on its slot,
    clipped to its bucket, ≤ ``cap`` wide); overlapping windows of the
    same band are merged (`_merge_intervals`).  ``starts`` are flat
    positions into ``sorted_ids.reshape(-1)``; ``counts`` may be 0
    (fully shadowed or invalid windows).  Intervals arrive band-major
    but not globally sorted."""
    q, Nn = index.q, index.n_base
    valid = (seeds != SENTINEL) & (seeds >= 0) & (seeds < Nn)
    safe = seeds.clamp(0, Nn - 1)
    base = (torch.arange(q, dtype=torch.int32, device=seeds.device)
            * Nn)[:, None, None]                                   # [q,1,1]
    slot = index.slot_of.reshape(-1)[(base + safe[None]).long()]   # [q,B,S]
    fslot = (base + slot).long()
    lo = index.bucket_lo.reshape(-1)[fslot]
    hi = index.bucket_hi.reshape(-1)[fslot]
    st = torch.minimum(torch.maximum(slot - cap // 2, lo),
                       torch.maximum(hi - cap, lo))
    en = torch.minimum(st + cap, hi)
    big = torch.full_like(st, _BIG)
    st = torch.where(valid[None], st, big)
    en = torch.where(valid[None], en, big)
    return _merge_intervals(st, en, base)


def enumerate_windows(starts: torch.Tensor, counts: torch.Tensor, *,
                      budget: int) -> torch.Tensor:
    """Expand interval descriptors into flat slot positions under a
    shared per-user budget.  (starts, counts) [B, I] → pos [B, budget]
    int32, −1 past each user's total.  Users whose intervals sum past
    ``budget`` are truncated in interval order (later intervals first).

    Each nonempty interval scatters its index at its output offset (the
    cumsum of counts), a running max extends ownership forward (interval
    indices are monotone in offset), and a gather of the owner's
    (start − offset) turns a slot's rank into its flat position.  The
    JAX package drops out-of-range scatter targets; here they land in
    one spare column that is cut off."""
    B, I = starts.shape
    coff = torch.cumsum(counts, dim=1, dtype=torch.int32)
    coff_ex = coff - counts
    total = coff[:, -1:]
    val = starts - coff_ex                      # per interval: pos = val + d
    tgt = torch.where(counts > 0, coff_ex, budget).clamp(max=budget)
    jidx = torch.arange(I, dtype=torch.int32, device=starts.device).expand(
        B, I)
    own = torch.zeros((B, budget + 1), dtype=torch.int32,
                      device=starts.device)
    own.scatter_reduce_(1, tgt.long(), jidx, reduce="amax")
    own = torch.cummax(own[:, :budget], dim=1).values
    d = torch.arange(budget, dtype=torch.int32, device=starts.device)[None, :]
    pos = torch.gather(val, 1, own.long()) + d
    return torch.where(d < total, pos, -1)


def _walk_gather(index: LSHIndex, pos: torch.Tensor) -> torch.Tensor:
    """Flat slot positions (−1 = none) → item ids (SENTINEL)."""
    flat = index.sorted_ids.reshape(-1)
    return torch.where(pos >= 0, flat[pos.clamp(min=0).long()],
                       torch.full_like(pos, SENTINEL))


def walk_candidates(index: LSHIndex, sp: SparseMatrix, user_ids: torch.Tensor,
                    *, n_seeds: int, cap: int, budget: int,
                    window: int = 64):
    """The plain walk end to end: seeds → merged descriptors → enumerated
    slots → gathered ids.  [B] → (ids [B, budget], seeds [B, n_seeds]).

    ``ids`` may hold *cross-band* duplicates (each band is duplicate-free
    by construction): `service._select_topn_masked` folds them.  Seeds
    are not appended — every valid seed's window holds the seed."""
    seeds = seed_items(sp, user_ids, n_seeds=n_seeds, window=window)
    starts, counts = window_descriptors(index, seeds, cap=cap)
    pos = enumerate_windows(starts, counts, budget=budget)
    return _walk_gather(index, pos), seeds


def tail_hits(index: LSHIndex, seeds: torch.Tensor, *,
              k: int = 0) -> torch.Tensor:
    """Online-insert tail items colliding with any seed in any band.
    seeds [B, S] → [B, k] ids, SENTINEL where no collision.  ``k`` > 0
    scans only the first k tail slots (the tail fills in insertion
    order); k = 0 scans the whole buffer."""
    T = index.tail_cap
    k = T if k <= 0 else min(k, T)
    qsigs = _sig_of_items(index, seeds)                          # [q, B, S]
    hit = (qsigs[..., None]
           == index.tail_sigs[:, :k][:, None, None, :]).any(dim=2).any(dim=0)
    return torch.where(hit, index.tail_ids[None, :k],
                       torch.full_like(index.tail_ids[None, :k], SENTINEL))


# ---------------------------------------------------------------------------
# The shard-local walk (one shard's half of the sharded flush).  A seed's
# slot exists only in its owning shard, so every shard walks its own
# local buckets by the seed's band signatures, which the owner computes
# and the flush sums across shards.  Ids stay local until scoring is done.
# ---------------------------------------------------------------------------


def shard_seed_sigs(ssig: torch.Tensor, slot_of: torch.Tensor,
                    seeds: torch.Tensor, lo: int, n_local: int
                    ) -> torch.Tensor:
    """The band signatures of the seeds this shard owns.

    ssig/slot_of [q, block] (one shard's arrays), seeds [B, S] global
    ids, ``lo`` the shard's first global id, ``n_local`` its real item
    count → [q, B, S] int32: the seed's signature where this shard owns
    it, 0 elsewhere.  Each seed has one owner, so the sum over shards
    gives every shard every seed's signature; seeds no shard owns must be
    masked to `_EMPTY_SIG` after the sum (a sum of zeros is a legal
    signature)."""
    q, block = ssig.shape
    local = seeds - lo
    owned = (seeds != SENTINEL) & (local >= 0) & (local < n_local)
    safe = local.clamp(0, block - 1).reshape(-1).long()
    slot = slot_of[:, safe].long()                             # [q, B·S]
    sig = torch.gather(ssig, 1, slot).reshape((q,) + tuple(seeds.shape))
    return torch.where(owned[None], sig, torch.zeros_like(sig))


def sig_window_descriptors(ssig: torch.Tensor, qsigs: torch.Tensor, *,
                           cap: int):
    """Signature-addressed window descriptors over one shard's local CSR.

    ssig [q, block] (ascending per band), qsigs [q, B, S] seed band
    signatures (`_EMPTY_SIG` = invalid) → (starts, counts) [B, q·S], flat
    positions into the shard's ``sorted_ids.reshape(-1)``.  A window is
    the first ≤ ``cap`` slots of the local bucket (bucket-head: a probing
    shard has no seed slot to centre on); when a bucket fits in ``cap``
    both geometries give the whole bucket, so the union over shards is
    the single-device window union whenever nothing truncates.  Windows
    of one band that share a bucket merge to one (`_merge_intervals`).
    A signature the shard lacks gets an empty window at its insertion
    point, which may equal a bucket's start; the JAX package's bitonic
    sort may order such a tie otherwise, so the two packages' empty
    windows may sit at other positions, while the windows the walk reads
    are equal, in order."""
    q, block = ssig.shape
    _, B, S = qsigs.shape
    flat = qsigs.reshape(q, B * S).contiguous()
    lo = torch.searchsorted(ssig, flat, side="left",
                            out_int32=True).reshape(q, B, S)
    hi = torch.searchsorted(ssig, flat, side="right",
                            out_int32=True).reshape(q, B, S)
    valid = qsigs != _EMPTY_SIG
    big = torch.full_like(lo, _BIG)
    st = torch.where(valid, lo, big)
    en = torch.where(valid, torch.minimum(lo + cap, hi), big)
    base = (torch.arange(q, dtype=torch.int32, device=ssig.device)
            * block)[:, None, None]
    return _merge_intervals(st, en, base)


def shard_walk_local(ssig: torch.Tensor, sids: torch.Tensor,
                     qsigs: torch.Tensor, n_local: int, *, cap: int,
                     budget: int) -> torch.Tensor:
    """One shard's walked candidates in LOCAL ids, SENTINEL-padded:
    ssig/sids [q, block], qsigs [q, B, S] (`shard_seed_sigs` summed) →
    [B, budget].  Padding slots (local id ≥ ``n_local``) are masked here
    — no real probe reaches them, but the mask keeps that unconditional.
    Cross-band duplicates remain (as in `walk_candidates`)."""
    starts, counts = sig_window_descriptors(ssig, qsigs, cap=cap)
    pos = enumerate_windows(starts, counts, budget=budget)
    flat = sids.reshape(-1)
    sent = torch.full_like(pos, SENTINEL)
    lid = torch.where(pos >= 0, flat[pos.clamp(min=0).long()], sent)
    return torch.where(lid < n_local, lid, sent)


def translate_local_ids(local_ids: torch.Tensor, lo: int) -> torch.Tensor:
    """Shard-local → global ids, ``l ↦ lo + l``; SENTINEL stays."""
    return torch.where(local_ids == SENTINEL, local_ids, local_ids + lo)
