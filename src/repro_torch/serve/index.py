"""Bucketed LSH index — the serving-side image of the paper's hash table
(`repro/serve/index.py`).

Each band's signatures are stored in sorted order with CSR-style bucket
offsets, so a probe is an O(1) slot lookup for items the index already
holds.  Layout per band b (all int32):

  sorted_sigs[b]  [N]  band signatures ascending      ┐ a bucket is the
  sorted_ids[b]   [N]  item id occupying each slot    │ contiguous slot
  bucket_lo[b]    [N]  first slot of the slot's bucket│ range [lo, hi)
  bucket_hi[b]    [N]  one-past-last slot of bucket   ┘
  slot_of[b]      [N]  item id → its slot (inverse permutation)

Online inserts go to a small *tail* buffer that probes scan linearly
(main+delta); when the tail would overflow, the index is rebuilt from the
full signature set (`needs_rebuild`, `rebuild`).  `insert` is functional:
it returns a new index and leaves the old one untouched, as the JAX
package's immutable arrays do.

The sharded serving tier partitions the items into nnz-balanced ranges
(`shard_bounds`) and builds the same per-band CSR per shard over its
*local* ids (`build_sharded_index` → `ShardedLSHIndex`, no tail).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.topk import SENTINEL
from repro_torch.device import resolve_device
from repro_torch.resil.validate import _MAX_ID, check_ids

# tail slots that hold no item: signatures pack into ≤ 30 bits, so int32
# min never matches a real signature
_EMPTY_SIG = -(2 ** 31)


@dataclasses.dataclass(frozen=True)
class LSHIndex:
    sorted_sigs: torch.Tensor   # [q, N] int32
    sorted_ids: torch.Tensor    # [q, N] int32
    bucket_lo: torch.Tensor     # [q, N] int32
    bucket_hi: torch.Tensor     # [q, N] int32
    slot_of: torch.Tensor       # [q, N] int32
    tail_sigs: torch.Tensor     # [q, T] int32 (_EMPTY_SIG where unused)
    tail_ids: torch.Tensor      # [T] int32 (SENTINEL where unused)
    n_base: int
    tail_cap: int
    tail_fill: int = 0          # occupied tail slots (host-side count)

    @property
    def q(self) -> int:
        return self.sorted_sigs.shape[0]

    @property
    def n_items(self) -> int:
        """Total items the index can answer for (base + current tail)."""
        return self.n_base + self.tail_fill

    @property
    def device(self) -> torch.device:
        return self.sorted_ids.device

    def to(self, device) -> "LSHIndex":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def _build_arrays(sigs: torch.Tensor):
    """The per-band CSR arrays of one [q, N] signature matrix.  The sort
    is stable, so equal signatures keep ascending item order (the order
    `jnp.argsort` gives)."""
    q, N = sigs.shape
    ssig, order = torch.sort(sigs, dim=1, stable=True)
    order = order.to(torch.int32)
    slot_of = torch.empty_like(order).scatter_(
        1, order.long(),
        torch.arange(N, dtype=torch.int32, device=sigs.device).expand(q, N)
        .contiguous())
    lo = torch.searchsorted(ssig, ssig, right=False, out_int32=True)
    hi = torch.searchsorted(ssig, ssig, right=True, out_int32=True)
    return ssig.contiguous(), order.contiguous(), lo, hi, slot_of


def build_index(sigs, *, tail_cap: int = 1024, device=None) -> LSHIndex:
    """sigs [q, N] int32 (from `core.simlsh.encode`) → persistent index on
    ``device``.  Item ids are the column positions 0..N-1."""
    dev = resolve_device(device)
    if isinstance(sigs, np.ndarray):
        sigs = torch.from_numpy(sigs)
    if sigs.dtype != torch.int32:
        hint = (" (float signatures usually mean a NaN-poisoned pipeline "
                "— pass simlsh.pack_bits output)"
                if sigs.dtype.is_floating_point else "")
        raise TypeError(f"build_index: signatures must be int32, got "
                        f"{sigs.dtype}{hint}")
    if sigs.ndim != 2:
        raise ValueError(f"build_index: expected [q, N] signatures, got "
                         f"shape {tuple(sigs.shape)}")
    if sigs.shape[1] > _MAX_ID:
        raise ValueError(f"build_index: item ids must stay below 2^30 (the "
                         f"dedup hash mask); got N={sigs.shape[1]}")
    sigs = sigs.to(dev)
    q, N = sigs.shape
    ssig, order, lo, hi, slot_of = _build_arrays(sigs)
    return LSHIndex(
        sorted_sigs=ssig, sorted_ids=order, bucket_lo=lo, bucket_hi=hi,
        slot_of=slot_of,
        tail_sigs=torch.full((q, tail_cap), _EMPTY_SIG, dtype=torch.int32,
                             device=dev),
        tail_ids=torch.full((tail_cap,), SENTINEL, dtype=torch.int32,
                            device=dev),
        n_base=N, tail_cap=tail_cap, tail_fill=0)


def insert(index: LSHIndex, new_sigs, new_ids) -> LSHIndex:
    """Append new items (Alg. 4 online ingestion) to the tail buffer.

    ``new_sigs`` [q, n] int32, ``new_ids`` [n] non-negative ids below
    2³⁰ (`PoisonBatchError` otherwise).  Raises if the tail would
    overflow — the caller then `rebuild`s (see `needs_rebuild`)."""
    new_ids = torch.as_tensor(new_ids)
    new_sigs = torch.as_tensor(new_sigs)
    n = int(new_ids.shape[0])
    tl = index.tail_fill
    if tl + n > index.tail_cap:
        raise ValueError(
            f"tail overflow ({tl}+{n} > {index.tail_cap}): rebuild the index")
    if new_sigs.dtype.is_floating_point:
        raise TypeError(
            f"insert: signatures must be int32, got {new_sigs.dtype} — "
            f"float signatures usually mean a NaN-poisoned pipeline")
    if n:            # integer ids in [0, 2^30), else PoisonBatchError
        check_ids(new_ids, what="insert new_ids")
    tail_sigs = index.tail_sigs.clone()
    tail_ids = index.tail_ids.clone()
    tail_sigs[:, tl:tl + n] = new_sigs.to(tail_sigs)
    tail_ids[tl:tl + n] = new_ids.to(tail_ids)
    return dataclasses.replace(index, tail_sigs=tail_sigs, tail_ids=tail_ids,
                               tail_fill=tl + n)


def _sig_of_items(index: LSHIndex, ids: torch.Tensor) -> torch.Tensor:
    """Band signatures for item ids that live in the index.  ids [...] →
    [q, ...]; unknown/SENTINEL ids get _EMPTY_SIG (match nothing)."""
    in_base = (ids >= 0) & (ids < index.n_base)
    safe = ids.clamp(0, index.n_base - 1).reshape(-1).long()
    slots = index.slot_of[:, safe].long()                          # [q, Q]
    base_sig = torch.gather(index.sorted_sigs, 1, slots).reshape(
        (index.q,) + ids.shape)

    # tail path: linear match over the (small) tail buffer
    tmatch = index.tail_ids[None, :] == ids.reshape(-1)[:, None]   # [Q, T]
    if index.tail_cap:
        tslot = torch.argmax(tmatch.to(torch.int8), dim=1)         # [Q]
        thit = tmatch.any(dim=1).reshape(ids.shape)
        tail_sig = index.tail_sigs[:, tslot].reshape((index.q,) + ids.shape)
    else:
        thit = torch.zeros(ids.shape, dtype=torch.bool, device=ids.device)
        tail_sig = base_sig
    empty = torch.full_like(base_sig, _EMPTY_SIG)
    return torch.where(in_base, base_sig,
                       torch.where(thit, tail_sig, empty))


def window_slices(index: LSHIndex, item_ids: torch.Tensor, *, cap: int):
    """Per-(item, band) bucket-window descriptors.

    item_ids [B, S] → (starts, lens), both [B, q·S] int32.  ``starts`` are
    flat positions into ``sorted_ids.reshape(-1)`` (band b's slots occupy
    [b·N, (b+1)·N)); ``lens`` ∈ [0, cap] is the number of valid slots from
    the start.  The window is centred on the item's own slot and clipped
    to its bucket.  Invalid (SENTINEL / out-of-range / tail-resident)
    items get length 0.  A ``cap``-wide read at a start may run past the
    bucket and, in the last band, past the array: read the ids through
    `padded_flat_ids`, whose SENTINEL apron keeps that in bounds."""
    B, S = item_ids.shape
    q, Nn = index.q, index.n_base
    valid = (item_ids != SENTINEL) & (item_ids >= 0) & (item_ids < Nn)
    safe = item_ids.clamp(0, Nn - 1)
    base = (torch.arange(q, dtype=torch.int32, device=item_ids.device)
            * Nn)[:, None, None]                                   # [q,1,1]
    slot = index.slot_of.reshape(-1)[(base + safe[None]).long()]   # [q,B,S]
    fslot = (base + slot).long()
    lo = index.bucket_lo.reshape(-1)[fslot]
    hi = index.bucket_hi.reshape(-1)[fslot]
    st = torch.minimum(torch.maximum(slot - cap // 2, lo),
                       torch.maximum(hi - cap, lo))
    zero = torch.zeros_like(st)
    ln = torch.where(valid[None], torch.minimum(st + cap, hi) - st, zero)
    st = torch.where(valid[None], st + base, zero)
    starts = st.permute(1, 0, 2).reshape(B, q * S).contiguous()
    lens = ln.permute(1, 0, 2).reshape(B, q * S).contiguous()
    return starts, lens


def padded_flat_ids(index: LSHIndex, *, cap: int) -> torch.Tensor:
    """``sorted_ids`` flattened to [q·N + cap] with a SENTINEL apron, so a
    static ``cap``-wide read at any `window_slices` start stays in bounds.
    Cache the result per index version — it copies the whole id plane."""
    return torch.cat([
        index.sorted_ids.reshape(-1),
        torch.full((cap,), SENTINEL, dtype=torch.int32, device=index.device)])


def needs_rebuild(index: LSHIndex, incoming: int = 0) -> bool:
    return index.tail_fill + incoming > index.tail_cap


def rebuild(index: LSHIndex, sigs) -> LSHIndex:
    """Fold the tail back into the sorted core from the full [q, N']
    signatures, on the index's device."""
    return build_index(sigs, tail_cap=index.tail_cap, device=index.device)


def signatures_of(index: LSHIndex) -> torch.Tensor:
    """The full [q, n_base] signature matrix of a built index
    (``sigs[b, g] = sorted_sigs[b, slot_of[b, g]]``)."""
    return torch.gather(index.sorted_sigs, 1, index.slot_of.long())


def _tail_matches(index: LSHIndex, tsig: torch.Tensor, qsig: torch.Tensor,
                  *, width: int) -> torch.Tensor:
    """Up to ``width`` tail ids whose band signature equals the query's,
    in tail order.  tsig [..., T], qsig [..., B] → [..., B, min(width, T)]
    (any leading band axes broadcast), SENTINEL-padded."""
    T = tsig.shape[-1]
    match = tsig[..., None, :] == qsig[..., :, None]               # [.., B, T]
    slots = torch.arange(T, dtype=torch.int32, device=tsig.device)
    key = torch.where(match, slots, T)
    key = torch.sort(key, dim=-1).values[..., :min(width, T)]
    ids = index.tail_ids[key.clamp(0, max(T - 1, 0)).long()]
    return torch.where(key < T, ids, torch.full_like(ids, SENTINEL))


def _bands_to_rows(x: torch.Tensor) -> torch.Tensor:
    """[q, B, w] per-band candidates → [B, q·w], band-major per row."""
    q, B, w = x.shape
    return x.permute(1, 0, 2).reshape(B, q * w)


def _probe_core(index: LSHIndex, qsig: torch.Tensor, cap: int):
    """For each band b and query signature qsig[b, k]: the first ``cap``
    slots of the bucket whose signature equals it (binary search).
    qsig [q, Q] → [q, Q, cap] ids, SENTINEL where the bucket ends."""
    ssig = index.sorted_sigs
    N = ssig.shape[1]
    lo = torch.searchsorted(ssig, qsig.contiguous(), out_int32=True)
    pos = lo[..., None] + torch.arange(cap, dtype=torch.int32,
                                       device=ssig.device)        # [q, Q, cap]
    ok = pos < N
    pos = pos.clamp(0, N - 1).long()
    flat = pos.reshape(index.q, -1)
    ok &= torch.gather(ssig, 1, flat).reshape(pos.shape) == qsig[..., None]
    ids = torch.gather(index.sorted_ids, 1, flat).reshape(pos.shape)
    return torch.where(ok, ids, torch.full_like(ids, SENTINEL))


def lookup_signatures(index: LSHIndex, qsigs: torch.Tensor, *, cap: int,
                      n_probe: int = 1) -> torch.Tensor:
    """Probe with explicit band signatures.  qsigs [B, q] → cand [B, L]
    int32 with L = q·n_probe·cap + q·cap (tail), SENTINEL-padded.

    Multi-probe: probe t ∈ [0, n_probe) XORs bit (t−1) into the query
    signature (probe 0 is the exact bucket)."""
    B, q = qsigs.shape
    masks = torch.tensor([0] + [1 << t for t in range(n_probe - 1)],
                         dtype=torch.int32, device=qsigs.device)
    probed = qsigs.T[:, :, None] ^ masks                     # [q, B, P]
    core = _probe_core(index, probed.reshape(q, -1), cap)    # [q, B·P, cap]
    core = _bands_to_rows(core.reshape(q, B, n_probe * cap))
    tail = _tail_matches(index, index.tail_sigs, qsigs.T.contiguous(),
                         width=cap)                          # [q, B, cap]
    return torch.cat([core, _bands_to_rows(tail)], dim=1)


def lookup_items(index: LSHIndex, item_ids: torch.Tensor, *, cap: int,
                 include_tail: bool = True,
                 assume_base: bool = False) -> torch.Tensor:
    """Bucket-mates of items already in the index.  item_ids [B] → cand
    [B, q·cap (+ q·cap tail)] int32, SENTINEL-padded (includes the item
    itself).  ``include_tail=False`` skips the tail scan;
    ``assume_base=True`` promises every valid query id lives in the
    sorted core (true whenever the tail is empty), which skips the
    signature-probe fallback for tail-resident query items.

    A base item's bucket is addressed by its slot, and the window is
    centred on that slot and clipped to the bucket, so huge buckets
    spread their mates instead of always returning the bucket head."""
    q, N = index.q, index.n_base
    B = item_ids.shape[0]
    dev = item_ids.device
    in_base = (item_ids != SENTINEL) & (item_ids >= 0) & (item_ids < N)
    safe = item_ids.clamp(0, N - 1).long().expand(q, B)
    slot = torch.gather(index.slot_of, 1, safe)                    # [q, B]
    lo = torch.gather(index.bucket_lo, 1, slot.long())
    hi = torch.gather(index.bucket_hi, 1, slot.long())
    start = torch.minimum(torch.maximum(slot - cap // 2, lo),
                          torch.maximum(hi - cap, lo))
    pos = start[..., None] + torch.arange(cap, dtype=torch.int32,
                                          device=dev)              # [q, B, cap]
    ok = in_base[None, :, None] & (pos < hi[..., None])
    pos = pos.clamp(0, N - 1).long()
    core = torch.gather(index.sorted_ids, 1, pos.reshape(q, -1)).reshape(
        pos.shape)
    core = torch.where(ok, core, torch.full_like(core, SENTINEL))
    qsigs = None
    if not assume_base:
        # tail-resident query items have no slot — find their base bucket
        # by binary search on the signature instead
        qsigs = _sig_of_items(index, item_ids)                     # [q, B]
        core = torch.where(in_base[None, :, None], core,
                           _probe_core(index, qsigs, cap))
    core = _bands_to_rows(core)
    if not include_tail:
        return core
    if qsigs is None:
        qsigs = _sig_of_items(index, item_ids)
    tail = _tail_matches(index, index.tail_sigs, qsigs, width=cap)
    return torch.cat([core, _bands_to_rows(tail)], dim=1)


# ---------------------------------------------------------------------------
# Sharded index.  Each shard builds the per-band CSR above over its own
# items in a local id space 0..n_d−1, block-padded to the largest extent:
# padding slots carry `_EMPTY_SIG`, which sorts before every real
# signature and matches no probe, so they form one inert bucket at the
# front of each band.  Slice d of the stacked [D, ...] arrays is shard
# d's local index.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardedLSHIndex:
    """Per-shard bucket CSR over local ids, stacked on a leading shard
    axis.  Global id ``g`` of shard ``d`` (``bounds[d] ≤ g < bounds[d+1]``)
    is local id ``g − bounds[d]``; local ids ≥ ``n_local[d]`` are
    padding.  No tail: the sharded tier serves a complete catalog, and
    online inserts go through the single-device tail + rebuild path."""

    sorted_sigs: torch.Tensor   # [D, q, block] int32, ascending per band
    sorted_ids: torch.Tensor    # [D, q, block] int32 local ids
    bucket_lo: torch.Tensor     # [D, q, block] int32
    bucket_hi: torch.Tensor     # [D, q, block] int32
    slot_of: torch.Tensor       # [D, q, block] int32 local id → slot
    n_local: torch.Tensor       # [D] int32 real (non-padding) items per shard
    bounds: torch.Tensor        # [D+1] int32 global cut points
    n_items: int
    block: int

    @property
    def shards(self) -> int:
        return self.sorted_sigs.shape[0]

    @property
    def q(self) -> int:
        return self.sorted_sigs.shape[1]


def shard_bounds(counts: np.ndarray, shards: int) -> np.ndarray:
    """nnz-balanced item cuts for the serving shards: ``counts [N]`` are
    the items' rating counts → ``bounds [D+1]``.  The extent floor of
    N/(4·D) bounds the block padding at ~4× on zipf catalogs, whose head
    shard would otherwise shrink to a few very popular items."""
    from repro_torch.data.sparse import balanced_bounds   # no cycle
    N, D = len(counts), shards
    return balanced_bounds(np.asarray(counts), D,
                           floor=max(1, N // (4 * max(D, 1))))


def build_sharded_index(sigs, *, shards: int,
                        counts: np.ndarray | None = None,
                        bounds: np.ndarray | None = None) -> ShardedLSHIndex:
    """sigs [q, N] int32 → the block-padded per-shard CSR stack on
    ``sigs``'s device.  ``bounds`` (explicit cuts) wins over ``counts``
    (nnz-balanced cuts, `shard_bounds`); with neither, the id range is
    cut evenly.  The guards of `build_index` apply."""
    if isinstance(sigs, np.ndarray):
        sigs = torch.from_numpy(sigs)
    if sigs.dtype != torch.int32:
        raise TypeError(f"build_sharded_index: signatures must be int32, "
                        f"got {sigs.dtype}")
    if sigs.ndim != 2:
        raise ValueError(f"build_sharded_index: expected [q, N] signatures, "
                         f"got shape {tuple(sigs.shape)}")
    q, N = sigs.shape
    if N > _MAX_ID:
        raise ValueError(f"build_sharded_index: item ids must stay below "
                         f"2^30 (the dedup hash mask); got N={N}")
    if shards < 1 or N < shards:
        raise ValueError(f"build_sharded_index: need 1 ≤ shards ≤ N, got "
                         f"shards={shards}, N={N}")
    if bounds is None:
        bounds = (shard_bounds(counts, shards) if counts is not None else
                  np.linspace(0, N, shards + 1).astype(np.int64))
    bounds = np.asarray(bounds, np.int64)
    if (len(bounds) != shards + 1 or bounds[0] != 0 or bounds[-1] != N
            or np.any(np.diff(bounds) < 1)):
        raise ValueError(f"build_sharded_index: bounds {bounds} must be "
                         f"strictly increasing from 0 to N={N}")
    dev = sigs.device
    ext = np.diff(bounds)
    block = int(ext.max())
    parts = []
    for d in range(shards):
        part = torch.full((q, block), _EMPTY_SIG, dtype=torch.int32,
                          device=dev)
        part[:, :int(ext[d])] = sigs[:, int(bounds[d]):int(bounds[d + 1])]
        parts.append(_build_arrays(part))
    ssig, sids, lo, hi, slot = (torch.stack(a) for a in zip(*parts))
    return ShardedLSHIndex(
        sorted_sigs=ssig, sorted_ids=sids, bucket_lo=lo, bucket_hi=hi,
        slot_of=slot,
        n_local=torch.tensor(ext, dtype=torch.int32, device=dev),
        bounds=torch.tensor(bounds, dtype=torch.int32, device=dev),
        n_items=N, block=block)


def shard_local_view(index: ShardedLSHIndex, d: int) -> LSHIndex:
    """Shard ``d``'s arrays as a plain tail-less `LSHIndex` over its
    ``block`` local ids (padding slots included as `_EMPTY_SIG` items) —
    for validation and tests."""
    dev = index.sorted_sigs.device
    return LSHIndex(
        sorted_sigs=index.sorted_sigs[d], sorted_ids=index.sorted_ids[d],
        bucket_lo=index.bucket_lo[d], bucket_hi=index.bucket_hi[d],
        slot_of=index.slot_of[d],
        tail_sigs=torch.full((index.q, 0), _EMPTY_SIG, dtype=torch.int32,
                             device=dev),
        tail_ids=torch.full((0,), SENTINEL, dtype=torch.int32, device=dev),
        n_base=index.block, tail_cap=0, tail_fill=0)
