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
(main+delta).  `insert` is functional: it returns a new index and leaves
the old one untouched, as the JAX package's immutable arrays do.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.topk import SENTINEL
from repro_torch.device import resolve_device

# tail slots that hold no item: signatures pack into ≤ 30 bits, so int32
# min never matches a real signature
_EMPTY_SIG = -(2 ** 31)
_MAX_ID = 1 << 30     # ids at or above this alias in the dedup hash


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
    2³⁰.  Raises if the tail would overflow — the caller rebuilds."""
    new_ids = torch.as_tensor(new_ids)
    new_sigs = torch.as_tensor(new_sigs)
    n = int(new_ids.shape[0])
    tl = index.tail_fill
    if tl + n > index.tail_cap:
        raise ValueError(
            f"tail overflow ({tl}+{n} > {index.tail_cap}): rebuild the index")
    if new_ids.dtype.is_floating_point or new_sigs.dtype.is_floating_point:
        raise TypeError(
            f"insert: ids and signatures must be integers, got "
            f"{new_ids.dtype} / {new_sigs.dtype} — float signatures usually "
            f"mean a NaN-poisoned pipeline")
    if n and (int(new_ids.min()) < 0 or int(new_ids.max()) >= _MAX_ID):
        raise ValueError("insert: new ids must lie in [0, 2^30)")
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
