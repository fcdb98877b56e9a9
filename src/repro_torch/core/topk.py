"""Top-K nearest-neighbour extraction from LSH band signatures
(`repro/core/topk.py`).

A sort-based replacement of the paper's hash-table probe (Alg. 1 lines
10–12):

  1. per band: a stable argsort of the signatures; items adjacent in sort
     order with an *equal* signature are bucket-mates, and each item takes
     up to ``band_cap`` of them (a window around its sorted position);
  2. across bands: per item, sort the q·band_cap candidate ids, count
     equal runs, keep the K most frequent (ties: the lower id first, as
     `lax.top_k` orders them) and fill any deficit with random items.

Both tie rules are stable sorts here, so J^K equals the JAX package's
bit for bit from the same signatures and key.
"""
from __future__ import annotations

import torch

from repro_torch import prng

SENTINEL = 2 ** 31 - 1   # int32 max: pads every candidate/id tensor


def band_candidates(sig: torch.Tensor, *, band_cap: int) -> torch.Tensor:
    """One band's candidates: sig [N] int32 → [N, band_cap] int32 item ids
    sharing this band's signature, SENTINEL-padded."""
    N = sig.shape[0]
    dev = sig.device
    order = torch.sort(sig, stable=True).indices
    ssig = sig[order]
    half = band_cap // 2
    offs = torch.cat([torch.arange(1, half + 1, device=dev),
                      -torch.arange(1, band_cap - half + 1, device=dev)])
    pos = torch.arange(N, device=dev)[:, None] + offs[None, :]
    ok = (pos >= 0) & (pos < N)
    pos = pos.clamp(0, N - 1)
    same = ok & (ssig[pos] == ssig[:, None])
    cand_sorted = torch.where(same, order[pos], SENTINEL).to(torch.int32)
    out = torch.full((N, band_cap), SENTINEL, dtype=torch.int32, device=dev)
    out[order] = cand_sorted          # back to original item order
    return out


def topk_frequent(cands: torch.Tensor, key: torch.Tensor, *,
                  K: int) -> torch.Tensor:
    """cands [N, L] (SENTINEL-padded) → the K most frequent per row
    [N, K] int32.  Deficit rows are filled with random items ≠ self
    (`prng.randint`, not de-duplicated against the found neighbours —
    the paper's cheap "random supplement")."""
    N, L = cands.shape
    dev = cands.device
    self_id = torch.arange(N, dtype=torch.int32, device=dev)[:, None]
    cands = torch.where(cands == self_id, SENTINEL, cands).to(torch.int32)
    c = torch.sort(cands, dim=1).values
    first = torch.searchsorted(c, c, side="left")
    last = torch.searchsorted(c, c, side="right")
    is_head = first == torch.arange(L, device=dev)
    score = torch.where(is_head & (c != SENTINEL), last - first, -1)
    # lax.top_k's tie rule (lower index first) is a stable descending sort
    top = torch.sort(score, dim=1, descending=True, stable=True)
    top_scores, top_idx = top.values[:, :K], top.indices[:, :K]
    nbrs = torch.gather(c, 1, top_idx)
    rand = prng.randint(key.to(dev), (N, K), 0, N)
    rand = torch.where(rand == self_id, (rand + 1) % N, rand)
    return torch.where(top_scores > 0, nbrs, rand).to(torch.int32)


def topk_from_signatures(sigs: torch.Tensor, key: torch.Tensor, *, K: int,
                         band_cap: int) -> torch.Tensor:
    """sigs [q, N] int32 → J^K [N, K] int32 (the paper's Top-K matrix)."""
    if sigs.dtype != torch.int32:
        raise TypeError(f"signatures must be int32, got {sigs.dtype}")
    cands = torch.stack([band_candidates(s, band_cap=band_cap)
                         for s in sigs])                   # [q, N, cap]
    cands = cands.permute(1, 0, 2).reshape(sigs.shape[1], -1)
    return topk_frequent(cands, key, K=K)


def topk_first_index(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Row-wise top-``k`` column ids of float32 ``scores`` [B, N] as
    int64, in `lax.top_k`'s order: a float's total order (−0 below +0),
    equal scores lower id first.  A `topk` over int64 keys that pack the
    score's order-preserving int32 image above the complement of the
    id, so every key is distinct and no tie is left to the sort."""
    bits = scores.contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    N = scores.shape[1]
    rank = torch.arange(N - 1, -1, -1, dtype=torch.int64,
                        device=scores.device)                  # N−1−id
    return torch.topk((ordered << 32) | rank, k, dim=1).indices
