"""Batched retrieval building blocks of the serving walk path
(`repro/serve/retrieve.py`).

A user's candidates are the bucket-mates (across all bands) of their
*seed items* — their highest-rated observed items — plus tail items
(online inserts not yet folded into the sorted core) that collide with
any seed in any band.  The kernel path turns the seeds into window
descriptors (`index.window_slices`) and the `lsh_retrieve` kernel walks
and deduplicates them; this module holds the two stages around it.
"""
from __future__ import annotations

import torch

from repro_torch.core.topk import SENTINEL
from repro_torch.data.sparse import SparseMatrix
from repro_torch.serve.index import LSHIndex, _sig_of_items


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
