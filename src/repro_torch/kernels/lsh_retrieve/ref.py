"""Plain PyTorch version of the LSH bucket walk + dedup kernel
(`repro/kernels/lsh_retrieve/ref.py`).

Window descriptors come in (flat starts + valid lengths from
`serve.index.window_slices`); each descriptor is expanded as a ``cap``-wide
read of the padded flat id plane, extras (tail hits) are appended,
exclusions and invalid slots are masked, and the surviving ids are
deduplicated through the invertible 30-bit multiplicative hash.  The
output is each user's first C unique ids in *hashed* order.

The hash is taken in int64 and masked to 30 bits, which gives the same
bits as the JAX package's wrapping int32 product.
"""
from __future__ import annotations

import torch

from repro_torch.core.topk import SENTINEL

# invertible multiplicative hash pair: h = 2654435761·x mod 2³⁰,
# x = 244002641·h mod 2³⁰ (MULT is 2654435761 as a signed int32)
MULT = -1640531535
INV = 244002641
MASK30 = 0x3FFFFFFF
# sort-domain padding: above every 30-bit hash, so padding sinks last
INTMAX = 0x7FFFFFFF


def lsh_retrieve_topc_ref(starts, lens, extra, ids_flat, exclude, *,
                          C: int, cap: int) -> torch.Tensor:
    """starts/lens [B, I] int32 (`window_slices` descriptors); extra
    [B, X] int32 SENTINEL-padded ids appended to the pool (tail hits);
    ids_flat [q·N + cap] int32 (`padded_flat_ids`); exclude [E] int32 ids
    dropped from the output (SENTINEL entries inert) → cand [B, C] int32,
    each user's unique pool ids in hashed order, SENTINEL-padded."""
    B, I = starts.shape
    d = torch.arange(cap, dtype=torch.int32, device=starts.device)
    ids = ids_flat[(starts[:, :, None] + d).long()]                # [B,I,cap]
    ok = d[None, None, :] < lens[:, :, None]
    pool = torch.cat(
        [torch.where(ok, ids, torch.full_like(ids, SENTINEL)).reshape(
            B, I * cap), extra], dim=1).to(torch.int64)
    excluded = (pool[:, :, None] == exclude.to(torch.int64)[None, None, :]
                ).any(dim=2)
    valid = (pool != SENTINEL) & (pool >= 0) & ~excluded
    h = torch.where(valid, (pool * MULT) & MASK30,
                    torch.full_like(pool, INTMAX))
    h = torch.sort(h, dim=1).values
    prev = torch.cat([torch.full_like(h[:, :1], -1), h[:, :-1]], dim=1)
    h = torch.where((h != prev) & (h != INTMAX), h, torch.full_like(h, INTMAX))
    h = torch.sort(h, dim=1).values[:, :C]
    return torch.where(h != INTMAX, (h * INV) & MASK30,
                       torch.full_like(h, SENTINEL)).to(torch.int32)
