"""Seeds → window descriptors → bucket walk + dedup → [B, C] candidate
ids (`repro/kernels/lsh_retrieve/ops.py`).

Host code builds only the micro-batch-sized descriptor tensors (starts/
lens [B, I], tail extras [B, X]); walking the bucket windows and
deduplicating their union happens inside the kernel against the
device-resident id plane.  The output feeds `score_candidates` directly.
"""
from __future__ import annotations

import torch

from repro_torch.core.topk import SENTINEL
from repro_torch.data.sparse import SparseMatrix
from repro_torch.kernels import pick
from repro_torch.kernels.lsh_retrieve import kernel
from repro_torch.kernels.lsh_retrieve.ref import lsh_retrieve_topc_ref
from repro_torch.serve.index import LSHIndex, padded_flat_ids, window_slices
from repro_torch.serve.retrieve import seed_items, tail_hits


def walk_descriptors(index: LSHIndex, sp: SparseMatrix,
                     user_ids: torch.Tensor, *, n_seeds: int, cap: int,
                     window: int = 64, tail_scan: bool = True):
    """The host-built operands of the kernel: user_ids [B] → (starts,
    lens [B, I] window descriptors, extra [B, X] tail hits, X ≥ 1)."""
    seeds = seed_items(sp, user_ids, n_seeds=n_seeds, window=window)
    starts, lens = window_slices(index, seeds, cap=cap)
    if tail_scan and index.tail_cap:
        extra = tail_hits(index, seeds).contiguous()
    else:                          # X ≥ 1 keeps the kernel's shape fixed
        extra = torch.full((user_ids.shape[0], 1), SENTINEL,
                           dtype=torch.int32, device=user_ids.device)
    return starts, lens, extra


def walk_topc(starts: torch.Tensor, lens: torch.Tensor, extra: torch.Tensor,
              ids_flat: torch.Tensor, popular: torch.Tensor | None, *,
              C: int, cap: int, impl: str = "auto") -> torch.Tensor:
    """Walk + dedup of the descriptors → cand [B, C]: the kernel (or its
    plain version, as ``impl`` picks) fills the core, and ``popular``
    [P], when given, occupies reserved trailing slots and is excluded
    from the core."""
    B = starts.shape[0]
    if popular is not None:
        P = popular.shape[0]
        if C <= P:
            raise ValueError(f"candidate budget C={C} must exceed the "
                             f"shortlist {P}")
        exclude, core_C = popular, C - P
    else:
        exclude = torch.full((1,), SENTINEL, dtype=torch.int32,
                             device=starts.device)
        core_C = C
    fn = pick(impl, starts.device, kernel.lsh_retrieve_topc,
              lsh_retrieve_topc_ref)
    core = fn(starts, lens, extra, ids_flat, exclude, C=core_C, cap=cap)
    if popular is None:
        return core
    return torch.cat([core, popular[None, :].expand(B, P)], dim=1)


def retrieve_candidates(index: LSHIndex, sp: SparseMatrix,
                        user_ids: torch.Tensor, *, n_seeds: int, cap: int,
                        C: int, popular: torch.Tensor | None = None,
                        window: int = 64, tail_scan: bool = True,
                        impl: str = "auto",
                        ids_flat: torch.Tensor | None = None) -> torch.Tensor:
    """user_ids [B] → cand [B, C] int32 unique candidate ids,
    SENTINEL-padded: `walk_descriptors` then `walk_topc`.  ``ids_flat``
    lets services pass a cached `padded_flat_ids` plane instead of
    re-concatenating it per flush."""
    starts, lens, extra = walk_descriptors(
        index, sp, user_ids, n_seeds=n_seeds, cap=cap, window=window,
        tail_scan=tail_scan)
    if ids_flat is None:
        ids_flat = padded_flat_ids(index, cap=cap)
    return walk_topc(starts, lens, extra, ids_flat, popular, C=C, cap=cap,
                     impl=impl)
