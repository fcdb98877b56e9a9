"""Plain PyTorch versions of the candidate scorer: the tile-level
gather + score + top-N (`repro/kernels/candidate_score/ref.py`) and the
flush-level `score_topn_ref` around it (`repro/kernels/candidate_score/
ops.py::score_candidates`), which the CUDA kernel computes in one launch.

Plane rows are gathered per tile of ``tile_b`` users, so the gather
intermediate is ``[tile_b, C, F+1]`` and the full ``[B, C, F]`` cube never
exists.  Top-N is a *stable* descending sort: equal scores keep the lower
slot first, the tie rule of `lax.top_k` and of the kernel's merge.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.topk import SENTINEL

NEG = -3e38     # effective -inf that survives f32 arithmetic (masked slots)


def candidate_score_topn_ref(urow, plane, cand, mask, *, topn: int,
                             tile_b: int = 8):
    """urow [B, F+1] (= U‖(μ+b) rows, pre-gathered); plane [N, F+1] = V‖b̂;
    cand [B, C] int32 ids (pre-clipped to [0, N)); mask [B, C] (1.0 valid)
    → (scores [B, topn] f32, idx [B, topn] int32 slots into C)."""
    B, C = cand.shape
    if C < topn:
        raise ValueError("need at least topn candidate slots")
    F = plane.shape[1] - 1
    scores, idx = [], []
    for t0 in range(0, B, tile_b):
        u = urow[t0:t0 + tile_b]
        rows = plane[cand[t0:t0 + tile_b].long()]           # [tb, C, F+1]
        s = (torch.einsum("bf,bcf->bc", u[:, :F], rows[..., :F])
             + rows[..., F] + u[:, F][:, None])
        s = torch.where(mask[t0:t0 + tile_b] > 0, s, torch.full_like(s, NEG))
        sv, si = torch.sort(s, dim=1, descending=True, stable=True)
        scores.append(sv[:, :topn])
        idx.append(si[:, :topn].to(torch.int32))
    if not scores:
        return (torch.empty((0, topn), dtype=torch.float32,
                            device=urow.device),
                torch.empty((0, topn), dtype=torch.int32, device=urow.device))
    return torch.cat(scores), torch.cat(idx)


def score_topn_ref(row, mu, col, user_ids, cand, *, topn: int,
                   tile_b: int = 8):
    """row [M, F+1] (U‖b), mu [] (μ), col [N, F+1] (V‖b̂), user_ids [B],
    cand [B, C] SENTINEL-padded ids → (scores [B, topn] f32, items
    [B, topn] int32, SENTINEL where a slot was padding): the user rows
    gathered (ids clamped to [0, M)) with μ folded into their bias
    column, ids clipped to [0, N), SENTINEL slots masked,
    `candidate_score_topn_ref`, and the slots translated back to item
    ids."""
    F = row.shape[1] - 1
    safe = cand.clamp(0, col.shape[0] - 1).contiguous()
    mask = (cand != SENTINEL).to(torch.float32)
    # ONE row-side gather; a user id past the rows (a user the loop has
    # trained but not yet published) reads the last row, as the kernel
    # and the JAX package's clamped gather do
    urow = row[user_ids.long().clamp(0, row.shape[0] - 1)]
    urow[:, F] += mu                               # bias col := μ + b_i
    scores, idx = candidate_score_topn_ref(urow, col, safe, mask, topn=topn,
                                           tile_b=tile_b)
    items = torch.gather(cand, 1, idx.long())
    items = torch.where(scores > NEG, items, torch.full_like(items, SENTINEL))
    return scores, items


def assert_topn_close(s, i, s_want, i_want, tol: float = 1e-5) -> float:
    """The agreement rule of the kernel with this version: scores within
    rtol/atol ``tol`` (the JAX package's tolerance), and slots equal
    wherever a score differs from its neighbours in the list by more than
    ``tol`` (the summation order differs, so exact near-ties may swap).
    Raises `AssertionError` otherwise; returns the max abs score error."""
    s, i, s_want, i_want = (x.cpu().numpy() if isinstance(x, torch.Tensor)
                            else np.asarray(x)
                            for x in (s, i, s_want, i_want))
    np.testing.assert_allclose(s, s_want, rtol=tol, atol=tol)
    gap = np.full(s_want.shape, np.inf)
    d = np.abs(np.diff(s_want, axis=1))
    gap[:, 1:] = np.minimum(gap[:, 1:], d)
    gap[:, :-1] = np.minimum(gap[:, :-1], d)
    sure = gap > tol
    np.testing.assert_array_equal(i[sure], i_want[sure])
    return float(np.abs(s - s_want).max()) if s.size else 0.0
