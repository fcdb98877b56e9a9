"""Serve-plane row gather → candidate gather + fused score + top-N
(`repro/kernels/candidate_score/ops.py`).

The *row* plane (U‖b, micro-batch-sized) is gathered here and μ folded
into its bias column; the *col* plane (V‖b̂) goes to the kernel whole,
which fetches candidate rows by id.  The returned top-N slots are
translated back to item ids, SENTINEL where a slot was padding.
"""
from __future__ import annotations

import torch

from repro_torch.core.model import ServePlanes
from repro_torch.core.topk import SENTINEL
from repro_torch.kernels import pick
from repro_torch.kernels.candidate_score import kernel
from repro_torch.kernels.candidate_score.ref import (NEG,
                                                    candidate_score_topn_ref)


def score_candidates(planes: ServePlanes, user_ids: torch.Tensor,
                     cand: torch.Tensor, *, topn: int, tile_b: int = 8,
                     impl: str = "auto"):
    """planes, user_ids [B], cand [B, C] SENTINEL-padded → (scores
    [B, topn] f32, items [B, topn] int32, SENTINEL where deficient)."""
    F = planes.F
    safe = cand.clamp(0, planes.n_items - 1).contiguous()
    mask = (cand != SENTINEL).to(torch.float32)
    urow = planes.row[user_ids.long()]             # ONE row-side gather
    urow[:, F] += planes.mu                        # bias col := μ + b_i
    fn = pick(impl, user_ids.device, kernel.candidate_score_topn,
              candidate_score_topn_ref)
    scores, idx = fn(urow, planes.col, safe, mask, topn=topn, tile_b=tile_b)
    items = torch.gather(cand, 1, idx.long())
    items = torch.where(scores > NEG, items, torch.full_like(items, SENTINEL))
    return scores, items
