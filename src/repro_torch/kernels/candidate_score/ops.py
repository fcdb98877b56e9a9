"""Candidate scoring of a flush (`repro/kernels/candidate_score/ops.py`).

The *row* plane (U‖b) and the *col* plane (V‖b̂) go to the scorer whole:
it gathers the users' rows and the candidates' rows by id, folds μ into
the user's bias, masks SENTINEL slots, scores, selects the top-N and
translates the slots back to item ids, SENTINEL where a slot was padding
— on the card in one launch of the CUDA kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core.model import ServePlanes
from repro_torch.kernels import pick
from repro_torch.kernels.candidate_score import kernel
from repro_torch.kernels.candidate_score.ref import score_topn_ref


def score_candidates(planes: ServePlanes, user_ids: torch.Tensor,
                     cand: torch.Tensor, *, topn: int, tile_b: int = 8,
                     impl: str = "auto"):
    """planes, user_ids [B], cand [B, C] SENTINEL-padded → (scores
    [B, topn] f32, items [B, topn] int32, SENTINEL where deficient)."""
    fn = pick(impl, user_ids.device, kernel.score_topn, score_topn_ref)
    return fn(planes.row, planes.mu, planes.col, user_ids, cand, topn=topn,
              tile_b=tile_b)
