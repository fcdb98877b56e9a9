"""Launch wrapper of the CUDA scorer (`csrc/candidate_score.cu`), the
Hopper counterpart of the TPU kernel `repro/kernels/candidate_score/
kernel.py::candidate_score_topn` and of the plumbing around it in
`repro/kernels/candidate_score/ops.py::score_candidates`: one launch
gathers the user rows, folds μ in, clips and masks the candidate ids,
scores, selects the top-N and translates slots back to item ids.

On CUDA tensors it launches the kernel or raises — it never falls back.
On CPU tensors it runs the plain version (`ref.score_topn_ref`).
``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, KernelValueError, check_operand
from repro_torch.kernels.candidate_score.ref import NEG, score_topn_ref

__all__ = ["NEG", "LAUNCHES", "score_topn"]

LAUNCHES = 0
_MAX_SMEM = 232_448          # bytes of shared memory a block may use
_WARPS = 16                  # kThreads / 32 in the CUDA source


def score_topn(row, mu, col, user_ids, cand, *, topn: int, tile_b: int = 8):
    """row [M, F+1] (U‖b), mu [] (μ), col [N, F+1] (V‖b̂), user_ids [B]
    int32, cand [B, C] int32 SENTINEL-padded → (scores [B, topn] f32,
    items [B, topn] int32, SENTINEL where a slot was padding).

    ``tile_b`` only shapes the plain version's gather tiles; the kernel
    runs one thread block per user, which holds the C scores and the
    user row in shared memory."""
    global LAUNCHES
    dev = row.device
    if dev.type == "cpu":
        return score_topn_ref(row, mu, col, user_ids, cand, topn=topn,
                              tile_b=tile_b)
    if dev.type != "cuda":
        raise KernelValueError(f"score_topn: unsupported device {dev}")
    check_operand(row, "row", torch.float32, 2, dev)
    check_operand(col, "col", torch.float32, 2, dev)
    check_operand(user_ids, "user_ids", torch.int32, 1, dev)
    check_operand(cand, "cand", torch.int32, 2, dev)
    if mu.device != dev or mu.dtype != torch.float32 or mu.numel() != 1:
        raise KernelValueError(
            f"score_topn: mu must be one float32 on {dev}, got "
            f"{mu.dtype} {tuple(mu.shape)} on {mu.device}")
    B, C = cand.shape
    (M, Fp1), N = row.shape, col.shape[0]
    if col.shape[1] != Fp1 or user_ids.shape[0] != B:
        raise KernelValueError(f"score_topn: row {tuple(row.shape)}, col "
                               f"{tuple(col.shape)}, user_ids "
                               f"{tuple(user_ids.shape)} and cand {(B, C)} "
                               f"disagree")
    if not 1 <= topn <= C:
        raise KernelValueError(f"need 1 ≤ topn ≤ C, got topn={topn}, C={C}")
    if M < 1 or N < 1 or Fp1 < 1:
        raise KernelValueError(f"score_topn: planes of {M} and {N} rows of "
                               f"{Fp1} floats")
    if (C + Fp1 + 2 * _WARPS * 32 + 2) * 4 > _MAX_SMEM:
        raise KernelValueError(f"score_topn: C={C} and F+1={Fp1} exceed a "
                               f"block's shared memory")
    scores = torch.empty((B, topn), dtype=torch.float32, device=dev)
    items = torch.empty((B, topn), dtype=torch.int32, device=dev)
    if B == 0:
        return scores, items
    err = _build.library().candidate_score_launch(
        row.data_ptr(), mu.data_ptr(), col.data_ptr(), user_ids.data_ptr(),
        cand.data_ptr(), scores.data_ptr(), items.data_ptr(), B, C, Fp1,
        topn, M, N, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "score_topn")
    LAUNCHES += 1
    return scores, items
