"""Launch wrapper of the CUDA candidate gather + score + top-N kernel
(`csrc/candidate_score.cu`), the Hopper counterpart of the TPU kernel
`repro/kernels/candidate_score/kernel.py::candidate_score_topn`.

On CUDA tensors it launches the kernel or raises — it never falls back.
On CPU tensors it runs the plain version (`ref.candidate_score_topn_ref`).
``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, check_operand
from repro_torch.kernels.candidate_score.ref import (NEG, NEG2,
                                                    candidate_score_topn_ref)

__all__ = ["NEG", "NEG2", "LAUNCHES", "candidate_score_topn"]

LAUNCHES = 0
_MAX_SMEM = 232_448          # bytes of shared memory a block may use
_WARPS = 8                   # kThreads / 32 in the CUDA source


def candidate_score_topn(urow, plane, cand, mask, *, topn: int,
                         tile_b: int = 8):
    """urow [B, F+1] (U‖(μ+b) rows); plane [N, F+1] (V‖b̂); cand [B, C]
    int32 ids pre-clipped to [0, N); mask [B, C] f32 (1.0 valid) →
    (scores [B, topn] f32, idx [B, topn] int32 slots into C).

    ``tile_b`` only shapes the plain version's gather tiles; the kernel
    runs one thread block per user."""
    global LAUNCHES
    dev = urow.device
    if dev.type == "cpu":
        return candidate_score_topn_ref(urow, plane, cand, mask, topn=topn,
                                        tile_b=tile_b)
    if dev.type != "cuda":
        raise ValueError(f"candidate_score_topn: unsupported device {dev}")
    check_operand(urow, "urow", torch.float32, 2, dev)
    check_operand(plane, "plane", torch.float32, 2, dev)
    check_operand(cand, "cand", torch.int32, 2, dev)
    check_operand(mask, "mask", torch.float32, 2, dev)
    B, C = cand.shape
    N, Fp1 = plane.shape
    if urow.shape != (B, Fp1) or mask.shape != (B, C):
        raise ValueError(f"candidate_score_topn: urow {tuple(urow.shape)}, "
                         f"plane {tuple(plane.shape)}, cand {(B, C)} and "
                         f"mask {tuple(mask.shape)} disagree")
    if not 1 <= topn <= C:
        raise ValueError(f"need 1 ≤ topn ≤ C, got topn={topn}, C={C}")
    if N < 1 or Fp1 < 1:
        raise ValueError("candidate_score_topn: empty serve plane")
    if (Fp1 + C + 2 * _WARPS) * 4 > _MAX_SMEM:
        raise ValueError(f"candidate_score_topn: C={C} exceeds a block's "
                         f"shared memory")
    scores = torch.empty((B, topn), dtype=torch.float32, device=dev)
    idx = torch.empty((B, topn), dtype=torch.int32, device=dev)
    lib = _build.library()
    err = lib.candidate_score_topn_launch(
        urow.data_ptr(), plane.data_ptr(), cand.data_ptr(), mask.data_ptr(),
        scores.data_ptr(), idx.data_ptr(), B, C, Fp1, topn, N,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "candidate_score_topn")
    LAUNCHES += 1
    return scores, idx
