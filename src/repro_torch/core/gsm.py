"""GSM — the paper's O(N²) baseline (Definition 3.1, Table 1),
`repro/core/gsm.py`.

S_{j1,j2} = n/(n+λ_ρ) · ρ_{j1,j2}, with ρ the Pearson similarity over
co-rating rows and n = |Ω̂_{j1} ∩ Ω̂_{j2}|.

The similarity is produced a block of rows at a time and only each row's
Top-K is kept, so the N×N matrix is never held whole; the dense [M, N]
value and indicator operands are (the memory overhead the paper charges
GSM with), and so are the quadratic FLOPs.  The products are
`torch.matmul` in float32 — never TF32, whatever the process's setting,
since the JAX package's parity is held at float32.  Many scores are
exactly 0 (pairs with no co-raters), so the selection breaks ties as
`lax.top_k` does (`topk.topk_first_index`: −0 below +0, equal scores
lower id first).
"""
from __future__ import annotations

import torch

from repro_torch.core.topk import topk_first_index
from repro_torch.data.sparse import SparseMatrix


def _dense_cols(sp: SparseMatrix):
    """Dense [M, N] value and indicator matrices (column-analysis
    layout), on ``sp``'s device."""
    r, c = sp.rows.long(), sp.cols.long()
    X = torch.zeros((sp.M, sp.N), dtype=torch.float32, device=sp.vals.device)
    B = torch.zeros_like(X)
    X[r, c] = sp.vals
    B[r, c] = 1.0
    return X, B


def gsm_topk(sp: SparseMatrix, *, K: int, lam_rho: float = 100.0,
             block: int = 512) -> torch.Tensor:
    """Exact shrunk-Pearson Top-K → J^K [N, K] int32 on ``sp``'s device,
    ``block`` rows of the similarity at a time."""
    prec = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")       # float32, no TF32
    try:
        X, B = _dense_cols(sp)
        cnt = torch.clamp(B.sum(0), min=1.0)
        mean = X.sum(0) / cnt
        Xc = (X - mean[None, :]) * B                  # centered, 0 at missing
        del X
        X2 = Xc * Xc
        N = sp.N
        cols = torch.arange(N, device=Xc.device)
        out = []
        for start in range(0, N, block):
            stop = min(start + block, N)
            sl, bl = Xc[:, start:stop], B[:, start:stop]
            num = sl.T @ Xc                     # Σ co-rated centred products
            n = bl.T @ B                        # co-rating counts
            d1 = bl.T @ X2                      # Σ (r−m)², the j2 side
            d2 = X2[:, start:stop].T @ B        # Σ (r−m)², the j1 side
            rho = num / torch.sqrt(torch.clamp(d2 * d1, min=1e-12))
            S = n / (n + lam_rho) * rho
            rows = torch.arange(start, stop, device=Xc.device)
            S = torch.where(cols[None, :] == rows[:, None],
                            torch.tensor(float("-inf"), device=S.device), S)
            out.append(topk_first_index(S, K).to(torch.int32))
        return torch.cat(out)
    finally:
        torch.set_float32_matmul_precision(prec)


def gsm_flops_bytes(M: int, N: int, K: int):
    """Hypothetical full-GSM cost (paper Fig. 1 / Table 7 'space
    overhead')."""
    flops = 2.0 * M * N * N * 3     # three N×N gram products
    bytes_full = 4.0 * N * N        # the materialized GSM the paper charges
    return flops, bytes_full
