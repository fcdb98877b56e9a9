"""Plain PyTorch version of the neighbor_predict kernel (Eq. 1 fused
prediction, `repro/kernels/neighbor_predict/ref.py`).  The kernel wrapper
runs it on CPU tensors, and the card's kernel is compared with it."""
from __future__ import annotations


def neighbor_predict_ref(u, v, w, c, resid, impl, bbar, sR, sN):
    """Row-aligned operands (u, v [B, F]; w, c, resid, impl [B, K]; bbar,
    sR, sN [B]) → pred [B]."""
    dot = (u * v).sum(-1)
    expl = (resid * w).sum(-1)
    imp = (impl * c).sum(-1)
    return bbar + sR * expl + sN * imp + dot
