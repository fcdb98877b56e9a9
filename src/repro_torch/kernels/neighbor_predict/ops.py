"""Assemble the Eq. (1) operands of a `Batch` → the fused neighbor_predict
kernel (`repro/kernels/neighbor_predict/ops.py`).

The forward value of `core.model.predict`, for inference and eval only:
the fit's steps compute the same forward inside `kernels/mf_sgd`.  The
gathers stay in PyTorch, as they stay in XLA on the TPU; the kernel does
the three row-wise reductions and their affine sum.  The count scales are
``1/sqrt`` where `model.predict_gathered` takes ``rsqrt``, so the two
agree within 1e-4, not bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core.model import Batch, Params
from repro_torch.kernels import pick
from repro_torch.kernels.neighbor_predict import kernel
from repro_torch.kernels.neighbor_predict.ref import neighbor_predict_ref


def predict_operands(p: Params, bt: Batch):
    """The kernel's nine row-aligned inputs for ``bt`` (u, v, w, c,
    resid, impl, b̄, sR, sN), each contiguous."""
    i, j = bt.i.long(), bt.j.long()
    b_i = p.b[i]
    bbar = p.mu + b_i + p.bh[j]
    bbar_nb = p.mu + b_i[:, None] + p.bh[bt.nb.long()]
    resid = (bt.rnb - bbar_nb) * bt.expl
    nR = bt.expl.sum(1)
    nN = bt.impl.sum(1)
    sR = torch.where(nR > 0, 1.0 / torch.sqrt(nR.clamp(min=1.0)), 0.0)
    sN = torch.where(nN > 0, 1.0 / torch.sqrt(nN.clamp(min=1.0)), 0.0)
    return (p.U[i], p.V[j], p.W[j], p.C[j], resid, bt.impl.contiguous(),
            bbar, sR, sN)


def predict_batch(p: Params, bt: Batch, *, impl: str = "auto"):
    """Eq. (1) predictions of ``bt`` → [B] f32."""
    ops = predict_operands(p, bt)
    fn = pick(impl, ops[0].device, kernel.neighbor_predict,
              neighbor_predict_ref)
    return fn(*ops)
