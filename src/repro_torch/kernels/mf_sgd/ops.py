"""The hyper-parameter vectors of the fused SGD steps over the packed
planes (`repro/kernels/mf_sgd/ops.py`).

The packed layout (`core.model.PackedParams`) makes a step two
gather/scatter pairs: one [B, F+1] row-plane pair (U and b) and one
[B, F+2K+1] col-plane pair (V, W, C and b̂).  On the card each step's
CUDA kernel does all of it in one launch, in place (`kernel.
culsh_sgd_tier` / `culsh_sgd_batch` for CULSH-MF, `kernel.mf_sgd_tier`
/ `mf_sgd_batch` for CUSGD++, which changes only the U and V columns);
`ref.apply_culsh_sgd_ref` and `ref.apply_mf_sgd_ref` are the plain
gather → step → delta scatter.  The conflict-free batch makes the
scatter race-free, so adding the per-row *delta* is exactly Eq. (5); a
padding slot adds 0 even where it repeats a live i or j.

The hyper-parameter vectors (`culsh_hyper`, `mf_hyper`) depend only on
the epoch's decay, so the epoch loop builds them once per epoch as device
tensors and no step reads a scalar from the host.
"""
from __future__ import annotations

import torch


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def culsh_hyper(hp, decay, mu) -> torch.Tensor:
    """The [13] vector of the CULSH-MF step: the six learning rates times
    ``decay``, the six regularizers and μ, on μ's device."""
    d = _f32(decay, mu.device)
    rates = [hp.a_b, hp.a_bh, hp.a_u, hp.a_v, hp.a_w, hp.a_c]
    regs = [hp.l_b, hp.l_bh, hp.l_u, hp.l_v, hp.l_w, hp.l_c]
    return torch.stack([a * d for a in rates]
                       + [_f32(x, mu.device) for x in regs]
                       + [mu.reshape(()).to(torch.float32)])


def mf_hyper(hp, decay, device) -> torch.Tensor:
    """The [4] vector (γu, γv, λu, λv) of the CUSGD++ step."""
    d = _f32(decay, device)
    return torch.stack([hp.a_u * d, hp.a_v * d, _f32(hp.l_u, device),
                        _f32(hp.l_v, device)])
