"""The SGD steps of a conflict-free batch on the packed planes
(`repro/kernels/mf_sgd/ops.py`).

The packed layout (`core.model.PackedParams`) makes a step two
gather/scatter pairs: one [B, F+1] row-plane pair (U and b) and one
[B, F+2K+1] col-plane pair (V, W, C and b̂).  For CULSH-MF the CUDA
kernel does all of it in one launch, in place (`kernel.culsh_sgd_batch`;
`ref.apply_culsh_sgd_ref` is the plain gather → step → delta scatter).
CUSGD++ gathers here, runs the tile kernel and scatters the deltas.  The
conflict-free batch makes the scatter race-free, so adding the per-row
*delta* is exactly Eq. (5); a padding slot, whose tile the step leaves
unchanged, adds 0 even where it repeats a live i or j.  The planes are
updated in place.

The hyper-parameter vectors (`culsh_hyper`, `mf_hyper`) depend only on
the epoch's decay, so the epoch loop builds them once per epoch as device
tensors and no step reads a scalar from the host.
"""
from __future__ import annotations

import torch

from repro_torch.core.model import Batch, PackedParams
from repro_torch.kernels import pick
from repro_torch.kernels.mf_sgd import kernel
from repro_torch.kernels.mf_sgd.ref import mf_sgd_step_ref


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
    """The [4] vector (γu, γv, λu, λv) of `mf_sgd_step`."""
    d = _f32(decay, device)
    return torch.stack([hp.a_u * d, hp.a_v * d, _f32(hp.l_u, device),
                        _f32(hp.l_v, device)])


def apply_mf_sgd(pp: PackedParams, bt: Batch, hpv: torch.Tensor, *,
                 impl: str = "auto", bce: bool = False) -> PackedParams:
    """CUSGD++ step of a conflict-free batch on the packed planes (only
    the U/V columns change); ``hpv`` from `mf_hyper`."""
    F = pp.F
    i, j = bt.i.long(), bt.j.long()
    u = pp.row[i, :F]
    v = pp.col[j, :F]
    fn = pick(impl, u.device, kernel.mf_sgd_step, mf_sgd_step_ref)
    u2, v2, _ = fn(u, v, bt.r, bt.valid, hpv, bce=bce)
    pp.row[:, :F].index_add_(0, i, u2 - u)
    pp.col[:, :F].index_add_(0, j, v2 - v)
    return pp

