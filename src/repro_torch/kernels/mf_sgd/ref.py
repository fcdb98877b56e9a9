"""Plain PyTorch versions of the fused SGD steps, CUSGD++ and CULSH-MF
(`repro/kernels/mf_sgd/ref.py`), and of the fused steps over the packed
planes (`apply_mf_sgd_ref`, `apply_culsh_sgd_ref`).  The kernel wrappers
run these on CPU tensors, and the card's kernels are compared with
them."""
from __future__ import annotations

import torch

from repro_torch.core.model import Batch, PackedParams, predict_gathered


def mf_sgd_step_ref(u, v, r, valid, hp, *, bce: bool = False):
    """CUSGD++ on a conflict-free tile: u, v [B, F]; r, valid [B]; ``hp``
    [4] = (γu, γv, λu, λv) → (u′, v′, e), both updates from the stale
    u and v."""
    gamma_u, gamma_v, lam_u, lam_v = hp[0], hp[1], hp[2], hp[3]
    pred = (u * v).sum(-1)
    e = (r - (torch.sigmoid(pred) if bce else pred)) * valid
    eb = e[:, None]
    vm = valid[:, None]
    u2 = u + gamma_u * (eb * v - lam_u * u) * vm
    v2 = v + gamma_v * (eb * u - lam_v * v) * vm
    return u2, v2, e


def apply_mf_sgd_ref(pp: PackedParams, bt: Batch, hp, *,
                     bce: bool = False) -> PackedParams:
    """The fused CUSGD++ step of a conflict-free batch on the packed
    planes, in place (`repro/kernels/mf_sgd/ops.py::apply_mf_sgd`): gather
    u = U[i] and v = V[j], run `mf_sgd_step_ref`, scatter the deltas into
    the first F columns.  A padding slot, whose u and v come back
    unchanged, adds exactly 0 even where it repeats a live i or j.
    ``hp`` is the [4] vector of `ops.mf_hyper`."""
    F = pp.F
    i, j = bt.i.long(), bt.j.long()
    u = pp.row[i, :F]
    v = pp.col[j, :F]
    u2, v2, _ = mf_sgd_step_ref(u, v, bt.r, bt.valid, hp, bce=bce)
    pp.row[:, :F].index_add_(0, i, u2 - u)
    pp.col[:, :F].index_add_(0, j, v2 - v)
    return pp


def culsh_sgd_step_ref(row, col, rnb, bh_nb, expl, r, valid, hp, *,
                       bce: bool = False):
    """Fused six-parameter Eq. (5) step on a conflict-free packed tile.

    ``row [B, F+1]`` = U‖b and ``col [B, F+2K+1]`` = V‖W‖C‖b̂ are
    row-aligned gathers of the two planes; ``bh_nb [B, K]`` = b̂[J^K[j]];
    ``hp`` [13] = (γb, γb̂, γu, γv, γw, γc, λb, λb̂, λu, λv, λw, λc, μ)
    with the γ already decayed.  The Eq. (1) forward happens inside the
    step; every update reads the pre-update operands.  Returns the two
    updated tiles."""
    F = row.shape[-1] - 1
    K = rnb.shape[-1]
    gb, gbh, gu, gv, gw, gc = (hp[k] for k in range(6))
    lb, lbh, lu, lv, lw, lc = (hp[k] for k in range(6, 12))
    mu = hp[12]
    u, b = row[:, :F], row[:, F]
    v, w = col[:, :F], col[:, F:F + K]
    c, bh = col[:, F + K:F + 2 * K], col[:, F + 2 * K]
    impl = 1.0 - expl
    pred, aux = predict_gathered(mu, b, bh, u, v, w, c, bh_nb,
                                 rnb, expl, impl)
    resid, sR, sN = aux["resid"], aux["sR"], aux["sN"]
    e = (r - (torch.sigmoid(pred) if bce else pred)) * valid
    eb = e[:, None]
    vm = valid[:, None]
    b2 = b + gb * (e - lb * b) * valid
    bh2 = bh + gbh * (e - lbh * bh) * valid
    u2 = u + gu * (eb * v - lu * u) * vm
    v2 = v + gv * (eb * u - lv * v) * vm
    w2 = w + gw * (sR[:, None] * eb * resid - lw * w) * expl * vm
    c2 = c + gc * (sN[:, None] * eb - lc * c) * impl * vm
    row2 = torch.cat([u2, b2[:, None]], dim=1)
    col2 = torch.cat([v2, w2, c2, bh2[:, None]], dim=1)
    return row2, col2


def apply_culsh_sgd_ref(pp: PackedParams, bt: Batch, hp, *,
                        bce: bool = False) -> PackedParams:
    """The fused CULSH-MF step of a conflict-free batch on the packed
    planes, in place (`repro/kernels/mf_sgd/ops.py::apply_culsh_sgd`):
    gather both plane rows and the neighbour baselines b̂[J^K[j]] before
    the step (a neighbour col of one slot may be another slot's j), run
    `culsh_sgd_step_ref`, scatter the deltas.  A padding slot, whose tile
    comes back unchanged, adds exactly 0 even where it repeats a live i or
    j.  ``hp`` is the [13] vector of `ops.culsh_hyper`."""
    i, j = bt.i.long(), bt.j.long()
    row = pp.row[i]                                  # [B, F+1]
    col = pp.col[j]                                  # [B, F+2K+1]
    bh_nb = pp.bh[bt.nb.long()]                      # [B, K]
    row2, col2 = culsh_sgd_step_ref(row, col, bt.rnb, bh_nb, bt.expl, bt.r,
                                    bt.valid, hp, bce=bce)
    pp.row.index_add_(0, i, row2 - row)
    pp.col.index_add_(0, j, col2 - col)
    return pp
