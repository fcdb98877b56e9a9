"""Divergence guard — a parameter-norm watchdog with snapshot rollback
(`repro/resil/guard.py`).

The online path (`core.online.online_update`) trains new rows and
columns with plain SGD on whatever ΔΩ arrived.  A hostile or buggy delta
(huge ratings that slipped past validation, a mis-set learning rate) can
blow the new parameters up to inf/NaN, and since serving packs the
parameters into planes wholesale, one diverged update poisons every
later score.

`check_divergence` compares the trained parameters with the
pre-training snapshot:

  * any non-finite entry in a grown slice trips immediately;
  * the RMS of each grown slice (U and b rows ≥ M_old; V, b̂, W and C
    columns ≥ N_old) must stay within ``max_ratio`` × the RMS of the
    corresponding *old* parameters, floored at ``eps``.

The statistics are float64 reductions on the parameters' own device, read
back once, so a guard on the card copies no plane to the host.  On a trip
the caller raises `DivergenceError` before the new state is built: the
input state is unmodified, so rollback is "keep what you had".
"""
from __future__ import annotations

import dataclasses

import torch


class DivergenceError(RuntimeError):
    """An online update trained diverged parameters and was rolled back —
    the caller's pre-update state is unmodified."""


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """``max_ratio`` is deliberately loose: legitimate new vectors train
    from ~1/√F noise up to the old parameters' scale, and 100× beyond
    that scale is never a converged model."""
    max_ratio: float = 100.0
    eps: float = 1e-3


def _rms(a: torch.Tensor) -> torch.Tensor:
    """Float64 RMS of ``a`` as a 0-dim tensor on its device (0 if empty)."""
    if not a.numel():
        return torch.zeros((), dtype=torch.float64, device=a.device)
    return torch.sqrt(torch.mean(torch.square(a.double())))


def check_divergence(p_new, p_old, *, M_old: int, N_old: int,
                     cfg: GuardConfig = GuardConfig()) -> list:
    """Problem strings for the grown slices of ``p_new`` against the
    old-parameter scale of ``p_old`` (empty = healthy).  The online path
    calls it once per update, after training, before the state swap."""
    slices = [
        ("U", p_new.U[M_old:], p_old.U), ("b", p_new.b[M_old:], p_old.b),
        ("V", p_new.V[N_old:], p_old.V), ("bh", p_new.bh[N_old:], p_old.bh),
        ("W", p_new.W[N_old:], p_old.W), ("C", p_new.C[N_old:], p_old.C),
    ]
    slices = [s for s in slices if s[1].numel()]
    if not slices:
        return []
    dev = slices[0][1].device
    stats = torch.stack([torch.stack([
        torch.isfinite(new).all().double(), _rms(new).to(dev),
        _rms(old).to(dev)]) for _, new, old in slices]).cpu().tolist()
    probs: list = []
    for (name, _, _), (finite, r, old_rms) in zip(slices, stats):
        if not finite:
            probs.append(f"{name}: non-finite entries in the newly trained "
                         f"slice")
            continue
        scale = max(old_rms, cfg.eps)
        if r > cfg.max_ratio * scale:
            probs.append(f"{name}: new-slice RMS {r:.3g} exceeds "
                         f"{cfg.max_ratio:g}× the old-param scale "
                         f"{scale:.3g}")
    return probs
