"""Model parameters and the packed serving layout (`repro/core/model.py`).

Paper Eq. (1) — r̂_ij = b̄_ij + neighbourhood terms + u_i·v_jᵀ.  Serving
scores only the baseline and factor parts, so `ServePlanes` packs the
scoring-relevant parameters into one ``[M, F+1]`` row plane (U‖b) and one
``[N, F+1]`` col plane (V‖b̂): one gather per user and one per candidate
fetch factors and bias together.  The training layout (`PackedParams`)
belongs to the fit slice.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Params:
    """Unpacked parameters — the public API layout."""

    U: torch.Tensor   # [M, F]
    V: torch.Tensor   # [N, F]
    b: torch.Tensor   # [M]
    bh: torch.Tensor  # [N]
    W: torch.Tensor   # [N, K]
    C: torch.Tensor   # [N, K]
    mu: torch.Tensor  # []

    def to(self, device) -> "Params":
        return Params(*(getattr(self, f.name).to(device)
                        for f in dataclasses.fields(self)))


@dataclasses.dataclass(frozen=True)
class ServePlanes:
    """Packed serving layout.

    * ``row[:, :F]`` = U,  ``row[:, F]`` = b
    * ``col[:, :F]`` = V,  ``col[:, F]`` = b̂

    The `candidate_score` kernel gathers col-plane rows by candidate id
    inside the kernel, so no ``[B, C, F]`` cube is ever materialized.
    """

    row: torch.Tensor  # [M, F+1] float32 — U ‖ b
    col: torch.Tensor  # [N, F+1] float32 — V ‖ b̂
    mu: torch.Tensor   # []
    F: int

    @property
    def n_items(self) -> int:
        return self.col.shape[0]


def pack_serve_planes(p: Params) -> ServePlanes:
    """Params → the two serving planes (one concatenate per side)."""
    return ServePlanes(
        row=torch.cat([p.U, p.b[:, None]], dim=1).contiguous(),
        col=torch.cat([p.V, p.bh[:, None]], dim=1).contiguous(),
        mu=p.mu, F=int(p.U.shape[1]))


def unpack_serve_planes(sp: ServePlanes) -> Params:
    """Inverse of `pack_serve_planes`, with zero-width W/C planes (the
    serving score never uses them)."""
    F = sp.F
    z = torch.zeros((sp.col.shape[0], 0), dtype=torch.float32,
                    device=sp.col.device)
    return Params(U=sp.row[:, :F], V=sp.col[:, :F], b=sp.row[:, F],
                  bh=sp.col[:, F], W=z, C=z, mu=sp.mu)
