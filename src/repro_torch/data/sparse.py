"""Sparse interaction-matrix substrate (`repro/data/sparse.py`).

The COO triples of the rating matrix ``R ∈ R^{M×N}``, kept
(row, col)-lexicographically sorted so a user's ratings are one
contiguous run addressed with `torch.searchsorted`.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SparseMatrix:
    """COO sparse matrix, (row, col)-lexicographically sorted."""

    rows: torch.Tensor  # [nnz] int32, sorted (major)
    cols: torch.Tensor  # [nnz] int32, sorted within row (minor)
    vals: torch.Tensor  # [nnz] float32
    shape: tuple[int, int]

    @property
    def M(self) -> int:
        return self.shape[0]

    @property
    def N(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    def to(self, device) -> "SparseMatrix":
        return dataclasses.replace(self, rows=self.rows.to(device),
                                   cols=self.cols.to(device),
                                   vals=self.vals.to(device))


def _tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A tensor moved/cast, or array data copied, to ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(x, dtype=dtype, device=device)


def from_coo(rows, cols, vals, shape, *, device=None) -> SparseMatrix:
    """Build a SparseMatrix from (unsorted, unique) COO triples.

    The order equals ``jnp.lexsort((cols, rows))``: a stable sort by the
    minor key followed by a stable sort by the major key."""
    dev = resolve_device(device)
    rows = _tensor(rows, torch.int32, dev)
    cols = _tensor(cols, torch.int32, dev)
    vals = _tensor(vals, torch.float32, dev)
    order = torch.sort(cols, stable=True).indices
    order = order[torch.sort(rows[order], stable=True).indices]
    M, N = shape
    return SparseMatrix(rows[order], cols[order], vals[order],
                        (int(M), int(N)))
