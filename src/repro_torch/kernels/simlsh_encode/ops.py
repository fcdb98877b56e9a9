"""ELL packing + Φ draw → the simlsh_encode kernel
(`repro/kernels/simlsh_encode/ops.py`).

``encode_band`` reproduces `core.simlsh.band_accumulate` through the
kernel: each item's raters are ELL-padded to ``deg`` slots (data
movement, in PyTorch), Φ is drawn from the same keyed `prng` stream, and
the kernel does the weighted projection.  The ``[N, deg, bits]`` Φ is
materialized for one band at a time (1.7 GB at N = 10⁶, deg 24, bits
18), so callers pass ``deg`` = the largest item degree rounded up to 8
rather than the default 128.
"""
from __future__ import annotations

import torch

from repro_torch.core.simlsh import SimLSHConfig, phi_rows, psi
from repro_torch.data.sparse import SparseMatrix
from repro_torch.kernels import pick
from repro_torch.kernels.simlsh_encode import kernel
from repro_torch.kernels.simlsh_encode.ref import simlsh_encode_ref


def ell_pack(sp: SparseMatrix, deg: int):
    """Column-major ELL: rater ids + ratings per item, padded to ``deg``
    → (row_ids [N, deg] int32, 0-padded; vals [N, deg] f32, 0-padded).

    Raters are ranked by a stable sort of the columns, as the JAX
    package's `argsort`; an item with more than ``deg`` raters keeps its
    first ``deg`` and drops the rest."""
    dev = sp.cols.device
    order = torch.sort(sp.cols, stable=True).indices
    cols_s, rows_s, vals_s = sp.cols[order], sp.rows[order], sp.vals[order]
    first = torch.searchsorted(cols_s, torch.arange(sp.N, dtype=cols_s.dtype,
                                                    device=dev))
    rank = torch.arange(sp.nnz, device=dev) - first[cols_s.long()]
    keep = rank < deg
    addr = cols_s[keep].long() * deg + rank[keep]
    ids = torch.zeros(sp.N * deg, dtype=torch.int32, device=dev)
    vals = torch.zeros(sp.N * deg, dtype=torch.float32, device=dev)
    ids[addr] = rows_s[keep]
    vals[addr] = vals_s[keep]
    return ids.reshape(sp.N, deg), vals.reshape(sp.N, deg)


def band_operands(sp: SparseMatrix, cfg: SimLSHConfig, key, band: int, *,
                  deg: int = 128):
    """The kernel's inputs for one band: (ψ [N, deg] = Ψ(r)·(r ≠ 0), Φ
    [N, deg, bits]).  Φ is drawn once per row id and gathered into the
    ELL layout — the rows the JAX package draws per slot; padding slots
    carry row 0's Φ and weight 0."""
    ids, vals = ell_pack(sp, deg)
    w = psi(vals, cfg.psi_pow, cfg.psi_mode, cfg.psi_center) * (vals != 0)
    table = phi_rows(key, band, torch.arange(sp.M, device=ids.device),
                     cfg.sig_bits)
    return w, table[ids.long()]


def encode_band(sp: SparseMatrix, cfg: SimLSHConfig, key, band: int, *,
                deg: int = 128, impl: str = "auto"):
    """One band's pre-sign accumulators through the kernel → [N, bits]."""
    w, phi = band_operands(sp, cfg, key, band, deg=deg)
    fn = pick(impl, w.device, kernel.simlsh_encode, simlsh_encode_ref)
    return fn(w, phi)
