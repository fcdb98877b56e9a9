"""simLSH — the paper's C1 contribution, Eq. (3) (`repro/core/simlsh.py`).

Encoding: for item (column) j,  H̄_j = Υ( Σ_{i∈Ω̂_j} Ψ(r_ij) · Φ(H_i) )
where H_i is a random G-bit string per row i, Φ maps {0,1}→{−1,+1},
Ψ is a rating weighting (r^ψ) and Υ = sign→bit.  A *coarse* group ANDs p
hashes into one p·G-bit signature and q such bands are ORed.

Φ rows are generated functionally from (key, band, row id), so any row
id — including rows that arrive later — maps to a fixed hash row without
storing H.  The draws are `jax.random`'s threefry, reproduced bit for bit
by `repro_torch.prng`, so the same key gives the JAX package's Φ and
signatures (up to the summation order of the segment sum, see
`band_accumulate`).  Every function that draws Φ also takes precomputed
rows (``phi=``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import prng
from repro_torch.core import scatter
from repro_torch.data.sparse import SparseMatrix


@dataclasses.dataclass(frozen=True)
class SimLSHConfig:
    G: int = 8          # bits per elementary hash
    p: int = 3          # coarse-grained: hashes ANDed into one signature
    q: int = 20         # fine-grained: signature bands ORed
    psi_pow: float = 2.0  # Ψ(r) = r^psi_pow  (paper: ψ ∈ {1, 2, 4})
    psi_mode: str = "pow"  # pow | centered: Ψ(r) = sign(r−c)·|r−c|^ψ
    psi_center: float = 0.0
    band_cap: int = 8   # max candidates contributed per band

    @property
    def sig_bits(self) -> int:
        return self.G * self.p

    def __post_init__(self):
        if self.sig_bits > 30:
            raise ValueError("signature must pack into int32 (p·G ≤ 30)")


def psi(vals: torch.Tensor, psi_pow: float, psi_mode: str = "pow",
        psi_center: float = 0.0) -> torch.Tensor:
    if psi_mode == "centered":
        d = vals - psi_center
        return torch.sign(d) * torch.pow(torch.abs(d), psi_pow)
    return torch.pow(vals, psi_pow)


def phi_rows(key: torch.Tensor, band: int, ids: torch.Tensor,
             bits: int) -> torch.Tensor:
    """±1 hash rows Φ(H_i) for arbitrary row ids → [len(ids), bits] f32,
    on ``ids``' device: ``rademacher(fold_in(fold_in(key, band), i))``
    per id, equal to the JAX package's `phi_rows` bit for bit."""
    kb = prng.fold_in(key.to(ids.device), band)
    return prng.rademacher(prng.fold_in(kb, ids.to(torch.int64)), (bits,))


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., nbits] bool → int32 signature (nbits ≤ 30)."""
    w = 2 ** torch.arange(bits.shape[-1], dtype=torch.int32,
                          device=bits.device)
    return (bits.to(torch.int32) * w).sum(-1, dtype=torch.int32)


def band_accumulate(sp_rows, sp_cols, sp_vals, key, band: int, *,
                    N: int, bits: int, psi_pow: float, psi_mode: str = "pow",
                    psi_center: float = 0.0,
                    phi: torch.Tensor | None = None,
                    plan: scatter.SegmentPlan | None = None) -> torch.Tensor:
    """Pre-sign accumulator S_j = Σ Ψ(r_ij) Φ(H_i) for one band → [N, bits].

    ``phi`` [nnz, bits], when given, replaces the drawn Φ rows (one per
    COO entry).  Otherwise Φ is drawn from ``key`` once per row id and
    gathered per entry — the same rows the JAX package draws per entry.
    The segment sum is `scatter.index_add_det_` (``plan``: the sort of
    ``sp_cols``, shared by every band): it adds in COO order on both
    devices, so it is bit-reproducible, and gives the same bits on the
    card as on the CPU; that order differs from JAX's `segment_sum`, so
    accumulators near 0 may change sign against the JAX package's."""
    if phi is None:
        n_rows = int(sp_rows.max()) + 1 if sp_rows.numel() else 0
        table = phi_rows(key, band,
                         torch.arange(n_rows, device=sp_rows.device), bits)
        phi = table[sp_rows.long()]
    contrib = psi(sp_vals, psi_pow, psi_mode, psi_center)[:, None] * phi
    S = torch.zeros((N, bits), dtype=torch.float32, device=sp_vals.device)
    return scatter.index_add_det_(S, sp_cols.long(), contrib, plan=plan)


def encode(sp: SparseMatrix, cfg: SimLSHConfig,
           key: torch.Tensor | None = None, *,
           phi: torch.Tensor | None = None,
           return_accumulators: bool = False):
    """All q band signatures → sigs [q, N] int32, on ``sp``'s device (and
    the accumulators [q, N, p·G] f32 when requested).  ``phi`` [q, nnz,
    p·G], when given, supplies each band's Φ rows (see
    `band_accumulate`); otherwise they are drawn from the `prng` key
    ``key``, as the JAX package's `encode(sp, cfg, key)` draws them."""
    if key is None and phi is None:
        raise ValueError("encode needs a prng key or precomputed phi rows")
    sigs, accs = [], []
    plan = scatter.segment_plan(sp.cols)          # one sort for all bands
    for band in range(cfg.q):
        S = band_accumulate(
            sp.rows, sp.cols, sp.vals, key, band, N=sp.N, bits=cfg.sig_bits,
            psi_pow=cfg.psi_pow, psi_mode=cfg.psi_mode,
            psi_center=cfg.psi_center,
            phi=None if phi is None else phi[band], plan=plan)
        sigs.append(pack_bits(S >= 0))
        if return_accumulators:
            accs.append(S)
    sigs = torch.stack(sigs)
    if return_accumulators:
        return sigs, torch.stack(accs)
    return sigs


def update_accumulators(S: torch.Tensor, new_rows, new_cols, new_vals,
                        cfg: SimLSHConfig, key: torch.Tensor, N_total: int):
    """Alg. 4 lines 1–6: fold ΔΩ into the cached accumulators and re-sign.

    ``S`` is [q, N_old, bits]; columns ≥ N_old are new items (appended as
    zeros before ΔΩ is added).  Each band's ΔΩ contribution is
    `band_accumulate` with Φ drawn from ``key`` — the key ``S`` was encoded
    with, else new items land in random buckets.  → (S' [q, N_total,
    bits], sigs' [q, N_total] int32), on ``S``'s device."""
    q, N_old, bits = S.shape
    if N_total > N_old:
        S = torch.cat([S, torch.zeros((q, N_total - N_old, bits),
                                      dtype=S.dtype, device=S.device)], dim=1)
    dev = S.device
    rows = torch.as_tensor(new_rows, dtype=torch.int32).to(dev)
    cols = torch.as_tensor(new_cols, dtype=torch.int32).to(dev)
    vals = torch.as_tensor(new_vals, dtype=torch.float32).to(dev)
    plan = scatter.segment_plan(cols)
    S2 = torch.stack([
        S[band] + band_accumulate(rows, cols, vals, key, band, N=N_total,
                                  bits=bits, psi_pow=cfg.psi_pow,
                                  psi_mode=cfg.psi_mode,
                                  psi_center=cfg.psi_center, plan=plan)
        for band in range(q)])
    return S2, pack_bits(S2 >= 0)
