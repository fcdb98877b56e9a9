"""simLSH — the paper's C1 contribution, Eq. (3) (`repro/core/simlsh.py`).

Encoding: for item (column) j,  H̄_j = Υ( Σ_{i∈Ω̂_j} Ψ(r_ij) · Φ(H_i) )
where H_i is a random G-bit string per row i, Φ maps {0,1}→{−1,+1},
Ψ is a rating weighting (r^ψ) and Υ = sign→bit.  A *coarse* group ANDs p
hashes into one p·G-bit signature and q such bands are ORed.

Φ rows are generated functionally from (seed, band, row id), so any row
id — including rows that arrive later — maps to a fixed hash row without
storing H.  The port's generator is its own counter-based integer hash,
not JAX's threefry: the same seed gives other bits than the JAX package
(see `phi_rows`).  Every function that draws Φ therefore also takes a
precomputed Φ, which is how the parity tests feed both packages the
same rows.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.data.sparse import SparseMatrix

_M32 = 0xFFFFFFFF


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


def _mul32(x, c: int):
    """(x · c) mod 2³² for x in [0, 2³²) (int64 tensor or int) and a 32-bit
    constant c, split so that no partial product reaches 2⁶³."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _fmix32(x):
    """MurmurHash3's 32-bit finalizer (full avalanche)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def phi_rows(seed: int, band: int, ids: torch.Tensor,
             bits: int) -> torch.Tensor:
    """±1 hash rows Φ(H_i) for arbitrary row ids → [len(ids), bits] f32.

    Stateless and keyed by (seed, band, id) like the JAX package's
    ``rademacher(fold_in(fold_in(key, band), id))``, so it stays
    online-safe; but it is a counter-based integer hash (MurmurHash3's
    finalizer over the key), NOT threefry, and does not reproduce the
    JAX package's bits."""
    k = _fmix32(_fmix32(int(seed) & _M32) ^ (int(band) & _M32))
    h = _fmix32(_mul32(ids.to(torch.int64) & _M32, 0x9E3779B1) ^ k)
    g = _mul32(torch.arange(1, bits + 1, dtype=torch.int64,
                            device=ids.device), 0x85EBCA77)
    h = _fmix32(h[:, None] ^ g[None, :])
    return (1 - 2 * (h >> 31)).to(torch.float32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., nbits] bool → int32 signature (nbits ≤ 30)."""
    w = 2 ** torch.arange(bits.shape[-1], dtype=torch.int32,
                          device=bits.device)
    return (bits.to(torch.int32) * w).sum(-1, dtype=torch.int32)


def band_accumulate(sp_rows, sp_cols, sp_vals, seed: int, band: int, *,
                    N: int, bits: int, psi_pow: float, psi_mode: str = "pow",
                    psi_center: float = 0.0,
                    phi: torch.Tensor | None = None) -> torch.Tensor:
    """Pre-sign accumulator S_j = Σ Ψ(r_ij) Φ(H_i) for one band → [N, bits].

    ``phi`` [nnz, bits], when given, replaces the port's own Φ rows (one
    per COO entry, e.g. the JAX package's `phi_rows(key, band, rows)`).
    Otherwise Φ is drawn once per distinct row id and gathered per entry.
    The segment sum is an `index_add_`, whose summation order differs
    from JAX's `segment_sum`: accumulators near 0 may change sign."""
    if phi is None:
        n_rows = int(sp_rows.max()) + 1 if sp_rows.numel() else 0
        table = phi_rows(seed, band, torch.arange(n_rows, device=sp_rows.device),
                         bits)
        phi = table[sp_rows.long()]
    contrib = psi(sp_vals, psi_pow, psi_mode, psi_center)[:, None] * phi
    S = torch.zeros((N, bits), dtype=torch.float32, device=sp_vals.device)
    return S.index_add_(0, sp_cols.long(), contrib)


def encode(sp: SparseMatrix, cfg: SimLSHConfig, seed: int = 0, *,
           phi: torch.Tensor | None = None,
           return_accumulators: bool = False):
    """All q band signatures → sigs [q, N] int32, on ``sp``'s device (and
    the accumulators [q, N, p·G] f32 when requested).  ``phi`` [q, nnz,
    p·G], when given, supplies each band's Φ rows (see
    `band_accumulate`)."""
    sigs, accs = [], []
    for band in range(cfg.q):
        S = band_accumulate(
            sp.rows, sp.cols, sp.vals, seed, band, N=sp.N, bits=cfg.sig_bits,
            psi_pow=cfg.psi_pow, psi_mode=cfg.psi_mode,
            psi_center=cfg.psi_center,
            phi=None if phi is None else phi[band])
        sigs.append(pack_bits(S >= 0))
        if return_accumulators:
            accs.append(S)
    sigs = torch.stack(sigs)
    if return_accumulators:
        return sigs, torch.stack(accs)
    return sigs
