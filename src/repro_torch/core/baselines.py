"""Neighbour-selection baselines the paper compares simLSH against (Fig. 7
/ Table 7): random-K, RP_cos (cosine random-projection LSH) and minHash
(Jaccard) — `repro/core/baselines.py`.  All emit the same J^K [N, K]
interface as simLSH, so they drop into the identical CULSH-MF trainer.

Every draw is `repro_torch.prng`'s threefry, so `rand_topk` and
`minhash_signatures` equal the JAX package's bit for bit from the same
key.  `rp_cos_signatures` sums its projections with
`scatter.index_add_det_` (COO order on both devices, so it is
bit-reproducible and gives the card the CPU's bits); JAX's
`segment_sum` adds in another order, so a bit whose accumulator is
within ~1e-5 of 0 may differ from the JAX package's.
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.core import scatter, topk
from repro_torch.core.simlsh import SimLSHConfig, pack_bits, phi_rows
from repro_torch.data.sparse import SparseMatrix

_INT32_MAX = 2 ** 31 - 1


def rand_topk(key: torch.Tensor, N: int, K: int, *,
              device=None) -> torch.Tensor:
    """The paper's randomized control group: K uniform items per row
    (never the row's own id) → [N, K] int32 on ``device`` (by default
    the key's)."""
    dev = key.device if device is None else torch.device(device)
    self_id = torch.arange(N, dtype=torch.int32, device=dev)[:, None]
    r = prng.randint(key.to(dev), (N, K), 0, N)
    return torch.where(r == self_id, (r + 1) % N, r)


def _per_row(ids: torch.Tensor, draw):
    """``draw(row_ids)`` once per row id 0..max(ids), gathered per entry
    (the same values a per-entry draw gives, at one draw a row)."""
    n_rows = int(ids.max()) + 1 if ids.numel() else 0
    table = draw(torch.arange(n_rows, dtype=torch.int64, device=ids.device))
    return table[ids.long()]


def rp_cos_signatures(sp: SparseMatrix, cfg: SimLSHConfig,
                      key: torch.Tensor) -> torch.Tensor:
    """RP_cos: sign(Σ_{i∈Ω̂_j} r_ij · g_i) with *unweighted* projections
    (Ψ = identity, Φ ~ Rademacher) — simLSH without the Ψ rating-gap
    weighting → [q, N] int32 signatures on ``sp``'s device."""
    plan = scatter.segment_plan(sp.cols)          # one sort for all bands
    sigs = []
    for band in range(cfg.q):
        phi = _per_row(sp.rows, lambda ids: phi_rows(key, band, ids,
                                                     cfg.sig_bits))
        S = torch.zeros((sp.N, cfg.sig_bits), dtype=torch.float32,
                        device=sp.vals.device)
        scatter.index_add_det_(S, sp.cols.long(), sp.vals[:, None] * phi,
                               plan=plan)
        sigs.append(pack_bits(S >= 0))
    return torch.stack(sigs)


def minhash_signatures(sp: SparseMatrix, cfg: SimLSHConfig,
                       key: torch.Tensor) -> torch.Tensor:
    """minHash over the *support* of each column (value-blind, the
    drawback the paper calls out).  Elementary hash h of column j =
    min over i∈Ω̂_j of π_h(i) = ``randint(fold_in(fold_in(key, h), i),
    (), 0, 2³¹−1)``, bucketed to its low G bits (an empty column keeps
    int32 max, as `segment_min` leaves it); the p hashes of a band are
    packed G bits apart → [q, N] int32 on ``sp``'s device."""
    dev = sp.cols.device
    key = key.to(dev)
    cols = sp.cols.long()
    mask = (1 << cfg.G) - 1
    shift = (2 ** (cfg.G * torch.arange(cfg.p, dtype=torch.int64))).to(
        torch.int32).to(dev)[:, None]

    def one_hash(h: int) -> torch.Tensor:
        kb = prng.fold_in(key, h)
        pi = _per_row(sp.rows, lambda ids: prng.randint(
            prng.fold_in(kb, ids), (), 0, _INT32_MAX))
        mins = torch.full((sp.N,), _INT32_MAX, dtype=torch.int32,
                          device=dev)
        mins.scatter_reduce_(0, cols, pi, "amin", include_self=True)
        return mins & mask

    sigs = []
    for band in range(cfg.q):
        hs = torch.stack([one_hash(band * cfg.p + t) for t in range(cfg.p)])
        sigs.append((hs * shift).sum(0, dtype=torch.int32))
    return torch.stack(sigs)


def signatures_topk(sigs: torch.Tensor, key: torch.Tensor, *, K: int,
                    band_cap: int) -> torch.Tensor:
    return topk.topk_from_signatures(sigs, key, K=K, band_cap=band_cap)
