"""simLSH candidate selection for the LM softmax (the paper's technique
applied to the vocabulary; `repro/models/lsh_softmax.py`).

The output-embedding table E [V, D] is the "item" side of an MF: simLSH
hashes its rows exactly like LSH-MF hashes item columns (random ±1
projections + sign, p·G-bit signatures, q bands).  A training step's
candidate set is the labels' bucket-mates (the tokens most confusable
with the targets, whose logits matter for the normaliser), a strided
sample of them, padded with random negatives.

The draws are the JAX package's (`prng`: Φ by `rademacher` under
``fold_in(key, band)``, the negatives by `randint`), and the strided
sample's positions are XLA's float32 arithmetic for `jnp.linspace`
(`_linspace_int32`), so from the same signatures and keys the candidates are the
reference's bit for bit.  A signature bit may differ from the
reference's only where its float32 sum ``E[v]·Φ`` lies within rounding
of 0.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import prng
from repro_torch.core import topk
from repro_torch.core.simlsh import SimLSHConfig, pack_bits


@dataclasses.dataclass
class LSHSoftmaxState:
    sigs: torch.Tensor    # [q, V] band signatures of embedding rows
    nbrs: torch.Tensor    # [V, K] bucket-mates per token
    step: torch.Tensor    # refresh bookkeeping


def hash_embeddings(E: torch.Tensor, cfg: SimLSHConfig,
                    key: torch.Tensor) -> torch.Tensor:
    """Dense-row simLSH: sig[b, v] = pack(sign(E[v] @ Φ_b)) → [q, V]
    int32."""
    D = E.shape[1]
    E32 = E.float()
    out = []
    for band in range(cfg.q):
        phi = prng.rademacher(prng.fold_in(key, band), (D, cfg.sig_bits),
                              device=E.device)
        out.append(pack_bits(E32 @ phi >= 0))
    return torch.stack(out)


@torch.no_grad()
def refresh(E: torch.Tensor, key: torch.Tensor, *, K: int = 8,
            band_cap: int = 8, q: int = 8, G: int = 8,
            p: int = 2) -> LSHSoftmaxState:
    """Hash E's rows and find each token's K bucket-mates."""
    cfg = SimLSHConfig(G=G, p=p, q=q, band_cap=band_cap)
    sigs = hash_embeddings(E, cfg, key)
    nbrs = topk.topk_from_signatures(sigs, key, K=K, band_cap=band_cap)
    return LSHSoftmaxState(sigs=sigs, nbrs=nbrs, step=torch.zeros(
        (), dtype=torch.int32, device=E.device))


def _linspace_int32(n: int, take: int, device) -> torch.Tensor:
    """``jnp.linspace(0, n - 1, take).astype(int32)`` as XLA computes it.
    `jnp.linspace` forms ``start·(1 − i/div) + stop·(i/div)`` in float32
    for i < div = take − 1 and appends ``stop``; with the constants of
    ``candidates_for`` XLA rewrites the division as a product by the
    float32 reciprocal of div and folds ``stop`` into it, so position i
    holds ``i · fl(fl(1/div) · stop)``, truncated.  (`torch.linspace`
    fills the upper half of the range from its end, and the unfolded
    formula rounds differently: both differ at some positions.)"""
    if take <= 1:
        return torch.zeros((take,), dtype=torch.int32, device=device)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    stop = f32(float(n - 1))
    c = (f32(1.0) / f32(float(take - 1))) * stop
    out = torch.arange(take - 1, dtype=torch.float32, device=device) * c
    return torch.cat([out, stop[None]]).to(torch.int32)


@torch.no_grad()
def candidates_for(state: LSHSoftmaxState, labels: torch.Tensor,
                   key: torch.Tensor, *, n_cands: int) -> torch.Tensor:
    """The labels' bucket-mates, a strided sample of them, padded with
    random negatives: labels [B, S] → cands [n_cands] int32 (shared
    across the batch: one gather of E rows per step)."""
    V = state.nbrs.shape[0]
    mates = state.nbrs[labels.reshape(-1).long()].reshape(-1)   # [B·S·K]
    mates = torch.sort(mates).values
    take = min(n_cands // 2, mates.shape[0])
    picked = mates[_linspace_int32(mates.shape[0], take,
                                   mates.device).long()]
    rand = prng.randint(key, (n_cands - take,), 0, V,
                        device=mates.device)
    return torch.cat([picked, rand.to(picked.dtype)])
