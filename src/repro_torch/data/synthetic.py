"""Synthetic sparse-interaction data with MovieLens-like statistics — the
port's own copy of the numpy-only `repro/data/synthetic.py` (the port
never imports the JAX package), so both packages draw the same triples
from the same seed.

The generator matches the structural statistics that drive the
algorithms: zipf-tailed user/item popularity (LSH bucket skew, schedule
load balance), a planted low-rank + neighbourhood signal (so RMSE
orderings between methods are meaningful) and bounded ratings.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    M: int
    N: int
    nnz: int
    rmin: float = 1.0
    rmax: float = 5.0
    rank: int = 8
    zipf_a: float = 1.2
    noise: float = 0.35
    neigh_groups: int = 0  # planted item-cluster count; 0 = N // 50


# Reduced-scale analogue of the paper's Table 2 MovieLens row
MOVIELENS_LIKE = DatasetSpec("movielens-like", 69_878, 10_677, 9_900_054)


def scaled(spec: DatasetSpec, scale: float) -> DatasetSpec:
    """``spec`` with M and N scaled by ``scale`` (at least 64 and 32) and
    the ratings by ``scale²`` (the density kept)."""
    return dataclasses.replace(
        spec,
        M=max(64, int(spec.M * scale)),
        N=max(32, int(spec.N * scale)),
        nnz=int(spec.nnz * scale * scale),
    )


def generate(spec: DatasetSpec, seed: int = 0):
    """COO triples (rows, cols, vals) and the planted item groups.

    Ground truth: r = clip(mid + amp·tanh(b_i + b_j + u_i·v_j + noise))
    where items of one group share a latent direction — the
    neighbourhood structure the Top-K methods exploit."""
    rng = np.random.default_rng(seed)
    M, N, nnz = spec.M, spec.N, spec.nnz

    # zipf popularity for both sides (sorted → id 0 most popular)
    pu = 1.0 / np.arange(1, M + 1) ** spec.zipf_a
    pi = 1.0 / np.arange(1, N + 1) ** spec.zipf_a
    pu /= pu.sum()
    pi /= pi.sum()

    # oversample until nnz unique pairs (zipf heads collide a lot)
    rows_l, cols_l, seen = [], [], 0
    want = nnz
    while seen < want:
        take = int((want - seen) * 2.0) + 1024
        r = rng.choice(M, size=take, p=pu).astype(np.int32)
        c = rng.choice(N, size=take, p=pi).astype(np.int32)
        rows_l.append(r)
        cols_l.append(c)
        key = np.concatenate(rows_l).astype(np.int64) * N + np.concatenate(cols_l)
        seen = len(np.unique(key))
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    key = rows.astype(np.int64) * N + cols
    _, uniq = np.unique(key, return_index=True)
    rng.shuffle(uniq)
    uniq = uniq[: nnz]
    rows, cols = rows[uniq], cols[uniq]

    G = spec.neigh_groups or max(4, N // 50)
    group = rng.integers(0, G, size=N)

    F = spec.rank
    u = rng.normal(0, 1.0 / np.sqrt(F), (M, F))
    v = rng.normal(0, 1.0 / np.sqrt(F), (N, F))
    gdir = rng.normal(0, 1.0 / np.sqrt(F), (G, F))
    v = v + 1.5 * gdir[group]  # planted neighbourhood signal

    mid = 0.5 * (spec.rmin + spec.rmax)
    amp = 0.5 * (spec.rmax - spec.rmin)
    bi = rng.normal(0, 0.25, M)
    bj = rng.normal(0, 0.25, N)
    raw = (u[rows] * v[cols]).sum(-1) + bi[rows] + bj[cols]
    raw = raw + rng.normal(0, spec.noise, raw.shape)
    vals = np.clip(mid + amp * np.tanh(raw), spec.rmin, spec.rmax).astype(np.float32)
    return rows, cols, vals, group


def add_noise(rng: np.random.Generator, vals, rate: float, rmin: float,
              rmax: float):
    """Paper Table 8 robustness protocol: corrupt ``rate`` of the ratings
    uniformly in [rmin, rmax) (a new array; ``vals`` is untouched)."""
    vals = vals.copy()
    k = int(len(vals) * rate)
    idx = rng.choice(len(vals), size=k, replace=False)
    vals[idx] = rng.uniform(rmin, rmax, size=k).astype(np.float32)
    return vals
