"""Carry trained state between the JAX package and the port as numpy.

A state trained by the JAX package (its `Params` leaves, its
`SparseMatrix` arrays, its `simlsh.encode` signatures) enters the port
through these functions, so both packages compute from identical state;
`to_numpy` goes the other way.  Only numpy and torch are imported here.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.model import Params
from repro_torch.data.sparse import SparseMatrix, from_coo
from repro_torch.device import resolve_device
from repro_torch.serve.index import LSHIndex, build_index


def params_from_numpy(U, V, b, bh, W, C, mu, device=None) -> Params:
    """Numpy parameter arrays (any float dtype) → float32 `Params`."""
    dev = resolve_device(device)
    f = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    return Params(U=f(U), V=f(V), b=f(b), bh=f(bh), W=f(W), C=f(C),
                  mu=f(mu).reshape(()))


def sparse_from_numpy(rows, cols, vals, shape, device=None) -> SparseMatrix:
    """COO arrays → `SparseMatrix` ((row, col)-sorted; an already sorted
    input keeps its order)."""
    return from_coo(np.asarray(rows, np.int32), np.asarray(cols, np.int32),
                    np.asarray(vals, np.float32), shape, device=device)


def index_from_numpy(sigs, tail_cap: int = 1024, device=None) -> LSHIndex:
    """[q, N] int32 signatures (e.g. the JAX package's `encode` output) →
    the port's `LSHIndex`."""
    return build_index(torch.tensor(np.asarray(sigs)),
                       tail_cap=tail_cap, device=device)


def to_numpy(x):
    """A tensor → ndarray; a dataclass of tensors → dict of its fields with
    every tensor as an ndarray (other fields unchanged)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if dataclasses.is_dataclass(x):
        return {f.name: to_numpy(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return x
