"""Carry trained state between the JAX package and the port as numpy.

A state trained by the JAX package (its `Params` leaves or packed
training planes, its `SparseMatrix` arrays, its `simlsh.encode`
signatures, the `jax.random` key a fit goes on from, an Alg. 4
`OnlineState`) enters the port
through these functions, so both packages compute from identical state;
`to_numpy` goes the other way.  Only numpy and torch are imported here.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.model import PackedParams, Params
from repro_torch.core.online import OnlineState
from repro_torch.data.sparse import SparseMatrix, from_coo
from repro_torch.device import resolve_device
from repro_torch.serve.index import LSHIndex, build_index


def params_from_numpy(U, V, b, bh, W, C, mu, device=None) -> Params:
    """Numpy parameter arrays (any float dtype) → float32 `Params`."""
    dev = resolve_device(device)
    f = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    return Params(U=f(U), V=f(V), b=f(b), bh=f(bh), W=f(W), C=f(C),
                  mu=f(mu).reshape(()))


def packed_from_numpy(row, col, mu, F: int, K: int,
                      device=None) -> PackedParams:
    """The two training planes (the JAX package's `PackedParams.row` /
    ``.col``, as numpy) → `PackedParams`.  `to_numpy` is the inverse."""
    dev = resolve_device(device)
    f = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    row, col = f(row), f(col)
    if row.shape[1] != F + 1 or col.shape[1] != F + 2 * K + 1:
        raise ValueError(f"planes {tuple(row.shape)}, {tuple(col.shape)} do "
                         f"not fit F={F}, K={K}")
    return PackedParams(row=row, col=col, mu=f(mu).reshape(()), F=int(F),
                        K=int(K))


def key_from_numpy(key, device="cpu") -> torch.Tensor:
    """A JAX key's ``uint32[..., 2]`` words (``np.asarray`` of a legacy
    `jax.random.PRNGKey`, or `jax.random.key_data` of a typed key) → the
    port's `prng` key.  Keys stay on the CPU unless asked: the fit draws
    its batch order on the host."""
    a = np.asarray(key)
    if a.shape[-1:] != (2,) or a.dtype != np.uint32:
        raise ValueError(f"expected uint32[..., 2] key words, got "
                         f"{a.dtype}{list(a.shape)}")
    return torch.tensor(a.astype(np.int64), device=torch.device(device))


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


def online_state_from_numpy(params, S, JK, sp, hash_key, M: int, N: int,
                            device=None):
    """A JAX `OnlineState`'s arrays → the port's `OnlineState`.
    ``params`` maps the `Params` field names (U, V, b, bh, W, C, mu) to
    arrays; ``sp`` is a (rows, cols, vals) triple of the already sorted
    merged matrix; ``hash_key`` the key words (see `key_from_numpy`)."""
    dev = resolve_device(device)
    rows, cols, vals = sp
    return OnlineState(
        params=params_from_numpy(**{k: params[k] for k in (
            "U", "V", "b", "bh", "W", "C", "mu")}, device=dev),
        S=torch.tensor(np.asarray(S, np.float32), device=dev),
        JK=torch.tensor(np.asarray(JK, np.int32), device=dev),
        sp=sparse_from_numpy(rows, cols, vals, (M, N), device=dev),
        M=int(M), N=int(N),
        hash_key=None if hash_key is None else key_from_numpy(hash_key))


def ncf_params_from_numpy(tree: dict, device=None) -> dict:
    """The JAX package's NCF parameter dict (arrays, ``mlp_w`` / ``mlp_b``
    as lists of arrays) → the port's dict of float32 tensors."""
    dev = resolve_device(device)
    f = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    return {k: [f(a) for a in v] if isinstance(v, (list, tuple)) else f(v)
            for k, v in tree.items()}


def lm_params_from_numpy(tree: dict, device=None, dtype=None) -> dict:
    """The JAX package's LM parameter tree (``init_params``'s nested dict
    of arrays) → the port's dict of tensors, in ``dtype`` (a torch dtype
    or its name; default float32)."""
    dev = resolve_device(device)
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    dtype = dtype or torch.float32
    conv = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev,
                                  dtype=dtype)
    return {k: lm_params_from_numpy(v, dev, dtype) if isinstance(v, dict)
            else conv(v) for k, v in tree.items()}


def lm_opt_from_numpy(tree: dict, device=None) -> dict:
    """The JAX package's Adam state (``init_opt``'s dict of ``m``, ``v``
    and ``count``, as numpy arrays) → the port's: the moments keep their
    dtypes (a bfloat16 moment, ml_dtypes' type in numpy, stays
    bfloat16), ``count`` is a 0-d int32 tensor."""
    dev = resolve_device(device)

    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.tensor(a.view(np.int16), device=dev).view(
                torch.bfloat16)
        return torch.tensor(a, device=dev)

    tree_of = lambda t: {k: tree_of(v) if isinstance(v, dict) else conv(v)
                         for k, v in t.items()}
    return dict(m=tree_of(tree["m"]), v=tree_of(tree["v"]),
                count=torch.tensor(np.asarray(tree["count"], np.int32),
                                   device=dev))


def to_numpy(x):
    """A tensor → ndarray; a dataclass of tensors → dict of its fields with
    every tensor as an ndarray (other fields unchanged)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if dataclasses.is_dataclass(x):
        return {f.name: to_numpy(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return x
