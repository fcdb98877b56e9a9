"""Sharding rules (`repro/models/sharding.py`): parameter, batch and
cache partition specs per architecture, and the blocks a spec cuts a
tensor into on an `LMMesh`.

Mesh contract (`launch/mesh.py`): axes ``("pod", "data", "model")`` over
several pods or ``("data", "model")`` over one.  DP/FSDP over ("pod",
"data") = ``dp``; TP/EP over "model" = ``tp``.

Rules, as the reference's:
  * TP on the natural contraction/output axis (heads, ff, experts, vocab);
  * kv projections: head-sharded when n_kv divides |tp|, else input-
    sharded;
  * FSDP (cfg.fsdp): additionally shard the other large axis over dp;
  * optimizer moments follow the parameter specs;
  * KV caches: batch over dp, sequence over tp;
  * the batch dim is never sharded when smaller than |dp|.

`P` is the port's PartitionSpec: a tuple whose entries are an axis
name, a tuple of names or None, one a dimension (missing trailing
dimensions are unsharded).  `NamedSharding` pairs a spec with a mesh:
`shard_shape` is a cell's block shape, `blocks` cuts a tensor into
every cell's block (views on the cell's device, by `torch.split`, so a
backward through them adds each block's gradient into one tensor of the
whole's shape) and `assemble` joins the blocks again.  `constrain` is
the reference's `with_sharding_constraint`: a layout statement, checked
against the mesh `use_mesh` installed; the values are left as they are,
which is all the reference's constraint does to them.
"""
from __future__ import annotations

import math

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import LMMesh, _names, current_mesh

_STACKS = ("layers", "enc", "dec", "dec_cross")


class P(tuple):
    """PartitionSpec: ``P("data", None)``, ``P(("pod", "data"), "model")``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def mesh_axes(mesh: LMMesh) -> dict:
    """{"dp": the data axes (a tuple when several), "tp": "model", "ndp",
    "ntp": their sizes}."""
    dp = tuple(n for n in mesh.axis_names if n in ("pod", "data"))
    return {"dp": dp if len(dp) > 1 else dp[0], "tp": "model",
            "ndp": math.prod(mesh.shape[n] for n in dp),
            "ntp": mesh.shape["model"]}


def _map_with_names(fn, tree):
    """``fn(keys, leaf)`` over ``tree``'s leaves (keys: the path's names
    from the root) → a tree of the same structure."""
    return T.unflatten(tree, [fn(path.split("/"), leaf)
                              for path, leaf in T.leaves_with_paths(tree)])


def _ndim(leaf) -> int:
    return getattr(leaf, "ndim", 0)


def param_specs(cfg: ArchConfig, params, axes):
    """A spec for each leaf of ``params`` (real or meta tensors)."""
    tp = axes["tp"]
    fs = axes["dp"] if cfg.fsdp else None
    ntp = axes["ntp"]
    kv_on_heads = cfg.n_kv and cfg.n_kv % ntp == 0
    q_on_heads = cfg.n_heads and cfg.n_heads_padded % ntp == 0

    def spec_for(keys, leaf):
        name = keys[-1]
        lead = (None,) if any(k in _STACKS for k in keys[:-1]) else ()

        def sp(*rest):
            return P(*lead, *rest)

        if name in ("embed", "out_embed"):
            return P(tp, None)
        if name in ("final_norm", "enc_norm"):
            return P(None)
        # attention (heads that |tp| does not divide: FSDP on D instead)
        if name == "wq":
            return sp(fs, tp, None) if q_on_heads else sp(fs, None, None)
        if name in ("wk", "wv"):
            return sp(None, tp, None) if kv_on_heads else sp(fs, None, None)
        if name == "wo":
            return sp(tp, None, fs) if q_on_heads else sp(None, None, fs)
        if name == "bq":
            return sp(tp, None) if q_on_heads else sp(None, None)
        if name in ("bk", "bv"):
            return sp(tp, None) if kv_on_heads else sp(None, None)
        # mlp / moe
        if name == "router":
            return sp(None, None)
        if name in ("w1", "w3"):
            if _ndim(leaf) - len(lead) == 3:    # [E, D, ff] expert weights
                return sp(axes["dp"], None, None) if cfg.moe_ep2d \
                    else sp(tp, fs, None)
            return sp(fs, tp)
        if name == "w2":
            if _ndim(leaf) - len(lead) == 3:
                return sp(axes["dp"], None, None) if cfg.moe_ep2d \
                    else sp(tp, None, fs)
            return sp(tp, fs)
        if name in ("w1d", "w3d"):
            return sp(fs, tp)
        if name == "w2d":
            return sp(tp, fs)
        # ssm
        if name in ("z_proj", "x_proj", "dt_proj"):
            return sp(fs, tp)
        if name in ("b_proj", "c_proj"):
            return sp(fs, None)
        if name == "conv_x":
            return sp(None, tp)
        if name in ("conv_b", "conv_c"):
            return sp(None, None)
        if name in ("dt_bias", "A_log", "D", "norm_w"):
            return sp(tp)
        if name == "out_proj":
            return sp(tp, fs)
        # norms, scalars, anything 1D
        return sp(*([None] * (_ndim(leaf) - len(lead))))

    return _map_with_names(spec_for, params)


def _b_ax(dim: int, axes):
    """The batch dim's axis: dp where |dp| divides it and it is ≥ |dp|."""
    ndp = axes["ndp"]
    return axes["dp"] if dim % ndp == 0 and dim >= ndp else None


def batch_specs(cfg: ArchConfig, batch, axes):
    def spec_for(keys, leaf):
        name = keys[-1]
        shape = tuple(getattr(leaf, "shape", ()))
        b_ax = _b_ax(shape[0], axes) if shape else None
        if name in ("tokens", "labels", "mask"):
            return P(b_ax, None)
        if name == "frontend_embeds":
            return P(b_ax, None, None)
        if name == "cands":
            return P(None)
        return P(*([b_ax] + [None] * (_ndim(leaf) - 1)))

    return _map_with_names(spec_for, batch)


def cache_specs(cfg: ArchConfig, cache, axes):
    """Specs of a cache tree; its ``pos`` (the port's Python int, the
    reference's int32 scalar) is ``P()``."""
    tp, ntp = axes["tp"], axes["ntp"]

    def spec_for(keys, leaf):
        name = keys[-1]
        if _ndim(leaf) == 0:
            return P()
        s = leaf.shape
        if name in ("k", "v", "cross_k", "cross_v"):        # [L,B,T,Hkv,hd]
            kv_ax = tp if s[3] % ntp == 0 else None
            t_ax = tp if kv_ax is None and s[2] % ntp == 0 else None
            return P(None, _b_ax(s[1], axes), t_ax, kv_ax, None)
        if name == "ssm":                                    # [L,B,H,P,N]
            h_ax = tp if s[2] % ntp == 0 else None
            return P(None, _b_ax(s[1], axes), h_ax, None, None)
        if name.startswith("conv"):                          # [L,B,K-1,C]
            c_ax = tp if s[3] % ntp == 0 else None
            return P(None, _b_ax(s[1], axes), None, c_ax)
        if name == "enc_out":                                # [B,S,D]
            return P(_b_ax(s[0], axes), tp, None)
        return P(*([None] * _ndim(leaf)))

    return _map_with_names(spec_for, cache)


class NamedSharding:
    """A spec on a mesh: which block of a tensor each cell holds."""

    def __init__(self, mesh: LMMesh, spec: P):
        self.mesh, self.spec = mesh, P(*spec)
        for names in map(_names, self.spec):
            for a in names:
                if a not in mesh.axis_names:
                    raise ValueError(f"{self.spec}: no axis {a!r} in the "
                                     f"mesh's {mesh.axis_names}")
        used = [a for e in self.spec for a in _names(e)]
        if len(used) != len(set(used)):
            raise ValueError(f"{self.spec} names an axis twice")

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh.shape}, {self.spec})"

    def _parts(self) -> list:
        """The number of blocks along each dimension the spec names."""
        return [math.prod(self.mesh.shape[a] for a in _names(e))
                for e in self.spec]

    def shard_shape(self, global_shape) -> tuple:
        """One cell's block shape; raises where a sharded dimension is
        not a multiple of its axes' size."""
        shape = tuple(global_shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"{self.spec} has more entries than the "
                             f"shape {shape}")
        out = list(shape)
        for i, n in enumerate(self._parts()):
            if shape[i] % n:
                raise ValueError(f"dimension {i} of {shape} is not a "
                                 f"multiple of {n} ({self.spec})")
            out[i] = shape[i] // n
        return tuple(out)

    def _key(self, cell) -> tuple:
        """The block index of ``cell``, one a sharded dimension."""
        return tuple(self.mesh.index(cell, _names(e)) for e in self.spec)

    def blocks(self, t: torch.Tensor) -> dict:
        """Cell → its block of ``t`` on the cell's device (a view where
        the device is ``t``'s).  Blocks come from one `torch.split` a
        dimension, so a backward adds their gradients into one tensor."""
        self.shard_shape(t.shape)
        pieces = {(): t}
        for dim, n in enumerate(self._parts()):
            pieces = {k + (i,): b for k, v in pieces.items()
                      for i, b in enumerate(v.split(v.shape[dim] // n, dim))}
        return {c: pieces[self._key(c)].to(self.mesh.device_of(c))
                for c in self.mesh.cells()}

    def assemble(self, parts: dict, device) -> torch.Tensor:
        """The blocks of ``parts`` (cell → block) joined into one tensor on
        ``device``; of the cells that hold one block (those the spec does
        not tell apart) the first in row-major order gives it."""
        first = {}
        for c in self.mesh.cells():
            first.setdefault(self._key(c), parts[c])
        parts_n = self._parts()

        def join(prefix, dim):
            if dim == len(parts_n):
                return first[prefix].to(device)
            return torch.cat([join(prefix + (i,), dim + 1)
                              for i in range(parts_n[dim])], dim)

        return join((), 0)


def spec_leaves(tree_specs) -> list:
    """The specs of a spec tree in `tree.leaves` order (a `P` is a leaf,
    not a tuple of leaves)."""
    if isinstance(tree_specs, P):
        return [tree_specs]
    if isinstance(tree_specs, dict):
        return [s for k in sorted(tree_specs)
                for s in spec_leaves(tree_specs[k])]
    return [s for v in tree_specs for s in spec_leaves(v)]


def to_named(tree_specs, mesh: LMMesh):
    """A `NamedSharding` for each spec of ``tree_specs``."""
    if isinstance(tree_specs, P):
        return NamedSharding(mesh, tree_specs)
    if isinstance(tree_specs, dict):
        return {k: to_named(v, mesh) for k, v in tree_specs.items()}
    if isinstance(tree_specs, (tuple, list)):
        return type(tree_specs)(to_named(v, mesh) for v in tree_specs)
    raise TypeError(f"not a spec tree: {type(tree_specs).__name__}")


def constrain(x: torch.Tensor, spec: P) -> torch.Tensor:
    """The reference's `with_sharding_constraint(x, spec)`: ``spec`` must
    fit ``x``'s rank and, under `use_mesh`, name the mesh's axes, each
    at most once.  Returns ``x`` unchanged."""
    if len(spec) > x.ndim:
        raise ValueError(f"{spec} has more entries than x's rank {x.ndim}")
    mesh = current_mesh()
    if mesh is not None:
        NamedSharding(mesh, spec)
    return x
