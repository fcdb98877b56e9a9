"""Mixture-of-experts layer, single-device path (`repro/models/moe.py`).

Ported: `router` and `moe_dense_ref`, the reference's semantics on one
device — every token through each of its top-k experts, no capacity, no
drop.  The JAX package computes them with einsums outside any Pallas
kernel, so the port computes them with plain `torch` products.

Not ported yet: the expert-parallel paths `moe_ffn`, `moe_ffn_ep2d` and
their `_group_and_ffn` (`shard_map` all-to-alls over an LM mesh, with
capacity drops).  They wait for `models/sharding.py` and the LM meshes
(ROADMAP Queue 1 item 9.6).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.topk import topk_first_index


def router(p, x, cfg: ArchConfig):
    """x [B,S,D] → (eid [B,S,k] int32, gate [B,S,k] float32).  The
    logits are float32; the top k in `lax.top_k`'s order (equal logits:
    the lower expert first), the gate their softmax."""
    B, S, _ = x.shape
    logits = torch.einsum("bsd,de->bse", x.float(), p["router"].float())
    flat = logits.reshape(B * S, -1)
    eid = topk_first_index(flat, cfg.moe_top_k)
    gate = torch.softmax(flat.gather(1, eid), dim=-1)
    k = cfg.moe_top_k
    return eid.to(torch.int32).reshape(B, S, k), gate.reshape(B, S, k)


def moe_dense_ref(p, x, eid, gate, cfg: ArchConfig):
    """The reference's `moe_dense_ref`: each token's output is the sum, in
    slot order and in ``x.dtype``, of its k experts' SwiGLU outputs, each
    multiplied by its gate after the ``w2`` product.

    The reference gathers each token's expert weights ([T, D, d_ff] a
    slot: 67.6 GB of float32 at dbrx-132b's prefill).  Here the (token,
    slot) pairs are grouped by expert with one stable sort, and each
    expert that has pairs casts its own ``w1``, ``w3`` and ``w2`` once and
    runs its three products on its rows.  The group bounds are read once
    (one host sync a layer).  The rows go back to their (token, slot)
    places by one index copy of a permutation, with no colliding add."""
    B, S, D = x.shape
    k, E = cfg.moe_top_k, cfg.n_experts
    dt = x.dtype
    xt = x.reshape(-1, D)
    T = xt.shape[0]
    pair_e = eid.reshape(T * k).long()           # pair j: token j // k, slot j % k
    order = torch.sort(pair_e, stable=True).indices
    bounds = torch.searchsorted(pair_e[order], torch.arange(
        E + 1, device=x.device)).tolist()
    if bounds[0] != 0 or bounds[E] != T * k:
        raise ValueError(f"expert ids outside [0, {E})")
    xs = xt[order // k]                        # pairs' rows, by expert
    ys = torch.empty((T * k, D), dtype=dt, device=x.device)
    for e in range(E):
        lo, hi = bounds[e], bounds[e + 1]
        if lo == hi:
            continue
        xe = xs[lo:hi]
        g = xe @ p["w1"][e].to(dt)
        u = xe @ p["w3"][e].to(dt)
        h = F.silu(g.float()).to(dt) * u
        torch.mm(h, p["w2"][e].to(dt), out=ys[lo:hi])
    ys *= gate.reshape(T * k).to(dt)[order][:, None]
    per_pair = torch.empty_like(ys)
    per_pair[order] = ys
    per_pair = per_pair.reshape(T, k, D)
    out = per_pair[:, 0]
    for kk in range(1, k):
        out = out + per_pair[:, kk]
    return out.reshape(B, S, D)
