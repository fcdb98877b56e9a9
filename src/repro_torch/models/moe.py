"""Mixture-of-experts layer, single-device path (`repro/models/moe.py`).

Ported: `router` and `moe_dense_ref`, the reference's semantics on one
device — every token through each of its top-k experts, no capacity, no
drop.  The JAX package computes them with einsums outside any Pallas
kernel, so the port computes them with plain `torch` products.

Not ported yet: the expert-parallel paths `moe_ffn`, `moe_ffn_ep2d` and
their `_group_and_ffn` (`shard_map` all-to-alls over an LM mesh, with
capacity drops).  They wait for `models/sharding.py` and the LM meshes
(ROADMAP Queue 1 item 9.6c).
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


class _ExpertFFN(torch.autograd.Function):
    """The experts' SwiGLU on the expert-sorted pair rows ``xs`` [P, D]:
    rows ``bounds[e]:bounds[e + 1]`` go through expert e, whose ``w1``,
    ``w3`` and ``w2`` (slices of the layer's [E, ·, ·] stacks) are cast to
    ``xs.dtype`` once a pass → [P, D], the experts' outputs in expert
    order.

    The backward recomputes each routed expert's two input products and
    writes its weight gradients into its slices of one [E, ·, ·] tensor a
    weight in the stack's dtype (zeros for an expert without rows, as
    `jax.grad` gives them); with bfloat16 stacks at bfloat16 compute the
    casts are no copies, and no float32 copy of a stack is made.
    Autograd's backward of per-expert views would hold the E slices'
    gradients beside their stack: 4.2 GB more a weight at dbrx-132b.

    A declared difference from the reference with bfloat16 stacks: the
    reference gathers each token's expert weights, so its gradient is a
    scatter-add into the bfloat16 stack, rounded after every token's
    outer product; here an expert's tokens are summed in one GEMM
    (float32 accumulation) and rounded once, nearer the exact sum.  The
    two differ by up to the rounding of a bfloat16 sum over the tokens
    routed to the expert."""

    @staticmethod
    def forward(ctx, xs, w1, w3, w2, bounds):
        dt = xs.dtype
        ys = []
        for e, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
            if lo == hi:
                continue
            xe = xs[lo:hi]
            g = xe @ w1[e].to(dt)
            u = xe @ w3[e].to(dt)
            h = F.silu(g.float()).to(dt) * u
            ys.append(h @ w2[e].to(dt))
        ctx.bounds = bounds
        ctx.save_for_backward(xs, w1, w3, w2)
        return torch.cat(ys)

    @staticmethod
    def backward(ctx, dys):
        xs, w1, w3, w2 = ctx.saved_tensors
        dt = xs.dtype
        dxs = torch.empty_like(xs)
        dw1, dw3, dw2 = (torch.empty_like(w) for w in (w1, w3, w2))
        bounds = ctx.bounds
        for e, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
            if lo == hi:
                for d in (dw1, dw3, dw2):
                    d[e].zero_()
                continue
            xe, dy = xs[lo:hi], dys[lo:hi]
            W1, W3, W2 = (w[e].to(dt) for w in (w1, w3, w2))
            g, u = xe @ W1, xe @ W3
            a = F.silu(g.float()).to(dt)
            dh = dy @ W2.T
            dw2[e].copy_((a * u).T @ dy)
            # autograd's own steps: the product's, the cast's, silu's
            dg = torch.ops.aten.silu_backward((dh * u).float(),
                                              g.float()).to(dt)
            du = dh * a
            dw1[e].copy_(xe.T @ dg)
            dw3[e].copy_(xe.T @ du)
            dxs[lo:hi] = dg @ W1.T + du @ W3.T
        return dxs, dw1, dw3, dw2, None


def moe_dense_ref(p, x, eid, gate, cfg: ArchConfig):
    """The reference's `moe_dense_ref`: each token's output is the sum, in
    slot order and in ``x.dtype``, of its k experts' SwiGLU outputs, each
    multiplied by its gate after the ``w2`` product.  Differentiable in
    ``x``, ``gate`` and the expert stacks.

    The reference gathers each token's expert weights ([T, D, d_ff] a
    slot: 67.6 GB of float32 at dbrx-132b's prefill).  Here the (token,
    slot) pairs are grouped by expert with one stable sort, and each
    expert that has pairs casts its own ``w1``, ``w3`` and ``w2`` once and
    runs its three products on its rows (`_ExpertFFN`).  The group bounds
    are read once (one host sync a layer; a rematerialised layer reads
    them again and routes as its forward did).  The rows move between
    (token, slot) order and expert order by permutations only, so no
    backward adds two rows into one."""
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
    # each token's row once a slot, then the pairs' rows by expert
    xs = xt[:, None].expand(T, k, D).reshape(T * k, D)[order]
    ys = _ExpertFFN.apply(xs, p["w1"], p["w3"], p["w2"], bounds)
    ys = ys * gate.reshape(T * k).to(dt)[order][:, None]
    per_pair = ys.new_empty(ys.shape).index_copy_(0, order, ys)
    per_pair = per_pair.reshape(T, k, D)
    out = per_pair[:, 0]
    for kk in range(1, k):
        out = out + per_pair[:, kk]
    return out.reshape(B, S, D)
