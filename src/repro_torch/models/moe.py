"""Mixture-of-experts layer (`repro/models/moe.py`).

`router` and `moe_dense_ref` are the reference's single-device
semantics: every token through each of its top-k experts, no capacity,
no drop.  `moe_ffn` and `moe_ffn_ep2d` are its expert-parallel paths on
an LM mesh (`launch/mesh.py::LMMesh`), the reference's `shard_map`
regions run one mesh cell after another:

* `moe_ffn` with ``shard_seq=True`` (train, prefill): experts over
  "model"; each cell routes its block of tokens (batch over the data
  axes, sequence over "model"), packs at most ``C_send`` slots for each
  destination cell, and two `all_to_all`s carry the slots to the
  experts' cells and the outputs back; `_group_and_ffn` keeps at most
  ``C_exp`` slots an expert;
* `moe_ffn` with ``shard_seq=False`` (decode): tokens whole on each
  "model" cell, each cell runs its own experts over their slots and a
  `psum_over` "model" adds the cells' outputs;
* `moe_ffn_ep2d`: experts over the data axes, whole on each "model"
  cell; the all-to-alls run over the data axes.

The capacities are the reference's, from static sizes with Python's
`round`, and slots past them are dropped exactly as there: a stable sort
(`jnp.argsort`'s default), left-sided `searchsorted` ranks, and a dump
row that takes every dropped slot and is sliced off.  Every shape is
static and nothing is read back to the host.  The combine's scatter-add
(k slots a token collide) goes through `core/scatter.py::
index_add_det_` in float32 (`_add_rows`): on the card the hand-written
`segment_add` kernel, so two runs are bit-equal; so does the backward of
each token's k gathers (`scatter.gather_rows`).  At bfloat16 compute
this is a declared difference: the reference adds the k contributions
in bfloat16 one after another, the port sums them in float32 and rounds
once.  The expert products are plain `torch` products: the reference
computes all of this with einsums, scatters and `shard_map`, outside any
Pallas kernel.

Inside `record_dispatches()` each dispatch made by the same thread
appends one record to its log: its path, the expert ids [B, S, k] it
routed, the routed slots, the slots kept past the send capacity and past
both, and the kept-slot mask [B, S, k] (device tensors, read when the
caller chooses).
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import scatter
from repro_torch.core.topk import topk_first_index
from repro_torch.launch.mesh import LMMesh, _names, all_to_all, psum_over
from repro_torch.models.sharding import NamedSharding, P

_LOCAL = threading.local()


def dispatch_log() -> list | None:
    """This thread's open `record_dispatches` list, else None."""
    return getattr(_LOCAL, "log", None)


@contextlib.contextmanager
def record_dispatches():
    """The log on for the block, in this thread: → the list its
    dispatches append to (module docstring)."""
    prev, _LOCAL.log = dispatch_log(), []
    try:
        yield _LOCAL.log
    finally:
        _LOCAL.log = prev


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


# --------------------------------------------------------------------------
# expert-parallel paths
# --------------------------------------------------------------------------


def _expert_ffn(w1, w3, w2, xb):
    """xb [E_loc, C, D] through the local experts."""
    dt = xb.dtype
    g = torch.bmm(xb, w1.to(dt))
    u = torch.bmm(xb, w3.to(dt))
    h = F.silu(g.float()).to(dt) * u
    return torch.bmm(h, w2.to(dt))


class _AddRows(torch.autograd.Function):
    """zeros [n, D] float32 plus ``src``'s rows at ``idx``, added in index
    order (`index_add_det_`); the backward gathers the rows' gradients."""

    @staticmethod
    def forward(ctx, idx, src, n):
        ctx.save_for_backward(idx)
        return scatter.index_add_det_(src.new_zeros((n, src.shape[1])), idx,
                                      src)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        return None, g.index_select(0, idx), None


def _add_rows(idx, src, n):
    """The reference's ``zeros((n, D), src.dtype).at[idx].add(src)``,
    summed in float32 and rounded to ``src.dtype`` once."""
    return _AddRows.apply(idx, src.float(), n).to(src.dtype)


def _pack(keys, n_dst: int, cap: int):
    """Rank each slot within its destination ``keys`` (−1 = none, sorted
    first) in a stable order → (order, sorted keys, ok, addr): slot
    ``order[j]`` goes to address ``addr[j]`` = key·cap + rank when ``ok``,
    else to the dump address n_dst·cap."""
    order = torch.sort(keys, stable=True).indices
    sk = keys[order]
    first = torch.searchsorted(sk, torch.arange(n_dst, dtype=sk.dtype,
                                                device=sk.device))
    rank = torch.arange(keys.numel(), device=keys.device) - first[
        sk.clamp(0, n_dst - 1)]
    ok = (sk >= 0) & (rank < cap)
    return order, sk, ok, torch.where(ok, sk * cap + rank, n_dst * cap)


def _group_and_ffn(recv_x, recv_e, E_loc, C_exp, w1, w3, w2):
    """Group slots by local expert id (−1 = invalid), run the FFN, return
    outputs aligned with the incoming slot order (zeros for dropped) and
    which incoming slots were kept."""
    R, D = recv_x.shape
    order, _, ok, addr = _pack(recv_e.long(), E_loc, C_exp)
    buf = recv_x.new_zeros((E_loc * C_exp + 1, D)).index_put(
        (addr,), recv_x[order])[: E_loc * C_exp]
    yb = _expert_ffn(w1, w3, w2, buf.reshape(E_loc, C_exp, D))
    yb = yb.reshape(E_loc * C_exp, D)
    got = torch.where(ok, addr, 0)
    vals = torch.where(ok[:, None], yb[got], 0.0)
    return (recv_x.new_zeros((R, D)).index_copy(0, order, vals),
            torch.zeros_like(ok).index_put((order,), ok))


def _flat(x, eid, gate, k):
    """A cell's block → (tokens [T, D], each slot's token, expert and
    gate in ``x.dtype``), slots in (token, k) order."""
    b, s, D = x.shape
    T = b * s
    slot_tok = torch.arange(T, device=x.device).repeat_interleave(k)
    return (x.reshape(T, D), slot_tok, eid.reshape(T * k).long(),
            gate.reshape(T * k).to(x.dtype))


def _a2a_dispatch(mesh, axes, xb, eb, gb, w1b, w3b, w2b, E_loc, k,
                  capacity_factor, log):
    """The a2a path over ``axes`` (n cells a group), cell by cell: route
    and pack ``C_send`` slots for each destination, all-to-all, group and
    run the local experts, all-to-all back, the gate-weighted combine.
    → (cell → output block, and with ``log`` (cell → kept-slot mask
    [b, s, k], slots kept past the send capacity) else None)."""
    n = math.prod(mesh.shape[a] for a in _names(axes))
    cells = mesh.cells()
    b, s_loc, D = xb[cells[0]].shape
    S = b * s_loc * k
    C_send = max(1, int(round(S / n * capacity_factor)))
    R = n * C_send
    C_exp = max(1, int(round(R / max(E_loc, 1) * capacity_factor)))
    send_x, send_e, send_src, flat, sent = {}, {}, {}, {}, []
    for c in cells:
        xt, slot_tok, slot_eid, slot_gate = flat[c] = _flat(
            xb[c], eb[c], gb[c], k)
        order, _, keep, addr = _pack(slot_eid // E_loc, n, C_send)
        sent.append(keep.sum())
        send_x[c] = xt.new_zeros((R + 1, D)).index_put(
            (addr,), scatter.gather_rows(xt, slot_tok[order]))[:R]
        send_e[c] = torch.full((R + 1,), -1, dtype=torch.long,
                               device=xt.device).index_put(
            (addr,), slot_eid[order] % E_loc)[:R]
        send_src[c] = torch.zeros(R + 1, dtype=torch.long,
                                  device=xt.device).index_put(
            (addr,), order)[:R]
    recv_x = all_to_all({c: v.reshape(n, C_send, D)
                         for c, v in send_x.items()}, mesh, axes)
    recv_e = all_to_all({c: v.reshape(n, C_send)
                         for c, v in send_e.items()}, mesh, axes)
    back, ok = {}, {}
    for c in cells:
        back[c], ok[c] = _group_and_ffn(recv_x[c].reshape(R, D),
                                        recv_e[c].reshape(R), E_loc, C_exp,
                                        w1b[c], w3b[c], w2b[c])
    ret = all_to_all({c: v.reshape(n, C_send, D) for c, v in back.items()},
                     mesh, axes)
    out = {}
    for c in cells:
        xt, slot_tok, _, slot_gate = flat[c]
        src = send_src[c]
        valid = (send_e[c] >= 0).to(xt.dtype)
        contrib = ret[c].reshape(R, D) * (slot_gate[src] * valid)[:, None]
        out[c] = _add_rows(slot_tok[src], contrib, xt.shape[0]).reshape(
            xb[c].shape)
    if not log:
        return out, None
    # a slot is kept when an address it was sent to came back kept
    ret_ok = all_to_all({c: v.reshape(n, C_send) for c, v in ok.items()},
                        mesh, axes)
    masks = {}
    for c in cells:
        hit = (send_e[c] >= 0) & ret_ok[c].reshape(R)
        masks[c] = torch.zeros(S + 1, dtype=torch.bool,
                               device=hit.device).index_put(
            (torch.where(hit, send_src[c], S),), hit)[:S].reshape(
            b, s_loc, k)
    return out, (masks, torch.stack(sent).sum())


def _log(path, mesh, spec_x, masks, eid, sent):
    """One `record_dispatches` record: the routed expert ids, the
    kept-slot mask [B, S, k] over the whole batch, its count, the routed
    and the sent slots."""
    mask = NamedSharding(mesh, spec_x).assemble(masks, eid.device)
    dispatch_log().append(dict(path=path, eid=eid, routed=eid.numel(),
                               sent=sent, kept=mask.sum(), mask=mask))


def _blocks(mesh, spec, *ts):
    sh = NamedSharding(mesh, spec)
    return [sh.blocks(t) for t in ts]


def moe_ffn(p, x, eid, gate, cfg: ArchConfig, mesh: LMMesh, mesh_axes,
            capacity_factor: float = 2.0, shard_seq: bool = True):
    """1D EP: experts over "model" (``w1``/``w3``/``w2`` blocks by
    ``P(tp, None, None)``), tokens by ``P(dp, tp or None, None)``.
    Differentiable in ``x``, ``gate`` and the expert stacks."""
    tp, dp = mesh_axes["tp"], mesh_axes["dp"]
    ntp = mesh.shape[tp]
    E, k = cfg.n_experts, cfg.moe_top_k
    if E % ntp:
        raise ValueError("experts must divide the model axis")
    E_loc = E // ntp
    log = dispatch_log() is not None
    spec_x = P(dp, tp if shard_seq else None, None)
    xb, eb, gb = _blocks(mesh, spec_x, x, eid, gate)
    w1b, w3b, w2b = _blocks(mesh, P(tp, None, None), p["w1"], p["w3"],
                            p["w2"])
    if shard_seq:
        out, kept = _a2a_dispatch(mesh, tp, xb, eb, gb, w1b, w3b, w2b,
                                  E_loc, k, capacity_factor, log)
        if log:
            _log("a2a", mesh, spec_x, kept[0], eid, kept[1])
        return NamedSharding(mesh, spec_x).assemble(out, x.device)
    # tokens whole over "model": each cell runs its own experts' slots
    out, ok = {}, {}
    for c in mesh.cells():
        xt, slot_tok, slot_eid, slot_gate = _flat(xb[c], eb[c], gb[c], k)
        T = xt.shape[0]
        e_loc = slot_eid - mesh.index(c, tp) * E_loc
        mine = (e_loc >= 0) & (e_loc < E_loc)
        C_exp = max(1, int(round(T * k / max(E_loc, 1) * capacity_factor)))
        back, ok[c] = _group_and_ffn(
            scatter.gather_rows(xt, slot_tok),
            torch.where(mine, e_loc, -1), E_loc, C_exp, w1b[c], w3b[c],
            w2b[c])
        out[c] = _add_rows(slot_tok, back * slot_gate[:, None], T).reshape(
            xb[c].shape)
    if log:           # each slot is one cell's: kept where that cell kept it
        masks = psum_over({c: v.reshape(eb[c].shape).int()
                           for c, v in ok.items()}, mesh, tp)
        _log("rep", mesh, spec_x, {c: v > 0 for c, v in masks.items()},
             eid, eid.numel())
    return NamedSharding(mesh, spec_x).assemble(psum_over(out, mesh, tp),
                                                x.device)


def moe_ffn_ep2d(p, x, eid, gate, cfg: ArchConfig, mesh: LMMesh, mesh_axes,
                 capacity_factor: float = 2.0):
    """EP over the data axes: experts by ``P(dp, None, None)`` (whole on
    each "model" cell), tokens by ``P(dp, tp, None)``; the all-to-alls
    run over the data axes, to the expert-owner row r = e // E_loc of
    the same "model" column."""
    tp, dp, ndp = mesh_axes["tp"], mesh_axes["dp"], mesh_axes["ndp"]
    E, k = cfg.n_experts, cfg.moe_top_k
    if E % ndp:
        raise ValueError("experts must divide the data axes for 2D EP")
    log = dispatch_log() is not None
    spec_x = P(dp, tp, None)
    xb, eb, gb = _blocks(mesh, spec_x, x, eid, gate)
    w1b, w3b, w2b = _blocks(mesh, P(dp, None, None), p["w1"], p["w3"],
                            p["w2"])
    out, kept = _a2a_dispatch(mesh, dp, xb, eb, gb, w1b, w3b, w2b,
                              E // ndp, k, capacity_factor, log)
    if log:
        _log("ep2d", mesh, spec_x, kept[0], eid, kept[1])
    return NamedSharding(mesh, spec_x).assemble(out, x.device)
