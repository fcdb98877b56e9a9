"""Model assembly (`repro/models/lm.py`) for every family: dense, moe,
ssm, hybrid, encdec and vlm.

The port serves and trains all six: dense (attention + MLP layers),
moe (attention + a routed mixture of experts, `models/moe.py`'s
single-device path, plus arctic's dense residual MLP), ssm (Mamba2
layers, `models/ssm.py`), hybrid (Mamba2 layers with one shared
attention + MLP block run before each group of ``cfg.attn_every``),
vlm, a dense stack whose precomputed patch embeddings
(``batch["frontend_embeds"]``, the reference's frontend stub) are
prepended to the token embeddings, and encdec, a bidirectional encoder
over precomputed frame embeddings and a decoder whose layers add a
cross-attention sub-layer on the encoder's output (`_forward_encdec`;
the encoder's output reaches every decoder layer, so its gradient is
the sum of the L layers' cross K/V products).  Layer stacks are dicts
of tensors with a leading L dim, applied layer by layer (the JAX
package's `lax.scan`); there is no scheduling barrier (`_opt_barrier`
pins the FSDP gathers of training).  Training remats each stacked
layer, as the reference does (`_scan_layers`); the hybrid's shared block
is not rematerialised.

``mesh`` / ``mesh_axes`` (an `LMMesh` and `sharding.mesh_axes` of it)
follow the reference's call sites: the moe family's experts run on the
mesh (`moe.moe_ffn`, or `moe.moe_ffn_ep2d` with ``cfg.moe_ep2d``),
whose capacities may drop slots; every other use of the mesh is a
sharding constraint, checked and leaving the values as they are
(`shard_vocab`, `layers.shard_acts` / `gather_seq` / `scatter_seq`, the
ring layout of attention whose heads the model axis does not divide).
``mesh=None``, the default, is the single-device path.

Weights are kept in ``cfg.param_dtype`` (float32, or bfloat16 for
llama3-405b and arctic-480b) and cast to ``cfg.dtype`` (bfloat16) where
they are used, as in the reference; a cast to the weight's own dtype is
the weight itself, so bfloat16 weights at bfloat16 compute are never
copied.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.utils.checkpoint

from repro_torch import prng
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import use_mesh
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.sharding import P, constrain

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
# stacks of attention blocks: a K/V cache, prefilled by one forward
KV_FAMILIES = ("dense", "moe", "vlm")


def check_family(cfg: ArchConfig) -> None:
    """Raise unless ``cfg``'s family is ported."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported to "
            f"repro_torch; only {PORTED_FAMILIES} runs")


# --------------------------------------------------------------------------
# parameter initialization
# --------------------------------------------------------------------------


class _Leaf(NamedTuple):
    """A parameter leaf to draw: ``scale · normal(key, shape)`` or, with
    no key, ``shape`` filled with ``fill`` (the reference's `jnp.ones` /
    `jnp.zeros`)."""
    shape: tuple
    key: Optional[torch.Tensor] = None
    fill: float = 0.0


def _nrm(key, *shape) -> _Leaf:
    return _Leaf(shape, key)


def _ones(*shape) -> _Leaf:
    return _Leaf(shape, fill=1.0)


def _zeros(*shape) -> _Leaf:
    return _Leaf(shape, fill=0.0)


def _draw(leaf: _Leaf, scale: float, dtype, device, out=None):
    """``leaf`` in ``dtype``, into ``out`` (a contiguous slice of a stack)
    when given.  A normal leaf is ``scale · jax.random.normal(key, shape,
    dtype)``: the draw, then its product with ``dtype(scale)`` rounded
    once (the reference's weakly typed Python scale), in place (an expert
    stack of dbrx-132b is 4.2 GB).  On the ``meta`` device nothing is
    drawn: the leaf is its shape and dtype alone."""
    if out is None:
        out = torch.empty(leaf.shape, dtype=dtype, device=device)
    if out.is_meta:
        return out
    if leaf.key is None:
        return out.fill_(leaf.fill)
    prng.normal_chunked(leaf.key, leaf.shape, device=device, dtype=dtype,
                        out=out)
    return out.mul_(torch.tensor(scale, dtype=dtype, device=device))


def _attn_layer_init(cfg: ArchConfig, key):
    """A dense layer's attention leaves — ``ln1``, ``wq``/``wk``/``wv``/
    ``wo`` from the first four of ``split(key, 8)``, the biases and q/k
    norms where ``cfg`` sets them — each from its own key, so they equal
    the same leaves of `_dense_layer_init`'s draw."""
    hd, D, Hp = cfg.hd, cfg.d_model, cfg.n_heads_padded
    ks = prng.split(key, 8)
    p = dict(
        ln1=_ones(D),
        wq=_nrm(ks[0], D, Hp, hd),
        wk=_nrm(ks[1], D, cfg.n_kv, hd),
        wv=_nrm(ks[2], D, cfg.n_kv, hd),
        wo=_nrm(ks[3], Hp, hd, D),
    )
    if cfg.qkv_bias:
        p |= dict(bq=_zeros(Hp, hd), bk=_zeros(cfg.n_kv, hd),
                  bv=_zeros(cfg.n_kv, hd))
    if cfg.qk_norm:
        p |= dict(q_norm=_ones(hd), k_norm=_ones(hd))
    return p


def _dense_layer_init(cfg: ArchConfig, key):
    D, ff = cfg.d_model, cfg.d_ff
    ks = prng.split(key, 8)
    p = _attn_layer_init(cfg, key)
    p["ln2"] = _ones(D)
    if cfg.family == "moe" and cfg.n_experts:
        E = cfg.n_experts
        p |= dict(router=_nrm(ks[4], D, E), w1=_nrm(ks[5], E, D, ff),
                  w3=_nrm(ks[6], E, D, ff), w2=_nrm(ks[7], E, ff, D))
        if cfg.moe_dense_ff:
            fd = cfg.moe_dense_ff
            p |= dict(w1d=_nrm(prng.fold_in(key, 11), D, fd),
                      w3d=_nrm(prng.fold_in(key, 12), D, fd),
                      w2d=_nrm(prng.fold_in(key, 13), fd, D))
        return p
    p |= dict(w1=_nrm(ks[5], D, ff), w3=_nrm(ks[6], D, ff),
              w2=_nrm(ks[7], ff, D))
    return p


def _ssm_layer_init(cfg: ArchConfig, key):
    D, di, N = cfg.d_model, SSM.d_inner(cfg), cfg.ssm_state
    H, K = SSM.n_heads(cfg), cfg.ssm_conv
    ks = prng.split(key, 10)
    return dict(
        ln=_ones(D),
        z_proj=_nrm(ks[0], D, di),
        x_proj=_nrm(ks[1], D, di),
        b_proj=_nrm(ks[2], D, N),
        c_proj=_nrm(ks[3], D, N),
        dt_proj=_nrm(ks[4], D, H),
        conv_x=_nrm(ks[5], K, di),
        conv_b=_nrm(ks[6], K, N),
        conv_c=_nrm(ks[7], K, N),
        dt_bias=_zeros(H),
        A_log=_zeros(H),
        D=_ones(H),
        norm_w=_ones(di),
        out_proj=_nrm(ks[8], di, D),
    )


def _stack_init(per_layer_fn, cfg, key, n, dtype, device="cpu"):
    """The JAX package's `vmap` of ``per_layer_fn`` over ``split(key, n)``:
    each layer's leaves are drawn from its own key straight into their
    slices of the stack, one leaf at a time (a layer of arctic-480b is 27
    GB in bfloat16: it is never held beside the stack).  On the ``meta``
    device the stack is allocated from one layer's specs and nothing is
    drawn (the counterpart of `jax.eval_shape`)."""
    if torch.device(device).type == "meta":
        return {k: torch.empty((n, *v.shape), dtype=dtype, device="meta")
                for k, v in per_layer_fn(cfg, key).items()}
    keys = prng.split(key, n)
    out = None
    for li in range(n):
        layer = per_layer_fn(cfg, keys[li])
        if out is None:
            out = {k: torch.empty((n, *v.shape), dtype=dtype, device=device)
                   for k, v in layer.items()}
        for k, leaf in layer.items():
            _draw(leaf, 0.02, dtype, device, out=out[k][li])
    return out


def init_params(cfg: ArchConfig, key, model_shards: int = 16, device=None):
    """The JAX package's `init_params`: the same keys and draws, in
    ``cfg.param_dtype`` (float32: each float within a few ulp,
    `prng.normal`; bfloat16: bit for bit), on ``device`` (``cuda`` unless
    asked).  The hybrid's ``shared_attn`` is one unstacked dense layer
    drawn from the fourth key; encdec's tree is ``enc`` (a dense stack of
    ``cfg.enc_layers``), ``dec``, ``dec_cross`` (each decoder layer's
    cross-attention leaves) and ``enc_norm``, with no ``layers``.
    ``device="meta"`` gives the same tree of shapes and dtypes without
    drawing (the reference's ``jax.eval_shape(init_params)``)."""
    check_family(cfg)
    dt = L.torch_dtype(cfg.param_dtype)
    dev = resolve_device(device)
    ks = prng.split(key, 6)
    V = cfg.vocab_padded(model_shards)
    D = cfg.d_model
    leaf = lambda spec: _draw(spec, 0.02, dt, dev)
    p = dict(embed=leaf(_nrm(ks[0], V, D)), final_norm=leaf(_ones(D)))
    if not cfg.tie_embeddings:
        p["out_embed"] = leaf(_nrm(ks[1], V, D))
    if cfg.family == "encdec":
        p["enc"] = _stack_init(_dense_layer_init, cfg, ks[2],
                               cfg.enc_layers, dt, dev)
        p["dec"] = _stack_init(_dense_layer_init, cfg, ks[3], cfg.L, dt, dev)
        # the decoder's cross-attention: the reference draws whole dense
        # layers from ks[4] and keeps their attention leaves; only those
        # are drawn here (the same floats: each leaf has its own key)
        p["dec_cross"] = _stack_init(_attn_layer_init, cfg, ks[4], cfg.L,
                                     dt, dev)
        p["enc_norm"] = leaf(_ones(D))
    elif cfg.family in KV_FAMILIES:
        p["layers"] = _stack_init(_dense_layer_init, cfg, ks[2], cfg.L, dt,
                                  dev)
    else:
        p["layers"] = _stack_init(_ssm_layer_init, cfg, ks[2], cfg.L, dt,
                                  dev)
    if cfg.family == "hybrid":
        shared = _dense_layer_init(dataclasses.replace(cfg, family="dense"),
                                   ks[3])
        p["shared_attn"] = {k: leaf(v) for k, v in shared.items()}
    return p


# --------------------------------------------------------------------------
# forward passes
# --------------------------------------------------------------------------


def _attn_sublayer(pl, x, cfg, *, causal, q_offset=0, window=0,
                   kv_cache=None, cache_pos=None, mesh_axes=None):
    """Attention residual sub-layer.

    Returns (x', info) with info["kv"] = this block's (roped) K/V — what a
    prefill writes to the cache — and info["cache"] = the full cache
    when one was passed in (decode), written in place at ``cache_pos``
    (the JAX package's `dynamic_update_slice`, start clamped alike).
    """
    xn = L.gather_seq(L.rms_norm(x, pl["ln1"], cfg.norm_eps), cfg, mesh_axes)
    q, k, v = L.qkv_proj(pl, xn, cfg)
    S = xn.shape[1]
    if mesh_axes and cfg.n_heads_padded % mesh_axes["ntp"] != 0 and S > 1:
        # ring-attention layout: queries sequence-sharded over tp, K/V
        # whole over tp (heads the model axis does not divide)
        dp, tp = mesh_axes["dp"], mesh_axes["tp"]
        q = constrain(q, P(dp, tp, None, None))
        k = constrain(k, P(dp, None, None, None))
        v = constrain(v, P(dp, None, None, None))
    pos = q_offset + torch.arange(S, device=x.device)
    q = L.rope(q, pos, cfg.rope_theta)
    k = L.rope(k, pos, cfg.rope_theta)
    info = {"kv": (k, v), "cache": None}
    if kv_cache is not None:
        ck, cv = kv_cache
        at = min(max(int(cache_pos), 0), ck.shape[1] - S)
        ck[:, at:at + S] = k.to(ck.dtype)
        cv[:, at:at + S] = v.to(cv.dtype)
        k, v = ck.to(x.dtype), cv.to(x.dtype)
        info["cache"] = (ck, cv)
    o = L.attention(q, k, v, q_offset=q_offset, causal=causal,
                    query_chunk=cfg.query_chunk, window=window)
    return x + L.scatter_seq(L.attn_out(pl, o, x.dtype), cfg,
                             mesh_axes), info


def _cross_sublayer(plx, h, xk, xv, cfg):
    """Cross-attention residual sub-layer: queries from ``h`` through
    ``plx``'s ``ln1`` and ``wq`` (no RoPE), against the K/V ``xk``/``xv``
    [B, T, Hkv, hd] of every encoder position (not causal)."""
    q = L.q_proj(plx, L.rms_norm(h, plx["ln1"], cfg.norm_eps), cfg)
    o = L.attention(q, xk, xv, q_offset=0, causal=False,
                    query_chunk=cfg.query_chunk)
    return h + L.attn_out(plx, o, h.dtype)


def _cross_kv(plx, xe):
    """The encoder output ``xe`` [B, T, D] → a decoder layer's cross K/V
    [B, T, Hkv, hd] in ``xe``'s dtype: ``wk`` and ``wv`` alone — no
    bias, no k-norm, no RoPE, as the reference projects them."""
    return tuple(torch.einsum("bsd,dhk->bshk", xe, plx[n].to(xe.dtype))
                 for n in ("wk", "wv"))


def _ffn_sublayer(pl, x, cfg, mesh=None, mesh_axes=None, shard_seq=True):
    """The MLP residual sub-layer; the moe family's routed experts run
    `moe_dense_ref` without a mesh, else `moe_ffn_ep2d` (with
    ``cfg.moe_ep2d`` and ``shard_seq``) or `moe_ffn` at
    ``cfg.moe_capacity``, then arctic's dense residual MLP."""
    check_family(cfg)
    xn = L.rms_norm(x, pl["ln2"], cfg.norm_eps)
    if cfg.family == "moe" and cfg.n_experts:
        eid, gate = MOE.router(pl, xn, cfg)
        if mesh is None:
            y = MOE.moe_dense_ref(pl, xn, eid, gate, cfg)
        elif cfg.moe_ep2d and shard_seq:
            y = MOE.moe_ffn_ep2d(pl, xn, eid, gate, cfg, mesh, mesh_axes,
                                 capacity_factor=cfg.moe_capacity)
        else:
            y = MOE.moe_ffn(pl, xn, eid, gate, cfg, mesh, mesh_axes,
                            capacity_factor=cfg.moe_capacity,
                            shard_seq=shard_seq)
        if cfg.moe_dense_ff:
            xg = L.gather_seq(xn, cfg, mesh_axes)
            y = y + L.scatter_seq(
                L.mlp(dict(w1=pl["w1d"], w3=pl["w3d"], w2=pl["w2d"]), xg),
                cfg, mesh_axes)
        return x + y
    xg = L.gather_seq(xn, cfg, mesh_axes)
    return x + L.scatter_seq(L.mlp(pl, x=xg), cfg, mesh_axes)


def _dense_block(pl, x, cfg, mesh=None, mesh_axes=None, *, causal=True,
                 q_offset=0, window=0, kv_cache=None, cache_pos=None,
                 shard_seq=True):
    x, info = _attn_sublayer(pl, x, cfg, causal=causal, q_offset=q_offset,
                             window=window, kv_cache=kv_cache,
                             cache_pos=cache_pos, mesh_axes=mesh_axes)
    x = _ffn_sublayer(pl, x, cfg, mesh, mesh_axes, shard_seq=shard_seq)
    return x, info


def layer(stacked: dict, i: int) -> dict:
    """Layer ``i`` of a stacked layer dict (views, no copy)."""
    return {k: v[i] for k, v in stacked.items()}


def unstack(stacked: dict) -> list:
    """A stacked layer dict → one dict per layer of `unbind` views: the
    backward stacks each weight's per-layer gradients once.  One layer's
    views are `squeeze`s, whose backward is a view: its gradients are
    never copied (an expert stack's is 4.2 GB at dbrx-132b)."""
    if next(iter(stacked.values())).shape[0] == 1:
        return [{k: v.squeeze(0) for k, v in stacked.items()}]
    return [dict(zip(stacked, vs)) for vs in zip(
        *(v.unbind(0) for v in stacked.values()))]


def _scan_layers(body, x, per_layer: list, remat: bool = False):
    """``body(pl, x) → x`` over `unstack`'s layers, layer by layer (the
    JAX package's scan).  With ``remat`` and grad enabled each layer runs
    under `torch.utils.checkpoint` (the reference's `jax.checkpoint`):
    only its input is kept, and its activations are recomputed in the
    backward pass."""
    remat = remat and torch.is_grad_enabled()
    for pl in per_layer:
        x = (torch.utils.checkpoint.checkpoint(body, pl, x,
                                               use_reentrant=False)
             if remat else body(pl, x))
    return x


def shard_vocab(x, mesh_axes):
    """Pin a [..., V] tensor to the table's vocab layout, ``P(dp, …,
    tp)`` (a constraint: ``x`` is returned as it is)."""
    if mesh_axes and x.ndim >= 2:
        return constrain(x, P(*([mesh_axes["dp"]] + [None] * (x.ndim - 2)
                                + [mesh_axes["tp"]])))
    return x


def embed_tokens(p, cfg, tokens, mesh_axes=None, one_hot=True):
    """Token lookup as the reference's one-hot product in ``cfg.dtype``
    (its vocab-sharded form), or with ``one_hot=False`` its row gather."""
    dt = L.torch_dtype(cfg.dtype)
    if not one_hot:
        return p["embed"][tokens.long()].to(dt)
    V = p["embed"].shape[0]
    # a comparison, not `F.one_hot`, whose range check reads the ids back
    # to the host (a stream sync every decode step)
    oh = shard_vocab((tokens.long()[..., None]
                      == torch.arange(V, device=tokens.device)).to(dt),
                     mesh_axes)
    return torch.einsum("bsv,vd->bsd", oh, p["embed"].to(dt))


def out_embedding(p, cfg):
    return p["embed"] if cfg.tie_embeddings else p["out_embed"]


def _ssm_body(cfg: ArchConfig, mesh_axes=None):
    """One Mamba2 residual layer, ``(pl, h) → h``."""
    def body(pl, h):
        xn = L.gather_seq(L.rms_norm(h, pl["ln"], cfg.norm_eps), cfg,
                          mesh_axes)
        return h + L.scatter_seq(SSM.mamba_block(pl, xn, cfg)[0], cfg,
                                 mesh_axes)
    return body


def _acts(body, cfg, mesh_axes):
    """``body`` with the stored activations' layout after it (the
    reference's `_scan_layers` step)."""
    if not mesh_axes:
        return body
    return lambda pl, h: L.shard_acts(body(pl, h), cfg, mesh_axes)


def mesh_context(mesh):
    """`use_mesh(mesh)`, or nothing without a mesh."""
    return contextlib.nullcontext() if mesh is None else use_mesh(mesh)


def forward(cfg: ArchConfig, p, batch, mesh=None, mesh_axes=None):
    """Token inputs → final hidden states [B, S, D] (normed).  With a
    frontend stub (vlm, or ``cfg.frontend == "embed_stub"`` outside
    encdec) ``batch["frontend_embeds"]`` [B, P, D], when given, is cast
    to ``cfg.dtype`` and prepended: the states are [B, P + S, D], causal
    over the prefix too.  encdec encodes the frontend embeddings and
    returns the decoder's states over the tokens (`_forward_encdec`).
    With ``mesh`` the moe family's experts run on it (module docstring)."""
    check_family(cfg)
    with mesh_context(mesh):
        if cfg.family == "encdec":
            return _forward_encdec(cfg, p, batch, mesh, mesh_axes)
        x = embed_tokens(p, cfg, batch["tokens"], mesh_axes)
        if ((cfg.family == "vlm" or cfg.frontend == "embed_stub")
                and "frontend_embeds" in batch):
            x = torch.cat([L.cast(batch["frontend_embeds"], cfg), x], dim=1)
        if cfg.family in KV_FAMILIES:
            body = lambda pl, h: _dense_block(pl, h, cfg, mesh,
                                              mesh_axes)[0]
            x = _scan_layers(_acts(body, cfg, mesh_axes), x,
                             unstack(p["layers"]), cfg.remat)
        elif cfg.family == "ssm":
            x = _scan_layers(_acts(_ssm_body(cfg, mesh_axes), cfg,
                                   mesh_axes), x, unstack(p["layers"]),
                             cfg.remat)
        else:
            x = _forward_hybrid(cfg, p, x, mesh, mesh_axes)
        return L.rms_norm(x, p["final_norm"], cfg.norm_eps)


def _hybrid_groups(cfg: ArchConfig):
    """[(start, size), ...] — the shared attention block runs before each
    group."""
    k = cfg.attn_every
    out, s = [], 0
    while s < cfg.L:
        out.append((s, min(k, cfg.L - s)))
        s += k
    return out


def _forward_hybrid(cfg, p, x, mesh=None, mesh_axes=None):
    """The shared block (with the hybrid ``cfg``), then the group's Mamba2
    layers, for each group; the layers are unstacked once, so each
    weight's gradient is stacked once over all the groups."""
    per_layer = unstack(p["layers"])
    body = _acts(_ssm_body(cfg, mesh_axes), cfg, mesh_axes)
    for start, size in _hybrid_groups(cfg):
        x, _ = _dense_block(p["shared_attn"], x, cfg, mesh, mesh_axes,
                            causal=True)
        x = _scan_layers(body, x, per_layer[start:start + size], cfg.remat)
    return x


def _encode(cfg: ArchConfig, p, frontend_embeds, mesh=None, mesh_axes=None):
    """encdec's encoder: the frame embeddings [B, T, D] in ``cfg.dtype``
    through ``p["enc"]``'s dense layers, bidirectional (still roped, as
    the reference's self-attention always is), then ``enc_norm``."""
    body = lambda pl, h: _dense_block(pl, h, cfg, mesh, mesh_axes,
                                      causal=False)[0]
    xe = _scan_layers(_acts(body, cfg, mesh_axes),
                      L.cast(frontend_embeds, cfg), unstack(p["enc"]),
                      cfg.remat)
    return L.rms_norm(xe, p["enc_norm"], cfg.norm_eps)


def _forward_encdec(cfg, p, batch, mesh=None, mesh_axes=None):
    """The encoder over ``batch["frontend_embeds"]``, then each decoder
    layer: causal self-attention, cross-attention on the encoder's
    output (`_cross_kv`), the MLP; then ``final_norm``."""
    xe = _encode(cfg, p, batch["frontend_embeds"], mesh, mesh_axes)

    def body(pls, h):
        pl, plx = pls
        h, _ = _attn_sublayer(pl, h, cfg, causal=True, mesh_axes=mesh_axes)
        h = _cross_sublayer(plx, h, *_cross_kv(plx, xe), cfg)
        return _ffn_sublayer(pl, h, cfg, mesh, mesh_axes)

    x = _scan_layers(_acts(body, cfg, mesh_axes),
                     embed_tokens(p, cfg, batch["tokens"], mesh_axes),
                     list(zip(unstack(p["dec"]), unstack(p["dec_cross"]))),
                     cfg.remat)
    return L.rms_norm(x, p["final_norm"], cfg.norm_eps)
