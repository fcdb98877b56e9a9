"""Model assembly for the dense family (`repro/models/lm.py`).

The JAX package assembles every family (dense | moe | ssm | hybrid |
encdec | vlm); the port has the dense one, which `launch/serve.py`
serves.  The others raise `NotImplementedError` (ROADMAP Queue 1 item
9).  Layer stacks are dicts of tensors with a leading L dim, applied
layer by layer (the JAX package's `lax.scan`); on one device there is
no sharding constraint and no scheduling barrier (`_opt_barrier` pins
the FSDP gathers of training).  Training remats each layer, as the
reference does (`_scan_layers`).

Weights are kept in ``cfg.param_dtype`` (float32) and cast to
``cfg.dtype`` (bfloat16) where they are used, as in the reference.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch import prng
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L

PORTED_FAMILIES = ("dense",)


def check_family(cfg: ArchConfig) -> None:
    """Raise unless ``cfg``'s family is ported."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported to "
            f"repro_torch yet (ROADMAP.md, Queue 1 item 9); only "
            f"{PORTED_FAMILIES} runs")


# --------------------------------------------------------------------------
# parameter initialization
# --------------------------------------------------------------------------


def _normal(key, shape, scale: float, device) -> torch.Tensor:
    """``scale · jax.random.normal(key, shape, float32)``."""
    s = torch.tensor(scale, dtype=torch.float32, device=device)
    return s * prng.normal_chunked(key, shape, device=device)


def _dense_layer_init(cfg: ArchConfig, key, scale, device="cpu"):
    hd, D, ff = cfg.hd, cfg.d_model, cfg.d_ff
    ks = prng.split(key, 8)
    ones = lambda *s: torch.ones(s, dtype=torch.float32, device=device)
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    nrm = lambda k, *s: _normal(k, s, scale, device)
    Hp = cfg.n_heads_padded
    p = dict(
        ln1=ones(D),
        ln2=ones(D),
        wq=nrm(ks[0], D, Hp, hd),
        wk=nrm(ks[1], D, cfg.n_kv, hd),
        wv=nrm(ks[2], D, cfg.n_kv, hd),
        wo=nrm(ks[3], Hp, hd, D),
    )
    if cfg.qkv_bias:
        p |= dict(bq=zeros(Hp, hd), bk=zeros(cfg.n_kv, hd),
                  bv=zeros(cfg.n_kv, hd))
    if cfg.qk_norm:
        p |= dict(q_norm=ones(hd), k_norm=ones(hd))
    p |= dict(w1=nrm(ks[5], D, ff), w3=nrm(ks[6], D, ff),
              w2=nrm(ks[7], ff, D))
    return p


def _stack_init(per_layer_fn, cfg, key, n, device="cpu"):
    """The JAX package's `vmap` of ``per_layer_fn`` over ``split(key, n)``:
    each layer is drawn from its own key into its slice of the stack, so
    only one layer's draw is ever held beside the stack."""
    keys = prng.split(key, n)
    out = None
    for li in range(n):
        layer = per_layer_fn(cfg, keys[li], 0.02, device)
        if out is None:
            out = {k: torch.empty((n, *v.shape), dtype=v.dtype,
                                  device=device) for k, v in layer.items()}
        for k, v in layer.items():
            out[k][li] = v
        del layer
    return out


def init_params(cfg: ArchConfig, key, model_shards: int = 16, device=None):
    """The JAX package's `init_params` for the dense family: the same keys
    and draws (each float within a few ulp: `prng.normal`), on ``device``
    (``cuda`` unless asked)."""
    check_family(cfg)
    if cfg.param_dtype != "float32":
        raise NotImplementedError(
            f"{cfg.name}: drawing {cfg.param_dtype} parameters is not "
            f"ported (ROADMAP.md, Queue 1 item 9); use param_dtype="
            f"'float32'")
    dev = resolve_device(device)
    ks = prng.split(key, 6)
    V = cfg.vocab_padded(model_shards)
    D = cfg.d_model
    p = dict(
        embed=_normal(ks[0], (V, D), 0.02, dev),
        final_norm=torch.ones((D,), dtype=torch.float32, device=dev),
    )
    if not cfg.tie_embeddings:
        p["out_embed"] = _normal(ks[1], (V, D), 0.02, dev)
    p["layers"] = _stack_init(_dense_layer_init, cfg, ks[2], cfg.L, dev)
    return p


# --------------------------------------------------------------------------
# forward passes
# --------------------------------------------------------------------------


def _attn_sublayer(pl, x, cfg, *, causal, q_offset=0, window=0,
                   kv_cache=None, cache_pos=None):
    """Attention residual sub-layer.

    Returns (x', info) with info["kv"] = this block's (roped) K/V — what a
    prefill writes to the cache — and info["cache"] = the full cache
    when one was passed in (decode), written in place at ``cache_pos``
    (the JAX package's `dynamic_update_slice`, start clamped alike).
    """
    xn = L.rms_norm(x, pl["ln1"], cfg.norm_eps)
    q, k, v = L.qkv_proj(pl, xn, cfg)
    S = xn.shape[1]
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
    return x + L.attn_out(pl, o, x.dtype), info


def _ffn_sublayer(pl, x, cfg):
    check_family(cfg)
    return x + L.mlp(pl, x=L.rms_norm(x, pl["ln2"], cfg.norm_eps))


def _dense_block(pl, x, cfg, *, causal=True, q_offset=0, window=0,
                 kv_cache=None, cache_pos=None):
    x, info = _attn_sublayer(pl, x, cfg, causal=causal, q_offset=q_offset,
                             window=window, kv_cache=kv_cache,
                             cache_pos=cache_pos)
    x = _ffn_sublayer(pl, x, cfg)
    return x, info


def layer(stacked: dict, i: int) -> dict:
    """Layer ``i`` of a stacked layer dict (views, no copy)."""
    return {k: v[i] for k, v in stacked.items()}


def _scan_layers(body, x, stacked, remat: bool = False):
    """``body(pl, x) → x`` over a stacked layer dict, layer by layer (the
    JAX package's scan).  With ``remat`` and grad enabled each layer runs
    under `torch.utils.checkpoint` (the reference's `jax.checkpoint`):
    only its input is kept, and its activations are recomputed in the
    backward pass.  The layers are `unbind` views, so the backward
    stacks each weight's per-layer gradients once."""
    per_layer = [dict(zip(stacked, vs)) for vs in zip(
        *(v.unbind(0) for v in stacked.values()))]
    remat = remat and torch.is_grad_enabled()
    for pl in per_layer:
        x = (torch.utils.checkpoint.checkpoint(body, pl, x,
                                               use_reentrant=False)
             if remat else body(pl, x))
    return x


def embed_tokens(p, cfg, tokens):
    """Token lookup as the reference's one-hot product in ``cfg.dtype``
    (its vocab-sharded form; one device computes the same product)."""
    dt = L.torch_dtype(cfg.dtype)
    V = p["embed"].shape[0]
    # a comparison, not `F.one_hot`, whose range check reads the ids back
    # to the host (a stream sync every decode step)
    oh = (tokens.long()[..., None]
          == torch.arange(V, device=tokens.device)).to(dt)
    return torch.einsum("bsv,vd->bsd", oh, p["embed"].to(dt))


def out_embedding(p, cfg):
    return p["embed"] if cfg.tie_embeddings else p["out_embed"]


def forward(cfg: ArchConfig, p, batch):
    """Token inputs → final hidden states [B, S, D] (normed)."""
    check_family(cfg)
    x = embed_tokens(p, cfg, batch["tokens"])
    body = lambda pl, h: _dense_block(pl, h, cfg)[0]
    x = _scan_layers(body, x, p["layers"], cfg.remat)
    return L.rms_norm(x, p["final_norm"], cfg.norm_eps)
