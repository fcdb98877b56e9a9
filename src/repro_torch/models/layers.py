"""Transformer building blocks — plain PyTorch, param-dict style
(`repro/models/layers.py`).

Conventions, as the JAX package's:
  * params are dicts of tensors; layer stacks carry a leading L dim;
  * compute dtype is cfg.dtype (bf16), accumulation/softmax in f32;
  * attention is query-chunked and supports GQA, RoPE, qk-norm, biases,
    sliding windows, and decode-with-cache.

The JAX package's attention is plain `jnp` math, not a Pallas kernel, so
its counterpart here is the same chunked masked softmax in `torch`.  The
sequence-sharding helpers (`shard_acts`, `gather_seq`, `scatter_seq`)
are not ported: one device holds the whole sequence (ROADMAP Queue 1
item 9, `models/sharding.py`).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


def cast(x, cfg: ArchConfig):
    return x.to(torch_dtype(cfg.dtype))


def rms_norm(x, w, eps: float):
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def rope(x, positions, theta: float):
    """x [..., S, H, D]; positions [..., S] (broadcastable)."""
    d = x.shape[-1]
    half = d // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=x.device)
    # Python scalars, not device tensors: a host→device copy would wait
    # for the stream on every layer
    freqs = 1.0 / (float(theta) ** (ar / half))
    ang = positions[..., None].float() * freqs               # [..., S, half]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _attend_block(q, k, v, qpos, kpos, window: int, causal: bool):
    """q [B,Sq,Hkv,G,D] vs k/v [B,T,Hkv,D] → [B,Sq,Hkv,G,D]. f32 scores
    (the operands' products are exact in f32, as the JAX package's
    ``preferred_element_type``)."""
    scores = torch.einsum("bqhgd,bthd->bhgqt", q.float(), k.float())
    scores = scores / math.sqrt(q.shape[-1])     # float32(√D), as JAX
    mask = torch.ones((), dtype=torch.bool, device=q.device)
    dq = qpos[:, None]   # [Sq,1]
    dk = kpos[None, :]   # [1,T]
    if causal:
        mask = mask & (dk <= dq)
    if window:
        mask = mask & (dk > dq - window)
    scores = torch.where(mask[None, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhgqt,bthd->bqhgd", probs.to(v.dtype), v)


def attention(q, k, v, *, q_offset, causal: bool, query_chunk: int,
              window: int = 0):
    """GQA attention, chunked over queries.

    q [B,S,H,D], k/v [B,T,Hkv,D].  q_offset: absolute position of q[0]
    (decode: T_past; train/prefill: 0).
    """
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, S, Hkv, G, D)
    T = k.shape[1]
    kpos = torch.arange(T, device=q.device)
    qc = min(query_chunk, S)
    nchunks = -(-S // qc)
    if nchunks == 1:
        qpos = q_offset + torch.arange(S, device=q.device)
        out = _attend_block(qg, k, v, qpos, kpos, window, causal)
        return out.reshape(B, S, H, D)

    pad = nchunks * qc - S
    qg = torch.nn.functional.pad(qg, (0, 0, 0, 0, 0, 0, 0, pad))
    qg = qg.reshape(B, nchunks, qc, Hkv, G, D)
    outs = []
    for c in range(nchunks):
        qpos = q_offset + c * qc + torch.arange(qc, device=q.device)
        outs.append(_attend_block(qg[:, c], k, v, qpos, kpos, window,
                                  causal))
    out = torch.cat(outs, dim=1).reshape(B, nchunks * qc, H, D)
    return out[:, :S]


def q_proj(p, x, cfg: ArchConfig):
    """x [B,S,D] → q [B,S,H,hd]: `qkv_proj`'s q alone (a cross-attention
    takes its K/V from elsewhere)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    return q


def qkv_proj(p, x, cfg: ArchConfig):
    """x [B,S,D] → q [B,S,H,hd], k/v [B,S,Hkv,hd] with RoPE-ready layout."""
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if cfg.qkv_bias:
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q_proj(p, x, cfg), k, v


def attn_out(p, o, x_dtype):
    return torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x_dtype))


def mlp(p, x):
    g = torch.einsum("bsd,df->bsf", x, p["w1"].to(x.dtype))
    u = torch.einsum("bsd,df->bsf", x, p["w3"].to(x.dtype))
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    return torch.einsum("bsf,fd->bsd", h, p["w2"].to(x.dtype))
