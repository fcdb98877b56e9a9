"""Serving steps for the dense family: KV caches, prefill and decode
(`repro/models/steps.py`'s serving half).

The JAX package's `make_*` factories close over the config and return
functions for `jax.jit`; these return plain functions.  The training half
(`lm_loss`, `adam_update`, `make_train_step`) is not ported yet (ROADMAP
Queue 1 item 9), nor are the other families' caches and steps
(`NotImplementedError`).

Differences from the JAX package's functional steps: a decode step
writes the new K/V into the cache it was given (the JAX `launch/serve.py`
donates that cache), and the cache's ``pos`` is a host int.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import lm


def init_cache(cfg: ArchConfig, B: int, T: int, dtype=torch.bfloat16,
               device=None):
    """Empty caches sized for total context T."""
    lm.check_family(cfg)
    dev = resolve_device(device)
    shape = (cfg.L, B, T, cfg.n_kv, cfg.hd)
    return {"pos": 0,
            "k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def logits_of(cfg: ArchConfig, p, h):
    """h [..., D] against the output embedding in ``cfg.dtype`` → float32
    logits (the products of ``cfg.dtype`` operands are exact in float32,
    as the reference's ``preferred_element_type``)."""
    E = lm.out_embedding(p, cfg).to(L.torch_dtype(cfg.dtype))
    return h.float() @ E.float().T


def make_decode_step(cfg: ArchConfig):
    """→ ``decode(params, cache, tokens [B, 1]) → (logits [B, 1, V]
    float32, cache)``."""
    lm.check_family(cfg)

    @torch.no_grad()
    def decode_dense(params, cache, tokens):
        x = lm.embed_tokens(params, cfg, tokens)                     # [B,1,D]
        pos = cache["pos"]
        h = x
        for i in range(cfg.L):
            pl = lm.layer(params["layers"], i)
            h, _ = lm._attn_sublayer(
                pl, h, cfg, causal=True, q_offset=pos,
                kv_cache=(cache["k"][i], cache["v"][i]), cache_pos=pos)
            h = lm._ffn_sublayer(pl, h, cfg)
        h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
        return logits_of(cfg, params, h), dict(cache, pos=pos + 1)

    return decode_dense


def make_prefill(cfg: ArchConfig):
    """Forward over the prompt → (last-token logits [B, V] float32, cache
    of the prompt's K/V in bfloat16)."""
    lm.check_family(cfg)

    @torch.no_grad()
    def prefill_dense(params, batch):
        x = lm.embed_tokens(params, cfg, batch["tokens"])
        T = x.shape[1]
        h, ks, vs = x, [], []
        for i in range(cfg.L):
            pl = lm.layer(params["layers"], i)
            h, info = lm._attn_sublayer(pl, h, cfg, causal=True)
            k, v = info["kv"]
            h = lm._ffn_sublayer(pl, h, cfg)
            ks.append(k.to(torch.bfloat16))
            vs.append(v.to(torch.bfloat16))
        h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
        logits = logits_of(cfg, params, h[:, -1])
        return logits, {"k": torch.stack(ks), "v": torch.stack(vs),
                        "pos": T}

    return prefill_dense
