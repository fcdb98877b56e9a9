"""Meta-tensor input stand-ins for every (arch × shape) cell
(`repro/launch/specs.py`).

Nothing here allocates: every tensor lives on torch's ``meta`` device,
the port's counterpart of a ``jax.ShapeDtypeStruct``.  The parameters
come from ``lm.init_params(..., device="meta")`` (`param_specs`), the
counterpart of ``jax.eval_shape(init_params)``; batches and caches are
explicit meta trees in the reference's dtypes (bfloat16 frontend
embeddings, int32 tokens, labels and candidates).  The VLM and audio
frontends are stubs: ``frontend_embeds`` are precomputed patch or frame
embeddings.

A decode cell's cache is `steps.init_cache` on ``meta``: its ``pos`` is
the Python int 0 the port's decode step takes, where the reference's is
an int32 scalar array.
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import lm, steps

VLM_PATCHES = 2880          # anyres: 5 tiles × 576 patches


def meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def param_specs(cfg: ArchConfig, model_shards: int = 16) -> dict:
    """The parameter tree's shapes and dtypes, drawn nowhere."""
    return lm.init_params(cfg, prng.PRNGKey(0), model_shards=model_shards,
                          device="meta")


def batch_specs_for(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Train/prefill batch meta tree."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if cfg.family == "encdec":
        out = {"frontend_embeds": meta((B, S, cfg.d_model), torch.bfloat16),
               "tokens": meta((B, S), i32), "labels": meta((B, S), i32)}
        if cfg.lsh_softmax:
            out["cands"] = meta((cfg.lsh_candidates,), i32)
        return out
    if cfg.family == "vlm" or cfg.frontend == "embed_stub":
        npatch = min(VLM_PATCHES, S // 2)    # scale the stub for tiny shapes
        S_txt = S - npatch
        return {"frontend_embeds": meta((B, npatch, cfg.d_model),
                                        torch.bfloat16),
                "tokens": meta((B, S_txt), i32),
                "labels": meta((B, S_txt), i32)}
    out = {"tokens": meta((B, S), i32), "labels": meta((B, S), i32)}
    if cfg.lsh_softmax:
        out["cands"] = meta((cfg.lsh_candidates,), i32)
    return out


def prefill_specs_for(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    b = batch_specs_for(cfg, shape)
    b.pop("labels", None)
    return b


def decode_specs_for(cfg: ArchConfig, shape: ShapeSpec):
    """(cache, tokens) — one new token against a seq_len cache."""
    B, T = shape.global_batch, shape.seq_len
    cache = steps.init_cache(cfg, B, T, device="meta")
    return cache, meta((B, 1), torch.int32)


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    if shape.kind == "train":
        return {"batch": batch_specs_for(cfg, shape)}
    if shape.kind == "prefill":
        return {"batch": prefill_specs_for(cfg, shape)}
    cache, tokens = decode_specs_for(cfg, shape)
    return {"cache": cache, "tokens": tokens}
