"""Batched LM serving: prefill a prompt batch, decode tokens
(`repro/launch/serve.py`).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      [--reduced] [--batch 4 --prompt-len 64 --gen 32] [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given.  The dense, moe and
vlm families (``--arch dbrx-132b``, ``--arch llava-next-mistral-7b``)
are prefilled by one forward over the prompt that writes its K/V into
the cache — vlm's over the tokens alone, with no image prefix, as in
the reference; the ssm, hybrid and encdec families (``--arch
mamba2-370m``, ``--arch zamba2-7b``, ``--arch seamless-m4t-large-v2``)
by sequential decode, as in the reference.  encdec's cross K/V caches
stay `init_cache`'s zeros, as the reference's `serve` leaves them (the
JAX package has no function that fills them): the cross-attention then
adds exactly 0, and the served tokens depend on no source input.  The
weights are drawn on the card from the seed's key in the config's
``param_dtype``, one leaf at a time into their layer stacks.  In
float32: llama3-8b's 8.0·10⁹ parameters (32 GB), llava-next-mistral-7b's
7.24·10⁹ (29 GB), zamba2-7b's 6.75·10⁹ (27 GB), seamless-m4t-large-v2's
2.03·10⁹ (8.1 GB); dbrx-132b's 40 layers (1.3·10¹¹) do not fit one card,
its widths do at L ≤ 4 (1.43·10¹⁰, 57 GB).  In bfloat16, used at
bfloat16 compute without a copy: llama3-405b is 3.19·10⁹ parameters a
layer (6.38 GB) plus 8.41 GB of untied embeddings, so one card holds L =
8 of its 126 (2.97·10¹⁰, 59.41 GB); arctic-480b is 1.36·10¹⁰ a layer
(27.22 GB) plus 0.92 GB, so L = 2 of its 35 (2.77·10¹⁰, 55.36 GB).  The
logits never hold a float32 copy of a bfloat16 output table
(`steps.logits_of`).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs import base as CB
from repro_torch.device import resolve_device
from repro_torch.models import lm, steps


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def serve(cfg, *, batch, prompt_len, gen, seed=0, log=print, device=None,
          params=None):
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then
    decode ``gen`` tokens greedily → (tokens [batch, gen + 1] int32, stats).
    ``params`` replaces the seed's draw (another package's parameters,
    through `convert.lm_params_from_numpy`)."""
    dev = resolve_device(device)
    lm.check_family(cfg)
    rng = np.random.default_rng(seed)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    if params is None:
        params = lm.init_params(cfg, prng.PRNGKey(seed), model_shards=1,
                                device=dev)
    _sync(dev)
    t_init = time.perf_counter() - t0
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (
        batch, prompt_len)).astype(np.int32)).to(dev)
    T = prompt_len + gen

    decode = steps.make_decode_step(cfg)
    cache = steps.init_cache(cfg, batch, T, device=dev)

    # one forward over the prompt for dense, moe and vlm; sequential
    # decode for the ssm, hybrid and encdec families
    t0 = time.perf_counter()
    if cfg.family in lm.KV_FAMILIES:
        logits, pc = steps.make_prefill(cfg)(params, {"tokens": toks})
        cache["k"][:, :, :prompt_len] = pc["k"].to(cache["k"].dtype)
        cache["v"][:, :, :prompt_len] = pc["v"].to(cache["v"].dtype)
        cache["pos"] = prompt_len
    else:
        for t in range(prompt_len):
            logits, cache = decode(params, cache, toks[:, t:t + 1])
        logits = logits[:, -1]
    last = torch.argmax(logits, -1).to(torch.int32)[:, None]
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out = [last]
    t0 = time.perf_counter()
    for _ in range(gen):
        logits, cache = decode(params, cache, out[-1])
        out.append(torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None])
    _sync(dev)
    t_decode = time.perf_counter() - t0
    toks_s = batch * gen / max(t_decode, 1e-9)
    stats = dict(init_s=t_init, prefill_s=t_prefill, decode_s=t_decode,
                 tok_per_s=toks_s)
    if dev.type == "cuda":
        stats |= dict(
            resident_mb=torch.cuda.memory_allocated(dev) / 1e6,
            peak_mb=torch.cuda.max_memory_allocated(dev) / 1e6)
    log(f"prefill {t_prefill:.2f}s  decode {t_decode:.2f}s "
        f"({toks_s:.1f} tok/s batched)")
    return torch.cat(out, dim=1), stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    cfg = CB.get(args.arch)
    if args.reduced:
        cfg = CB.reduced(cfg)
    return serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                 gen=args.gen, device=args.device)


if __name__ == "__main__":
    main()
