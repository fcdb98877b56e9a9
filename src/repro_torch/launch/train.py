"""LM training entry point (`repro/launch/train.py`): a synthetic zipf token
stream → `make_train_step(cfg)` → Adam, with crash-atomic checkpoints
(kill it mid-run and rerun: it resumes from the newest complete step).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
      [--reduced] [--steps 50 --batch 8 --seq 128] [--ckpt-dir DIR \
      --ckpt-every 10] [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given, for every family:
dense, moe (``--arch dbrx-132b``, ``--arch arctic-480b``), ssm and
hybrid (``--arch mamba2-370m``, ``--arch zamba2-7b``), encdec and vlm
(``--arch seamless-m4t-large-v2``, ``--arch llava-next-mistral-7b``,
whose batches carry the reference's stub frame or patch embeddings).
At dbrx-132b's full width one 80 GB card holds the Adam state of one
layer only (float32 parameters and gradients, bfloat16 moments: 54 GB
at L = 1; `train_loop` on ``dataclasses.replace(cfg, L=1)``, as
`chip_smoke.py`'s phase 27 runs it); llava-next-mistral-7b's float32
state is 116 GB at its 32 layers and 53 GB at 14 (phase 29).
llama3-405b and arctic-480b train in their configs' bfloat16
parameters, gradients and moments, 8 bytes a parameter: llama3-405b at
L = 1 (its layer's 3.19·10⁹ parameters and 4.20·10⁹ of untied
embeddings, 59.12 GB), arctic-480b at L = 1 with 64 of its 128
experts (7.3754·10⁹ parameters, 59.00 GB; all 128 are 112.6 GB), both
at their own µ = 8 (phase 31).  The batches are the JAX package's numpy
draws for the seed, so both packages train on the same tokens and
embeddings.  As in the reference, a resumed run draws its batches from
the seed's first batch again, not from where the interrupted run
stopped.
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
from repro_torch.train import checkpoint as ckpt

# the stub image prefix of a frontend batch (the reference's draw)
FRONTEND_PATCHES = 16


def synth_batch(rng, cfg, batch, seq, device="cpu"):
    """Zipf-distributed token ids over the vocab (padded ids never
    sampled) → {"tokens", "labels"} [batch, seq] int32 on ``device``,
    and with a frontend stub (``cfg.frontend == "embed_stub"``) the
    reference's stub embeddings ``frontend_embeds``, float32 N(0, 0.02²):
    `FRONTEND_PATCHES` patches [batch, 16, d_model], or for encdec frames
    [batch, seq, d_model], drawn after the patches, which are dropped — the
    generator advances as the reference's does, so both packages draw
    the same batches step after step."""
    V = cfg.vocab
    p = 1.0 / np.arange(1, V + 1) ** 1.1
    p /= p.sum()
    toks = rng.choice(V, size=(batch, seq + 1), p=p).astype(np.int32)
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    out = {"tokens": on(toks[:, :-1]), "labels": on(toks[:, 1:])}
    if cfg.frontend == "embed_stub":
        fe = rng.normal(0, 0.02, (batch, FRONTEND_PATCHES, cfg.d_model)
                        ).astype(np.float32)
        if cfg.family == "encdec":
            fe = rng.normal(0, 0.02, (batch, seq, cfg.d_model)).astype(
                np.float32)
        out["frontend_embeds"] = on(fe)
    return out


def train_loop(cfg, *, steps_n, batch, seq, ckpt_dir=None, ckpt_every=0,
               lr=3e-4, log=print, seed=0, device=None):
    """Train ``steps_n`` steps → (params, opt, losses of the steps run).
    With ``ckpt_dir`` it resumes from the newest complete checkpoint
    there, saves every ``ckpt_every`` steps and at the end."""
    lm.check_family(cfg)
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    params = lm.init_params(cfg, prng.PRNGKey(seed), model_shards=1,
                            device=dev)
    opt = steps.init_opt(cfg, params)
    step_fn = steps.make_train_step(cfg, lr=lr)

    start = 0
    if ckpt_dir:
        restored = ckpt.try_restore(ckpt_dir, (params, opt))
        if restored is not None:
            (params, opt), start = restored
            log(f"resumed from step {start}")

    losses = []
    t0 = time.perf_counter()
    for s in range(start, steps_n):
        b = synth_batch(rng, cfg, batch, seq, device=dev)
        params, opt, aux = step_fn(params, opt, b)
        losses.append(float(aux["loss"]))
        if s % 10 == 0 or s == steps_n - 1:
            log(f"step {s:5d}  loss {losses[-1]:.4f}  "
                f"({(time.perf_counter()-t0)/(s-start+1):.2f}s/step)")
        if ckpt_dir and ckpt_every and (s + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, (params, opt), step=s + 1)
    if ckpt_dir:
        ckpt.save(ckpt_dir, (params, opt), step=steps_n, sync=True)
    return params, opt, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = CB.get(args.arch)
    if args.reduced:
        cfg = CB.reduced(cfg)
    _, _, losses = train_loop(cfg, steps_n=args.steps, batch=args.batch,
                              seq=args.seq, ckpt_dir=args.ckpt_dir,
                              ckpt_every=args.ckpt_every, lr=args.lr,
                              device=args.device)
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
