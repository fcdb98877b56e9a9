"""LM training entry point (`repro/launch/train.py`): a synthetic zipf token
stream → `make_train_step(cfg)` → Adam, with crash-atomic checkpoints
(kill it mid-run and rerun: it resumes from the newest complete step).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
      [--reduced] [--steps 50 --batch 8 --seq 128] [--ckpt-dir DIR \
      --ckpt-every 10] [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given.  The batches are the
JAX package's numpy draws for the seed, so both packages train on the
same tokens.  As in the reference, a resumed run draws its batches from
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


def synth_batch(rng, cfg, batch, seq, device="cpu"):
    """Zipf-distributed token ids over the vocab (padded ids never
    sampled) → {"tokens", "labels"} [batch, seq] int32 on ``device``.
    (The reference also draws stub frontend embeddings for the families
    that have a frontend; none of them is ported.)"""
    V = cfg.vocab
    p = 1.0 / np.arange(1, V + 1) ** 1.1
    p /= p.sum()
    toks = rng.choice(V, size=(batch, seq + 1), p=p).astype(np.int32)
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return {"tokens": on(toks[:, :-1]), "labels": on(toks[:, 1:])}


def train_loop(cfg, *, steps_n, batch, seq, ckpt_dir=None, ckpt_every=0,
               lr=3e-4, log=print, seed=0, device=None, params=None):
    """Train ``steps_n`` steps → (params, opt, losses of the steps run).
    ``params`` replaces the seed's draw (another package's parameters,
    through `convert.lm_params_from_numpy`).  With ``ckpt_dir`` it resumes
    from the newest complete checkpoint there, saves every
    ``ckpt_every`` steps and at the end."""
    lm.check_family(cfg)
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if params is None:
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
