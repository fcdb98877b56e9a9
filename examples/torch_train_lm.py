"""Train one of the assigned LM architectures (reduced config) end to end
on the PyTorch/CUDA port, with the paper's simLSH softmax toggled on or
off (`examples/train_lm.py` through `repro_torch`).

    PYTHONPATH=src python examples/torch_train_lm.py --arch qwen3-0.6b \
        [--steps 40] [--lsh-softmax] [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given.  With
``--lsh-softmax`` the output-embedding rows are hashed with simLSH every
10 steps, and each step's normaliser runs over the labels' bucket-mates
and random negatives; on the card the candidate rows' gradients add in
index order through the `segment_add` kernel.  The dense family runs;
the others raise `NotImplementedError`.
"""
import argparse
import dataclasses
import json

import numpy as np

from repro_torch import prng
from repro_torch.configs import base as CB
from repro_torch.device import resolve_device
from repro_torch.kernels import launch_counts
from repro_torch.launch.train import synth_batch, train_loop
from repro_torch.models import lm, steps
from repro_torch.models import lsh_softmax as LS


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--lsh-softmax", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--report", action="store_true",
                    help="print the kernels' launch counts as a JSON line")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = CB.reduced(CB.get(args.arch))
    print(f"arch={args.arch} family={cfg.family} (reduced) "
          f"lsh_softmax={args.lsh_softmax}")

    if not args.lsh_softmax:
        _, _, losses = train_loop(cfg, steps_n=args.steps, batch=8, seq=128,
                                  device=dev)
        print(f"loss {losses[0]:.3f} → {losses[-1]:.3f}")
    else:
        # paper-technique softmax: simLSH over output-embedding rows
        # selects the candidate vocabulary; signatures refresh every 10
        # steps
        cfg = dataclasses.replace(cfg, lsh_softmax=True, lsh_candidates=128)
        rng = np.random.default_rng(0)
        params = lm.init_params(cfg, prng.PRNGKey(0), model_shards=1,
                                device=dev)
        opt = steps.init_opt(cfg, params)
        step_fn = steps.make_train_step(cfg)
        st, losses = None, []
        for s in range(args.steps):
            b = synth_batch(rng, cfg, 8, 128, device=dev)
            if s % 10 == 0:
                st = LS.refresh(lm.out_embedding(params, cfg),
                                prng.fold_in(prng.PRNGKey(7), s))
            b["cands"] = LS.candidates_for(
                st, b["labels"], prng.fold_in(prng.PRNGKey(9), s),
                n_cands=cfg.lsh_candidates)
            params, opt, aux = step_fn(params, opt, b)
            losses.append(float(aux["loss"]))
            if s % 10 == 0 or s == args.steps - 1:
                print(f"step {s:4d} simLSH-softmax loss {losses[-1]:.3f}")
    if args.report:
        print("report " + json.dumps(dict(launches=launch_counts(),
                                          losses=losses)))
    return losses


if __name__ == "__main__":
    main()
