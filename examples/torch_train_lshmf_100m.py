"""End-to-end example on the PyTorch/CUDA port: train a ~100M-parameter
LSH-MF model for a few epochs, with checkpointing
(`examples/train_lshmf_100m.py` through `repro_torch`).

Model size: (M + N)·F + 3·N·K + M + N ≈ 100M params at
M=700k, N=30k, F=128, K=64 — the netflix-scale geometry of the paper.
Data is a matched synthetic sparse matrix (~2M interactions).  On the
card every conflict-free batch of an epoch is one launch of the
`culsh_sgd` kernel.

    PYTHONPATH=src python examples/torch_train_lshmf_100m.py [--small]
        [--resume] [--trace train_trace.json] [--device cpu]

Checkpoints go to ``--ckpt-dir`` (default: a directory under the
system's temporary directory); ``--resume`` goes on from the newest one.
"""
import argparse
import dataclasses
import json
import os
import shutil
import tempfile
import time

import numpy as np

from repro_torch import obs
from repro_torch.core.simlsh import SimLSHConfig
from repro_torch.data import synthetic as syn
from repro_torch.data.sparse import train_test_split
from repro_torch.device import resolve_device
from repro_torch.kernels import launch_counts
from repro_torch.train.trainer import FitConfig, fit


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--small", action="store_true",
                    help="10M-param variant (fast CI-style run)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the checkpoint dir instead of fresh")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write the fit's obs spans as Chrome trace-event "
                         "JSON (load in https://ui.perfetto.dev)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: under the "
                         "temporary directory)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--shape", default=None, metavar="M,N,F,K,NNZ,EPOCHS",
                    help="override the preset's sizes (tests)")
    ap.add_argument("--report", action="store_true",
                    help="print the kernels' launch counts as a JSON line")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.shape:
        M, N, F, K, nnz, epochs = (int(x) for x in args.shape.split(","))
    elif args.small:
        M, N, F, K, nnz, epochs = 80_000, 6_000, 64, 32, 400_000, 3
    else:
        M, N, F, K, nnz, epochs = 700_000, 30_000, 128, 64, 2_000_000, 3

    nparams = (M + N) * F + 3 * N * K + M + N
    print(f"model: M={M:,} N={N:,} F={F} K={K} → {nparams/1e6:.1f}M params")

    spec = dataclasses.replace(syn.MOVIELENS_LIKE, M=M, N=N, nnz=nnz)
    t0 = time.time()
    rows, cols, vals, _ = syn.generate(spec, seed=0)
    tr, te = train_test_split(np.random.default_rng(0), rows, cols, vals)
    print(f"data: {len(vals):,} interactions ({time.time()-t0:.1f}s)")

    steps_per_epoch = -(-len(tr[0]) // 8192)
    print(f"{epochs} epochs × {steps_per_epoch} steps "
          f"= {epochs * steps_per_epoch} optimizer steps")

    ckpt_dir = args.ckpt_dir or os.path.join(
        tempfile.gettempdir(),
        f"repro_torch_lshmf_100m_ckpt_{'small' if args.small else 'full'}")
    if not args.resume:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    cfg = FitConfig(
        F=F, K=K, epochs=epochs, batch=8192, method="simlsh",
        lsh=SimLSHConfig(G=8, p=1, q=10, band_cap=16),
        ckpt_dir=ckpt_dir, ckpt_every=1, use_kernels=True,
    )
    res = fit(tr, te, (M, N), cfg, log=print, device=dev)
    if not res.history:
        print(f"done: the checkpoint in {ckpt_dir} is already at epoch "
              f"{epochs}")
        return dict(rmse=None, history=[], ckpt_dir=ckpt_dir)
    print(f"done: rmse={res.history[-1][2]:.4f}, "
          f"neighbour stage {res.neighbour_seconds:.1f}s")

    # --- observability summary: every number below is read back from the
    # fit's obs registry — the same spans a --trace export shows in
    # Perfetto, so the printed summary and the trace can't drift
    reg = res.registry
    snap = reg.snapshot()
    print("\nobs summary (from the fit registry):")
    for name in ("train.neighbours", "train.prep", "train.compile",
                 "train.epoch", "train.epoch.eval", "train.ckpt"):
        s = snap["histograms"].get(name)
        if not s or not s["count"]:
            continue
        print(f"  {name:<18} n={s['count']:>3}  total={s['sum']:7.2f}s  "
              f"p50={s['p50'] * 1e3:8.1f}ms  p95={s['p95'] * 1e3:8.1f}ms")
    steady = reg.hist_summary("train.epoch")
    if steady["count"]:
        print(f"  steady-state epoch min={steady['min']:.3f}s "
              f"(compile {res.compile_seconds:.2f}s charged separately)")
    if args.trace:
        obs.write_trace(args.trace, reg)
        print(f"  trace → {args.trace} "
              f"({snap['spans']['retained']} spans; open in Perfetto)")
    if args.report:
        print("report " + json.dumps(dict(launches=launch_counts(),
                                          rmse=res.history[-1][2],
                                          epochs=len(res.history))))
    return dict(rmse=res.history[-1][2], history=res.history,
                ckpt_dir=ckpt_dir)


if __name__ == "__main__":
    main()
