"""Online learning (paper Alg. 4) on the PyTorch/CUDA port: new users and
items arrive, the model updates incrementally — no retraining of existing
parameters (`examples/online_learning.py` through `repro_torch`).

    PYTHONPATH=src python examples/torch_online_learning.py [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given.
"""
import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import model, online
from repro_torch.core.sgd import Hyper
from repro_torch.core.simlsh import SimLSHConfig
from repro_torch.data import synthetic as syn
from repro_torch.data.sparse import from_coo, train_test_split
from repro_torch.device import resolve_device
from repro_torch.kernels import launch_counts
from repro_torch.train.trainer import FitConfig, fit


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--M", type=int, default=3000)
    ap.add_argument("--N", type=int, default=500)
    ap.add_argument("--nnz", type=int, default=150_000)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--report", action="store_true",
                    help="print the kernels' launch counts as a JSON line")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    spec = dataclasses.replace(syn.MOVIELENS_LIKE, M=args.M, N=args.N,
                               nnz=args.nnz)
    rows, cols, vals, _ = syn.generate(spec, seed=0)
    (tr_r, tr_c, tr_v), te = train_test_split(
        np.random.default_rng(0), rows, cols, vals)

    # "original" world = ids below the cut; the rest arrives later
    M0, N0 = spec.M - 100, spec.N - 16
    old = (tr_r < M0) & (tr_c < N0)
    lsh = SimLSHConfig(G=8, p=1, q=10, band_cap=16)
    cfg = FitConfig(F=32, K=16, epochs=args.epochs, method="simlsh", lsh=lsh,
                    eval_every=args.epochs, use_kernels=True)
    print("training on the original set...")
    res = fit((tr_r[old], tr_c[old], tr_v[old]), te, (M0, N0), cfg,
              device=dev)

    st = online.OnlineState(
        params=res.params, S=res.S, JK=res.JK,
        sp=from_coo(tr_r[old], tr_c[old], tr_v[old], (M0, N0), device=dev),
        M=M0, N=N0, hash_key=res.hash_key)

    print(f"{int((~old).sum()):,} new interactions arrive "
          f"(new users ≥ {M0}, new items ≥ {N0})")
    t0 = time.time()
    st2 = online.online_update(
        st, tr_r[~old], tr_c[~old], tr_v[~old], lsh, Hyper(),
        prng.PRNGKey(0), M_new=spec.M, N_new=spec.N, K=16, epochs=3)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_online = time.time() - t0

    te_r, te_c, te_v = (torch.from_numpy(np.asarray(a)).to(dev) for a in te)
    rmse = float(model.rmse(st2.params, st2.sp, st2.JK, te_r, te_c, te_v))
    print(f"online update: {t_online:.2f}s → rmse {rmse:.4f} "
          f"(retrain-from-scratch rmse for reference: run torch_quickstart)")
    if args.report:
        print("report " + json.dumps(dict(launches=launch_counts(),
                                          rmse=rmse)))
    return dict(rmse=rmse, base_rmse=res.history[-1][2], state=st2)


if __name__ == "__main__":
    main()
