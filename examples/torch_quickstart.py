"""Quickstart on the PyTorch/CUDA port: train LSH-MF (the paper's model)
on synthetic sparse data (`examples/quickstart.py` through `repro_torch`).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Builds a MovieLens-like sparse matrix, finds Top-K item neighbours with
simLSH (no GSM!), trains the nonlinear neighbourhood MF with the fused
Eq.(5) SGD — on the card every conflict-free batch is one launch of the
`culsh_sgd` kernel — and prints test RMSE per epoch.  Runs on ``cuda``
unless ``--device cpu`` is given (the kernels' plain versions).
"""
import argparse
import dataclasses
import json

import numpy as np

from repro_torch.core.simlsh import SimLSHConfig
from repro_torch.data import synthetic as syn
from repro_torch.data.sparse import train_test_split
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
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--report", action="store_true",
                    help="print the kernels' launch counts as a JSON line")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    spec = dataclasses.replace(syn.MOVIELENS_LIKE, M=args.M, N=args.N,
                               nnz=args.nnz)
    rows, cols, vals, _ = syn.generate(spec, seed=0)
    tr, te = train_test_split(np.random.default_rng(0), rows, cols, vals)

    cfg = FitConfig(
        F=32, K=16, epochs=args.epochs, batch=4096,
        method="simlsh",                      # try: gsm | rand | rp_cos | minhash | none
        lsh=SimLSHConfig(G=8, p=1, q=20, band_cap=16, psi_pow=2.0),
        use_kernels=True,
    )
    res = fit(tr, te, (spec.M, spec.N), cfg, log=print, device=dev)
    print(f"neighbour search took {res.neighbour_seconds:.2f}s "
          f"(GSM would be O(N²) = {spec.N ** 2:,} similarities)")
    if args.report:
        print("report " + json.dumps(dict(launches=launch_counts(),
                                          rmse=res.history[-1][2])))
    return dict(rmse=res.history[-1][2], history=res.history)


if __name__ == "__main__":
    main()
