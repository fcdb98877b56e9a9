"""Recommendation serving on the PyTorch/CUDA port: train LSH-MF, build
the bucketed LSH index from the training signatures, then serve top-N
requests with candidate-only scoring — and fold an online update (paper
Alg. 4) into the running service without rebuilding the index
(`examples/serve_recsys.py` through `repro_torch`).

    PYTHONPATH=src python examples/torch_serve_recsys.py [--device cpu]

On the card the service runs the kernel walk: the `lsh_retrieve` kernel
(window walk + dedup) and the `candidate_score` kernel (gather, score,
top-N) once a flush; on the CPU (``--device cpu``) it runs the plain
walk, as the JAX package does there.

With ``--report`` it prints a ``report {...}`` JSON line with the
kernels' launch counters and, on the card, holds the kernel walk's
answer to one probe flush against its kernels' plain versions.

With ``--online-loop`` the example instead runs the always-on supervisor:
a drifting rating stream in, recommendations out, training micro-epochs
interleaved with serving on one device.  Interrupt it (ctrl-C) and run
the same command again — the loop resumes from its crash-safe checkpoint
+ WAL under ``--root``, exactly where it left off:

    PYTHONPATH=src python examples/torch_serve_recsys.py --online-loop
    ^C
    PYTHONPATH=src python examples/torch_serve_recsys.py --online-loop   # resumes
"""
import argparse
import dataclasses
import json
import os
import tempfile

import numpy as np

from repro_torch import prng
from repro_torch.core import online, simlsh
from repro_torch.core.simlsh import SimLSHConfig
from repro_torch.data import synthetic as syn
from repro_torch.data.sparse import from_coo, train_test_split
from repro_torch.device import resolve_device
from repro_torch.kernels import launch_counts
from repro_torch.kernels.candidate_score.ref import assert_topn_close
from repro_torch.serve import RecsysService, ServeConfig, build_index
from repro_torch.train.trainer import FitConfig, fit

SENTINEL = 2 ** 31 - 1


def _report(args, **extra) -> None:
    if args.report:
        print("report " + json.dumps(dict(launches=launch_counts(),
                                          **extra)))


def main(args) -> dict:
    dev = resolve_device(args.device)
    spec = dataclasses.replace(syn.MOVIELENS_LIKE, M=args.M, N=args.N,
                               nnz=args.nnz)
    rows, cols, vals, _ = syn.generate(spec, seed=0)
    tr, te = train_test_split(np.random.default_rng(0), rows, cols, vals)
    lsh = SimLSHConfig(G=8, p=1, q=10)
    cfg = FitConfig(F=32, K=16, epochs=args.epochs, method="simlsh", lsh=lsh,
                    eval_every=args.epochs, use_kernels=True)
    res = fit(tr, te, (spec.M, spec.N), cfg, log=print, device=dev)

    # ---- build the serving stack from the training byproducts ----
    sp = from_coo(*tr, (spec.M, spec.N), device=dev)
    sigs = simlsh.pack_bits(res.S >= 0)          # re-sign the Alg.4 cache
    index = build_index(sigs, tail_cap=256, device=dev)
    scfg = ServeConfig(topn=10, micro_batch=256, C=128, n_seeds=8, cap=8,
                       n_popular=32)
    svc = RecsysService(res.params, index, sp, scfg, JK=res.JK,
                        device=dev).warmup()

    # ---- serve a request stream ----
    rng = np.random.default_rng(1)
    for _ in range(20):
        svc.submit(rng.integers(0, spec.M, 256).astype(np.int32))
    svc.flush()
    st = svc.stats()
    print(f"candidate serving: {st['users']} users in {st['batches']} "
          f"batches → {st['qps']:,.0f} users/s (p50 {st['p50_ms']:.1f} ms)")

    # exactness check vs the dense full-scoring mode on one batch
    full = RecsysService(res.params, index, sp,
                         dataclasses.replace(scfg, mode="full"),
                         device=dev).warmup()
    probe = rng.integers(0, spec.M, 256).astype(np.int32)
    svc.take_results()
    svc.submit(probe); svc.flush()
    full.submit(probe); full.flush()
    probe_out = svc.take_results()[0]
    got = probe_out[2]
    want = full.take_results()[0][2]
    overlap = np.mean([len(set(got[u]) & set(want[u])) / got.shape[1]
                       for u in range(probe.shape[0])])
    print(f"recall@10 of candidate-only vs full scoring: {overlap:.3f}")
    print(f"full-scoring baseline: {full.stats()['qps']:,.0f} users/s")
    print("sample recommendations for user", int(probe[0]), ":", got[0])
    check = {}
    if args.report and scfg.kernel_impl(dev) == "cuda":
        # the kernel walk against its kernels' plain versions, on the
        # same probe flush (ServeConfig.interpret asks for them)
        plain = RecsysService(res.params, index, sp,
                              dataclasses.replace(scfg, interpret=True),
                              JK=res.JK, device=dev)
        plain.submit(probe); plain.flush()
        _, p_scores, p_items = plain.take_results()[0]
        err = assert_topn_close(probe_out[1], probe_out[2], p_scores,
                                p_items)
        check = dict(walk_vs_plain=dict(users=int(probe.shape[0]),
                                        max_abs_err=err))
        print(f"kernel walk vs its plain versions on the probe flush: top-"
              f"{scfg.topn} equal, scores within 1e-5 (max abs err "
              f"{err:.3g})")

    # ---- online ingestion: new users/items arrive (paper Alg. 4) ----
    st0 = online.OnlineState(params=res.params, S=res.S, JK=res.JK, sp=sp,
                             M=spec.M, N=spec.N, hash_key=res.hash_key)
    M2, N2 = spec.M + 100, spec.N + 20
    n_new = 2000
    nr = rng.integers(0, M2, n_new).astype(np.int32)
    nc = rng.integers(0, N2, n_new).astype(np.int32)
    pair = np.unique(nr.astype(np.int64) * N2 + nc)
    # ΔΩ must be disjoint from the already-observed pairs (from_coo wants
    # unique triples in the merged matrix)
    seen = (sp.rows.cpu().numpy().astype(np.int64) * N2
            + sp.cols.cpu().numpy())
    pair = np.setdiff1d(pair, seen, assume_unique=True)
    nr, nc = (pair // N2).astype(np.int32), (pair % N2).astype(np.int32)
    nv = rng.uniform(1, 5, nr.shape[0]).astype(np.float32)
    st1 = online.online_update(
        st0, nr, nc, nv, lsh, cfg.hp, prng.PRNGKey(7), M_new=M2, N_new=N2,
        K=cfg.K, epochs=2)
    svc.ingest_online_update(st1, N_old=spec.N)
    print(f"ingested ΔΩ: catalog {spec.N} → {svc.index.n_items} items "
          f"(tail occupancy {int(svc.index.tail_fill)}/{svc.index.tail_cap})")

    svc.submit(rng.integers(0, M2, 256).astype(np.int32))
    svc.flush()
    items = svc.take_results()[-1][2]
    new_hits = int(((items >= spec.N) & (items != SENTINEL)).sum())
    print(f"post-ingest serving OK; new items in recommendations: {new_hits}")
    _report(args, recall=float(overlap), rmse=res.history[-1][2],
            new_hits=new_hits, **check)
    return dict(recall=float(overlap), rmse=res.history[-1][2],
                new_hits=new_hits, fallbacks=svc.stats()["fallbacks"],
                **check)


def _disjoint_delta(st, M_new, N_new, rng, n=400):
    """ΔΩ triples disjoint from the already-observed pairs (the merge
    wants unique triples)."""
    nr = rng.integers(0, M_new, n).astype(np.int32)
    nc = rng.integers(0, N_new, n).astype(np.int32)
    pair = np.unique(nr.astype(np.int64) * N_new + nc)
    seen = (st.sp.rows.cpu().numpy().astype(np.int64) * N_new
            + st.sp.cols.cpu().numpy())
    pair = np.setdiff1d(pair, seen, assume_unique=True)
    return ((pair // N_new).astype(np.int32),
            (pair % N_new).astype(np.int32),
            rng.uniform(1, 5, pair.shape[0]).astype(np.float32))


def online_loop_main(args) -> dict:
    """The always-on loop: train once, then slice serve/train/publish
    forever-ish, crash-safe under ``args.root``.  The drift schedule is
    keyed on the loop's own slice counter, so a restart continues the
    same stream the interrupted run was on."""
    from repro_torch.loop import LoopConfig, OnlineLoop

    dev = resolve_device(args.device)
    spec = dataclasses.replace(syn.MOVIELENS_LIKE, M=args.M // 2,
                               N=args.N * 3 // 5, nnz=args.nnz * 2 // 5)
    rows, cols, vals, _ = syn.generate(spec, seed=0)
    tr, te = train_test_split(np.random.default_rng(0), rows, cols, vals)
    lsh = SimLSHConfig(G=8, p=1, q=10)
    cfg = FitConfig(F=32, K=8, epochs=3, method="simlsh", lsh=lsh,
                    eval_every=3, use_kernels=True)
    print(f"training the base model ({spec.M}×{spec.N}, "
          f"{len(tr[0]):,} ratings) …")
    res = fit(tr, te, (spec.M, spec.N), cfg, log=lambda *a, **k: None,
              device=dev)
    sp = from_coo(*tr, (spec.M, spec.N), device=dev)
    base = online.OnlineState(params=res.params, S=res.S, JK=res.JK, sp=sp,
                              M=spec.M, N=spec.N, hash_key=res.hash_key)
    scfg = ServeConfig(topn=10, micro_batch=128, C=128, n_seeds=8, cap=8,
                       n_popular=32)
    lcfg = LoopConfig(serve_flushes=2, micro_epochs=1, micro_batch=2048,
                      deltas_per_slice=2, max_lag=2, ckpt_every=2,
                      drift_every=4, tail_cap=128, seed=0)
    hold = tuple(np.asarray(a)[:500] for a in te)

    # resume if the root holds a previous run's checkpoint + WAL; the
    # deterministically re-trained `base` seeds a first run (or one
    # interrupted before its first checkpoint)
    loop = OnlineLoop.recover(args.root, lsh, cfg.hp, scfg, K=cfg.K,
                              epochs=2, batch=4096, cfg=lcfg,
                              base_state=base, holdout=hold, device=dev)
    resumed = loop.slice_count
    if resumed:
        print(f"resumed from {args.root}: slice {loop.slice_count}, "
              f"WAL seq {loop.updater.seq}, catalog {loop.state.N} items")
    else:
        print(f"fresh run (state under {args.root})")

    rng = np.random.default_rng(99)         # request traffic (not resumed)
    try:
        for _ in range(args.slices):
            s = loop.slice_count
            loop.svc.submit(rng.integers(0, spec.M, 128).astype(np.int32))
            if s % 2 == 0:                  # the stream grows the catalog
                drng = np.random.default_rng(1000 + s)   # keyed on slice
                M2, N2 = loop.state.M + 8, loop.state.N + 4
                nr, nc, nv = _disjoint_delta(loop.state, M2, N2, drng)
                loop.offer_delta(nr, nc, nv, prng.PRNGKey(70 + s),
                                 M_new=M2, N_new=N2)
            loop.run_slice()
            st = loop.svc.stats()
            print(f"slice {s}: {loop.state.M}×{loop.state.N} | "
                  f"{st['users']} users served | staleness "
                  f"{loop.staleness_s():.2f}s | "
                  f"publishes {int(loop.obs.counter('loop.publishes'))} | "
                  f"drift rmse "
                  f"{loop.obs.gauge('loop.drift_rmse', float('nan')):.3f}")
            res_batch = loop.svc.take_results()
            if res_batch:
                u, _, items = res_batch[-1][:3]
                print(f"  user {int(u[0])} → {items[0]}")
    except KeyboardInterrupt:
        print(f"\ninterrupted at slice {loop.slice_count} — run the same "
              f"command again to resume (checkpoint + WAL in {args.root})")
        return dict(slices=loop.slice_count, resumed=resumed)
    print(f"done: {args.slices} slices, catalog "
          f"{spec.N} → {loop.state.N} items; rerun to continue, or rm -r "
          f"{args.root} to start over")
    _report(args, slices=loop.slice_count, N=loop.state.N,
            publishes=int(loop.obs.counter("loop.publishes")))
    return dict(slices=loop.slice_count, resumed=resumed, N=loop.state.N,
                publishes=int(loop.obs.counter("loop.publishes")))


def cli(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--online-loop", action="store_true",
                    help="run the crash-safe always-on loop demo instead")
    ap.add_argument("--root", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_online_loop"),
                    help="persistence root for the loop's checkpoint + WAL")
    ap.add_argument("--slices", type=int, default=10,
                    help="slices to run this invocation (loop mode)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--M", type=int, default=3000)
    ap.add_argument("--N", type=int, default=500)
    ap.add_argument("--nnz", type=int, default=150_000)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--report", action="store_true",
                    help="print the kernels' launch counts as a JSON line")
    a = ap.parse_args(argv)
    return online_loop_main(a) if a.online_loop else main(a)


if __name__ == "__main__":
    cli()
