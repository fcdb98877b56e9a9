"""Time the port's deterministic scatter, `core/scatter.py::index_add_det_`
(the `segment_add` kernel), on one CUDA card, for the checkout at
``--root``: with its grouping made on each call, with a plan made once
and reused, and the library's atomic `index_add_` on the same inputs.
Each time is `chip_smoke.graph_ms` of that checkout (50 calls in one CUDA
graph, the median of 20 replays).

Three shapes, made from ``--seed``, like `chip_smoke.py` phase 16's:
  * online: 4,096 column ids into V [30,150, 128] (a Zipf draw, a few
    popular items repeating hundreds of times);
  * fit leftover: 512 column ids into a [30,000, 257] col plane (the
    packed CULSH-MF plane's F + 2K + 1 floats, row stride 257);
  * hot id: 4,096 copies of one id into V.

Every scatter is first checked bit for bit against the CPU's
`index_add_`.  Each shape is also timed eagerly, as a host-paced loop
calls it: 2,000 calls back to back, one synchronize at the end, µs a call
(host work included: the grouping's or the sort's launches, the plan's
allocations, the ctypes calls).

``--leftovers`` also times phase 10's leftover part of a fit epoch, the
way `chip_smoke.py` does: phase 8's ratings (`chip_smoke.fit_data`, kept
in ``--data`` so that every checkout reads the same ones), its schedule,
and the leftover batches through `sgd._cf_scan`'s packed steps, CULSH-MF
and plain MF, a warm-up and then ``--reps`` timed runs of each, on
parameters from `model.init_from_data`.

Prints one JSON line.  To compare two commits on one card, run it in one
call against both checkouts, in the order parent, change, change, parent:

    python tools/time_segment_add.py --root <checkout> --label <name> \
        [--leftovers --data <file.npz>]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import types


def shapes(np, seed: int):
    rng = np.random.default_rng(seed)
    yield "online", (30150, 128), (rng.zipf(1.3, 4096) - 1) % 30150
    yield "fit leftover", (30000, 257), (rng.zipf(1.3, 512) - 1) % 30000
    yield "hot id", (30150, 128), np.full(4096, 77)


def eager_us(fn, torch, calls: int = 2000) -> float:
    """µs a call of ``fn`` called back to back, synchronized once."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def leftover_part(np, torch, dev, seed: int, data: str, reps: int) -> dict:
    """Seconds of phase 10's leftover part (CULSH-MF as "kernel", plain
    MF), each run on fresh packed planes; as `chip_smoke.fit_phases`."""
    import chip_smoke as cs
    from repro_torch import prng
    from repro_torch.core import model, sgd, simlsh, topk
    from repro_torch.data.sparse import conflict_free_schedule, from_coo
    from repro_torch.train.trainer import FitConfig

    if os.path.exists(data):
        with np.load(data) as z:
            tr = (z["rows"], z["cols"], z["vals"])
    else:
        tr = cs.fit_data(types.SimpleNamespace(fit_scale=1.0, seed=seed))[0]
        np.savez(data, rows=tr[0], cols=tr[1], vals=tr[2])
    M, N, F, K = cs.FIT_M, cs.FIT_N, cs.FIT_F, cs.FIT_K
    cfg = FitConfig(F=F, K=K, epochs=cs.FIT_EPOCHS, method="simlsh",
                    lsh=simlsh.SimLSHConfig(G=8, p=1, q=10, band_cap=16),
                    seed=seed, use_kernels=True, shards=1)
    k_nb, k_init, _ = prng.split(prng.PRNGKey(cfg.seed), 3)
    k_sig, k_top = prng.split(k_nb)
    sp = from_coo(*tr, (M, N), device=dev)
    JK = topk.topk_from_signatures(simlsh.encode(sp, cfg.lsh, k_sig), k_top,
                                   K=K, band_cap=cfg.lsh.band_cap)
    sched = conflict_free_schedule(
        sp.rows.cpu().numpy(), sp.cols.cpu().numpy(), batch=cfg.cf_batch,
        tiers=cfg.tiers, tier_shrink=cfg.tier_shrink,
        min_fill_frac=cfg.min_fill_frac, shards=1, M=M, N=N, seed=cfg.seed)
    params = model.init_from_data(k_init, sp, F, K)
    on_dev = lambda a: torch.as_tensor(a, device=dev)
    decay = sgd.lr_decay(cfg.hp, cfg.epochs, dev)
    out = dict(batches=len(sched.lo_starts))
    for name, mf_only in (("kernel", False), ("plain-MF", True)):
        sd = model.build_scheduled_data(sp, JK, sched, mf_only=mf_only)
        secs = []
        for _ in range(reps + 1):
            state = model.pack_params(params)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sgd._cf_scan(state, sd, sched.lo_starts,
                         on_dev(sched.lo_valid).float(), cfg.hp, decay, None,
                         width=sched.widths[0], mf_only=mf_only, bce=False,
                         conflict_free=False, use_kernels=False,
                         scales=(on_dev(sched.lo_scale_i),
                                 on_dev(sched.lo_scale_j)))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        out[name] = secs[1:]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".", help="the checkout to time")
    ap.add_argument("--label", default="", help="a name for the output")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--leftovers", action="store_true",
                    help="also time phase 10's leftover part")
    ap.add_argument("--data", default="fit_data.npz",
                    help="phase 8's ratings, written on first use")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path[:0] = [os.path.join(root, "src"), root]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("time_segment_add: needs a CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import graph_ms
    from repro_torch.core import scatter
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    out = dict(label=args.label, root=root, card=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], shapes={})
    for name, (rows, width), ids in shapes(np, args.seed):
        idx = torch.as_tensor(ids, device=dev).long()
        V = torch.randn((rows, width), generator=gen, device=dev)
        src = 1e-3 * torch.randn((idx.numel(), width), generator=gen,
                                 device=dev)
        want = V.cpu().index_add_(0, idx.cpu(), src.cpu())
        if not torch.equal(scatter.index_add_det_(V.clone(), idx, src).cpu(),
                           want):
            raise AssertionError(f"{name}: not the CPU's index_add_")
        plan = scatter.segment_plan(idx)
        Vk, Vp = V.clone(), V.clone()
        out["shapes"][name] = dict(
            n=idx.numel(), distinct=int(torch.unique(idx).numel()),
            longest=int(torch.bincount(idx).max()), width=width,
            grouped_ms=graph_ms(lambda: scatter.index_add_det_(Vk, idx, src),
                                dev),
            plan_ms=graph_ms(lambda: scatter.index_add_det_(
                Vk, idx, src, plan=plan), dev),
            index_add_ms=graph_ms(lambda: Vp.index_add_(0, idx, src), dev),
            eager_grouped_us=eager_us(
                lambda: scatter.index_add_det_(Vk, idx, src), torch),
            eager_plan_us=eager_us(lambda: scatter.index_add_det_(
                Vk, idx, src, plan=plan), torch),
            eager_index_add_us=eager_us(lambda: Vp.index_add_(0, idx, src),
                                        torch))
    if args.leftovers:
        out["leftovers"] = leftover_part(np, torch, dev, args.seed,
                                         os.path.abspath(args.data),
                                         args.reps)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
