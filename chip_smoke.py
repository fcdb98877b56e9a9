#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main paths — serving, the offline
fit, the simLSH encoder, the legacy fit with checkpoints and batch
scoring — on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device — the card's name and power limit (nvidia-smi), CUDA version;
2. build — the six hand-written kernels from ``src/repro_torch/csrc``;
3. catalog and state — a planted catalog at the repo's million-item
   serving scale (N = 1,000,000 items, M = 640,000 users, F = 48,
   24,000,000 ratings; the recipe of `benchmarks/bench_serve.py::
   make_catalog`), simLSH signatures with the 18-bit N ≥ 10⁶ settings
   (G=9, p=2, q=10) and the bucketed LSH index, all on the card;
4. kernel vs plain — each kernel against its plain PyTorch version on the
   card, at the shapes of a real 256-user flush, plus edge cases (all
   masked rows, a batch that is not a multiple of ``tile_b``, a non-empty
   index tail);
5. serve — `RecsysService` warmup + 64 micro-batches of 256 users, with
   the kernels' launch counters zeroed just before and read just after;
   then 16 more flushes under `torch.profiler` for the device's busy
   share and its time by kernel (that window's host wall includes the
   profiler's own overhead);
6. recall@10 against exact scoring (`full_topn`) on 1,024 probe users;
7. timing — each kernel and its plain version at the phase-5 shapes
   (median of 30 CUDA-event-timed calls, each after an L2-evicting
   scrub), beside the least time the card could take (bytes over
   3.35 TB/s, operations over 67 TFLOP/s);
8. fit set-up — the repo's ~100M-parameter LSH-MF model
   (`examples/train_lshmf_100m.py`: M = 700,000 users, N = 30,000 items,
   F = 128, K = 64) on `synthetic.MOVIELENS_LIKE` data reshaped to those
   M, N and 2,000,000 ratings (10 % held out), with each stage of `fit`
   timed on the card (encode, Top-K, the host scheduler, the
   schedule-ordered data, the eval cache), its resident MB, the
   schedule's statistics, and the signature bits that differ between two
   encodes;
9. kernel vs plain — both fused SGD steps against their plain versions
   on tiles gathered from that state (B = 512, 7, 250, a tier's last
   partial batch, all rows invalid, BCE both ways), and padding slots that
   repeat live ids adding nothing to the planes;
10. fit — `fit(use_kernels=True)` for 3 epochs with the `culsh_sgd_step`
    counter zeroed just before (it must equal the conflict-free steps x
    epochs), the same fit on the plain steps (final RMSE within 1e-3),
    one epoch of plain MF (``method="none"``) through `mf_sgd_step`, then
    one more epoch of each under `torch.profiler`;
11. timing — both fused steps and their plain versions at B = 512: the
    device time per call in a CUDA graph of 50 calls (median of 20
    replays, so the host's time per call does not enter it), beside
    phase 7's cold-L2 reading, the host-paced back-to-back rate and the
    bound;
12. encode — `encode_band` through the `simlsh_encode` kernel for each
    of the q = 10 bands of the phase-3 catalog (deg = 24, every item's
    exact degree, so nothing is truncated), the counter zeroed just
    before; each band against its plain version (rtol/atol 1e-5) and
    against `band_accumulate` (rtol 1e-4 / atol 1e-3), and the signature
    bits that differ from phase 3's; one band timed in CUDA graphs (the
    kernel, its plain version and `torch.bmm` as the library yardstick)
    beside the bound;
13. legacy fit + checkpoints — `fit(schedule="none")` for 3 epochs on
    phase 8's data at full width, checkpointing every epoch (the RMSE
    must fall every epoch); in a fresh directory a 2-epoch fit, then a
    3-epoch fit that must resume at step 2 and end within 1e-3 of the
    uninterrupted RMSE; the checkpoint's size and save seconds;
14. scoring — `predict_batch` through the `neighbor_predict` kernel over
    phase 10's 200,000 test ratings in `model.rmse`'s 8,192-wide batches,
    the counter zeroed just before: within 1e-4 of `model.predict` and
    of the plain version, and the kernel-scored RMSE within 1e-4 of the
    fit's last `rmse_cached`; the kernel and its plain version timed at
    B = 8,192 in CUDA graphs beside the bound.

The second-last line is a JSON object listing the kernels; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA card the script
exits non-zero before printing any result.  ``--device cpu --n-items
20000 --fit-scale 0.01`` rehearses phases 3–14 on the CPU with the plain
versions and then exits 3, also without a result; on the card both
sizes must keep their defaults, so a result always comes from the full
configurations.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM float32 rate outside tensor cores
BATCHES = 64                # phase 5 micro-batches
PROFILED = 16               # flushes under the profiler
PROBE = 1024                # phase 6 probe users
N_ITEMS = 1_000_000         # the serving catalog (phases 3–7)
# the fit: the repo's ~100M-parameter LSH-MF model
# (`examples/train_lshmf_100m.py`), 3 epochs
FIT_M, FIT_N, FIT_NNZ, FIT_F, FIT_K, FIT_EPOCHS = (700_000, 30_000, 2_000_000,
                                                   128, 64, 3)
SGD_TOL = dict(rtol=1e-5, atol=1e-6)  # the JAX package's (tests/test_kernels.py)


def make_catalog(N: int, device, *, seed: int = 0, F: int = 48,
                 items_per_group: int = 50, users_per_group: int = 32,
                 deg: int = 24, group_scale: float = 1.6,
                 noise: float = 0.12, bias_std: float = 0.15):
    """Planted-group catalog, the recipe and random draws of
    `benchmarks/bench_serve.py::make_catalog`; the rating dot products
    are taken on ``device`` (a [nnz, F] gather).  → (U, V, bh numpy;
    rows, cols, vals tensors on ``device``; M)."""
    rng = np.random.default_rng(seed)
    G = max(1, N // items_per_group)
    M = G * users_per_group
    g_item = (np.arange(N) // items_per_group) % G
    g_user = np.arange(M) // users_per_group
    gdir = rng.normal(0, 1, (G, F))
    gdir /= np.linalg.norm(gdir, axis=1, keepdims=True)
    gdir *= group_scale
    U = (gdir[g_user] + noise * rng.normal(0, 1, (M, F))).astype(np.float32)
    V = (gdir[g_item] + noise * rng.normal(0, 1, (N, F))).astype(np.float32)
    bh = (bias_std * rng.normal(0, 1, N)).astype(np.float32)
    pick = np.argsort(rng.random((N, users_per_group)), axis=1)
    raters = pick[:, :deg] + g_item[:, None] * users_per_group
    rows = torch.from_numpy(raters.reshape(-1).astype(np.int32)).to(device)
    cols = torch.arange(N, dtype=torch.int32,
                        device=device).repeat_interleave(deg)
    Ut, Vt = torch.from_numpy(U).to(device), torch.from_numpy(V).to(device)
    dots = (Ut[rows.long()] * Vt[cols.long()]).sum(1)
    vals = torch.clamp(3.0 + 1.5 * dots, 1.0, 5.0)
    return U, V, bh, rows, cols, vals, M


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, device, iters: int = 30, warmup: int = 3) -> float:
    """Median time of ``fn`` with a cold L2, as a serving flush finds it.

    On the card each call sits between two CUDA events behind a 256 MB
    scrub write: the scrub evicts the 50 MB L2 and keeps the device busy
    for ~0.1 ms while the host enqueues the call, so a slow host adds no
    idle gap to the reading; everything is synchronized once at the end.
    On the CPU (rehearsal only) it is the host clock."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))
    scrub = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    marks = []
    for _ in range(iters):
        scrub.fill_(1)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        marks.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in marks]))


def graph_ms(fn, device, n: int = 50, reps: int = 20) -> float:
    """Device time per call of ``fn``: ``n`` calls captured in one CUDA
    graph, replayed ``reps`` times between two CUDA events (warm L2, as
    the epoch loop finds freshly gathered tiles); the median per call.
    The host launches each replay as one call, so its speed does not
    enter the reading.  Host clock on the CPU (rehearsal only)."""
    if device.type != "cuda":
        return back_to_back_ms(fn, device, n)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):      # warm up off the capture stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    marks = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        marks.append((a, b))
    torch.cuda.synchronize()
    out = float(np.median([a.elapsed_time(b) / n for a, b in marks]))
    del graph
    return out


def back_to_back_ms(fn, device, n: int = 200) -> float:
    """Time per call of ``n`` calls issued back to back (warm L2): the
    rate a loop of launches sustains, which the host's time per call sets
    when it exceeds the device's.  Host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def device_activity(prof):
    """(activities, busy µs, {name: µs}) of a profile's device events; busy
    is the union of their intervals."""
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start)
    busy, end = 0.0, -np.inf
    for a, b in sorted(spans):          # union of the device intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    return spans, busy, by_name


def profile_flushes(svc, batches) -> None:
    """Serve ``batches`` under `torch.profiler`; print the device's busy
    share of the window and its time by kernel name."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for users in batches:
            svc.submit(users)
        svc.flush()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, busy, by_name = device_activity(prof)
    svc.take_results()
    print(f"[5 profile] {len(batches)} flushes: host wall {wall_us:.0f} us, "
          f"device busy {busy:.0f} us ({busy / wall_us:.3f} of the wall), "
          f"{len(spans)} device activities", flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"[5 profile]   {us / len(batches):9.2f} us/flush  "
              f"{name[:90]}", flush=True)


def megabytes(*ts) -> float:
    return sum(t.numel() * t.element_size() for t in ts) / 1e6


def check_sgd(got, want, valid, inputs) -> float:
    """Hold a fused step's outputs against its plain version's (rtol 1e-5,
    atol 1e-6) and its invalid rows against ``inputs`` (bit for bit);
    → the largest absolute error."""
    err = 0.0
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **SGD_TOL)
        err = max(err, float((g - w).abs().max()))
    off = valid == 0
    for g, x in zip(got, inputs):
        if not torch.equal(g[off], x[off]):
            raise AssertionError("an invalid row of a fused step changed")
    return err


def fit_phases(args, dev, on_card: bool, power: str) -> list:
    """Phases 8–11: the offline CULSH-MF fit (`train.trainer.fit`) at the
    width of the repo's ~100M-parameter model; → (the two fused steps'
    entries of the kernels line, the state phases 13–14 go on from)."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import prng
    from repro_torch.core import model, sgd, simlsh, topk
    from repro_torch.data import synthetic
    from repro_torch.data.sparse import (conflict_free_schedule, from_coo,
                                         train_test_split)
    from repro_torch.kernels.mf_sgd import kernel as sgd_kernel
    from repro_torch.kernels.mf_sgd.ops import (apply_culsh_sgd, culsh_hyper,
                                                mf_hyper)
    from repro_torch.kernels.mf_sgd.ref import (culsh_sgd_step_ref,
                                                mf_sgd_step_ref)
    from repro_torch.train.trainer import FitConfig, fit

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    secs = {}

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        sync()
        secs[name] = time.perf_counter() - t0
        return out

    # ---- 8. fit set-up: the stages `fit` runs, each timed ----
    M = max(1, int(FIT_M * args.fit_scale))
    N = max(1, int(FIT_N * args.fit_scale))
    nnz = int(FIT_NNZ * args.fit_scale)
    F, K = FIT_F, FIT_K
    cfg = FitConfig(F=F, K=K, epochs=FIT_EPOCHS, method="simlsh",
                    lsh=simlsh.SimLSHConfig(G=8, p=1, q=10, band_cap=16),
                    seed=args.seed, use_kernels=True)
    spec = dataclasses.replace(synthetic.MOVIELENS_LIKE, M=M, N=N, nnz=nnz)

    def data():
        rows, cols, vals, _ = synthetic.generate(spec, seed=args.seed)
        return train_test_split(np.random.default_rng(args.seed), rows,
                                cols, vals)

    tr, te = stage("data", data)
    k_nb, k_init, k_ep = prng.split(prng.PRNGKey(cfg.seed), 3)  # as `fit`
    k_sig, k_top = prng.split(k_nb)
    sp = stage("from_coo", lambda: from_coo(*tr, (M, N), device=dev))
    sigs = stage("encode", lambda: simlsh.encode(sp, cfg.lsh, k_sig))
    flips = simlsh.encode(sp, cfg.lsh, k_sig) ^ sigs
    flipped = int(sum(((flips >> b) & 1).sum()
                      for b in range(cfg.lsh.sig_bits)))
    JK = stage("topk_from_signatures", lambda: topk.topk_from_signatures(
        sigs, k_top, K=K, band_cap=cfg.lsh.band_cap))
    sched = stage("conflict_free_schedule (host)",
                  lambda: conflict_free_schedule(
                      sp.rows.cpu().numpy(), sp.cols.cpu().numpy(),
                      batch=cfg.cf_batch, tiers=cfg.tiers,
                      tier_shrink=cfg.tier_shrink,
                      min_fill_frac=cfg.min_fill_frac, shards=1, M=M, N=N,
                      seed=cfg.seed))
    sd = stage("build_scheduled_data",
               lambda: model.build_scheduled_data(sp, JK, sched))
    te_r, te_c, te_v = (torch.as_tensor(a, device=dev) for a in te)
    ec = stage("build_eval_cache",
               lambda: model.build_eval_cache(sp, JK, te_r, te_c))
    pp = model.pack_params(model.init_from_data(k_init, sp, F, K))
    fields = lambda x: [getattr(x, f.name) for f in dataclasses.fields(x)]
    resident = dict(ratings=megabytes(sp.rows, sp.cols, sp.vals),
                    row_plane=megabytes(pp.row), col_plane=megabytes(pp.col),
                    scheduled_data=megabytes(*fields(sd)),
                    eval_cache=megabytes(*fields(ec)), JK=megabytes(JK))
    st = sched.stats()
    print(f"[8 setup] M={M} N={N} F={F} K={K}: {sp.nnz} train + "
          f"{te_v.numel()} test ratings; seconds: "
          + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()), flush=True)
    print(f"[8 setup] resident MB: "
          + ", ".join(f"{k} {v:.1f}" for k, v in resident.items())
          + f"; total {sum(resident.values()):.1f}", flush=True)
    print(f"[8 setup] schedule: cf_frac {st['cf_frac']:.4f}, {st['nb_cf']} "
          f"conflict-free steps + {st['nb_lo']} leftover batches; "
          + "; ".join(f"width {t['width']}: {t['rounds']} steps, fill "
                      f"{t['fill']:.3f}" for t in st["tiers"]), flush=True)
    print(f"[8 setup] encode run twice: {flipped} of "
          f"{sigs.numel() * cfg.lsh.sig_bits} signature bits differ",
          flush=True)

    # ---- 9. kernel vs plain, on tiles gathered from the fit's state ----
    decay = sgd.lr_decay(cfg.hp, 0, dev)
    hpv = culsh_hyper(cfg.hp, decay, pp.mu)
    hmf = mf_hyper(cfg.hp, decay, dev)

    def window(t, k):
        return model.slice_batch(sd, int(sched.tier_starts[t][k]),
                                 sched.widths[t], torch.as_tensor(
                                     sched.tier_valid[t][k], device=dev).float())

    def tiles(bt):
        return [pp.row[bt.i.long()], pp.col[bt.j.long()], bt.rnb,
                pp.bh[bt.nb.long()], bt.expl, bt.r, bt.valid, hpv]

    bt = window(0, 0)
    W0 = sched.widths[0]
    base = tiles(bt)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    wc = list(base)                     # W and C as a trained state has them
    wc[1] = base[1].clone()
    wc[1][:, F:F + 2 * K] = 0.1 * torch.randn((W0, 2 * K), generator=gen,
                                              device=dev)
    cut = lambda a, n: [t[:n].contiguous() for t in a[:7]] + [a[7]]
    off = list(base)
    off[6] = torch.zeros_like(base[6])
    last_t = max(t for t, s in enumerate(sched.tier_starts) if len(s))
    padded_real = tiles(window(last_t, -1))   # a tier's last, partial batch
    culsh_cases = {f"B={W0}": base, f"B={W0} random W,C": wc,
                   "B=7": cut(wc, 7), "B=250": cut(wc, 250),
                   "all invalid": off,
                   f"last batch of width {sched.widths[last_t]} "
                   f"({int(padded_real[6].sum())} valid)": padded_real}
    culsh_err = 0.0
    for a in culsh_cases.values():
        for bce in (False, True):
            culsh_err = max(culsh_err, check_sgd(
                sgd_kernel.culsh_sgd_step(*a, bce=bce),
                culsh_sgd_step_ref(*a, bce=bce), a[6], a[:2]))
    mfa = lambda a: [a[0][:, :F].contiguous(), a[1][:, :F].contiguous(),
                     a[5], a[6], hmf]
    mf_err = 0.0
    for a in culsh_cases.values():
        for bce in (False, True):
            m = mfa(a)
            mf_err = max(mf_err, check_sgd(
                sgd_kernel.mf_sgd_step(*m, bce=bce),
                mf_sgd_step_ref(*m, bce=bce), m[3], m[:2]))
    # padding slots that repeat live ids add exactly nothing to the planes
    q = W0 // 4
    i2, j2, v2 = bt.i.clone(), bt.j.clone(), bt.valid.clone()
    i2[-q:], j2[-q:], v2[-q:] = bt.i[:q], bt.j[:q], 0.0
    with_pad = dataclasses.replace(bt, i=i2, j=j2, valid=v2)
    live = model.Batch(*(getattr(with_pad, f.name)[:W0 - q]
                         for f in dataclasses.fields(bt)))
    planes = [dataclasses.replace(pp, row=pp.row.clone(), col=pp.col.clone())
              for _ in range(2)]
    apply_culsh_sgd(planes[0], with_pad, hpv)
    apply_culsh_sgd(planes[1], live, hpv)
    if not (torch.equal(planes[0].row, planes[1].row)
            and torch.equal(planes[0].col, planes[1].col)):
        raise AssertionError("padding slots that repeat live ids changed "
                             "the planes")
    del planes
    print(f"[9 check] culsh_sgd_step within rtol 1e-5 / atol 1e-6 (max abs "
          f"err {culsh_err:.3g}) and mf_sgd_step (max abs err "
          f"{mf_err:.3g}), BCE both ways, invalid rows bit for bit "
          f"unchanged, on: " + ", ".join(culsh_cases) + f"; {q} padding "
          f"slots repeating live i/j add nothing to the planes", flush=True)

    # ---- 10. fit: the main path, counters zeroed just before each run ----
    log = lambda tag: (lambda s: print(f"[10 fit {tag}] {s}", flush=True))
    sgd_kernel.CULSH_LAUNCHES = 0
    res = fit(tr, te, (M, N), cfg, log=log("kernels"), device=dev)
    culsh_launches = sgd_kernel.CULSH_LAUNCHES
    nb_cf = res.schedule_stats["nb_cf"]
    rm = [h[2] for h in res.history]
    ep_secs = np.diff([0.0] + [h[1] for h in res.history])
    reg = res.registry
    for (ep, _, r), s in zip(res.history, ep_secs):
        print(f"[10 fit] epoch {ep}: {s:.3f} s, {sp.nnz / s:.0f} updates/s, "
              f"rmse {r:.6f}", flush=True)
    print(f"[10 fit] fit spans (s): " + ", ".join(
        f"{n} {reg.span_durations(n)[-1]:.3f}" for n in (
            "train.neighbours", "train.prep.schedule", "train.prep.pack",
            "train.prep.eval_cache")) + f"; culsh_sgd_step launches "
          f"{culsh_launches} = {nb_cf} conflict-free steps x {cfg.epochs} "
          f"epochs", flush=True)
    if not (np.isfinite(rm).all() and rm[-1] < rm[0]):
        raise AssertionError(f"the fit did not train: rmse {rm}")
    if on_card and culsh_launches != nb_cf * cfg.epochs:
        raise AssertionError(f"culsh_sgd_step launched {culsh_launches} "
                             f"times, expected {nb_cf * cfg.epochs}")
    if on_card and not torch.equal(res.JK, JK):
        print("[10 fit] J^K differs from phase 8's (signature bits flipped "
              "between encodes)", flush=True)
    plain = fit(tr, te, (M, N), dataclasses.replace(cfg, use_kernels=False),
                log=log("plain"), device=dev)
    rp = [h[2] for h in plain.history]
    print(f"[10 fit] rmse with kernels {rm}; plain steps {rp}; final "
          f"difference {abs(rm[-1] - rp[-1]):.3g} (limit 1e-3)", flush=True)
    if not abs(rm[-1] - rp[-1]) <= 1e-3:
        raise AssertionError("the kernel fit's RMSE is off the plain fit's")
    sgd_kernel.MF_LAUNCHES = 0
    mf = fit(tr, te, (M, N), dataclasses.replace(cfg, method="none",
                                                  epochs=1),
             log=log("mf"), device=dev)
    mf_launches = sgd_kernel.MF_LAUNCHES
    print(f"[10 fit] method='none': mf_sgd_step launches {mf_launches} = "
          f"{mf.schedule_stats['nb_cf']} conflict-free steps", flush=True)
    if not np.isfinite(mf.history[-1][2]):
        raise AssertionError("the plain MF fit diverged")
    if on_card and mf_launches != mf.schedule_stats["nb_cf"]:
        raise AssertionError(f"mf_sgd_step launched {mf_launches} times")
    in_loop = {}
    if on_card:   # one more epoch of each engine under the profiler
        sd_mf = model.build_scheduled_data(sp, JK, sched, mf_only=True)
        for name, state, data_, mf_only in (
                ("culsh_sgd", model.pack_params(res.params), sd, False),
                ("mf_sgd", model.pack_params(mf.params), sd_mf, True)):
            sync()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                sgd.train_epoch_scheduled(
                    state, data_, sched, prng.fold_in(k_ep, cfg.epochs),
                    cfg.epochs, cfg.hp, mf_only=mf_only, use_kernels=True)
                sync()
                wall_us = (time.perf_counter() - t0) * 1e6
            spans, busy, by_name = device_activity(prof)
            mine = [us for n, us in by_name.items() if f"{name}_kernel" in n]
            in_loop[name] = sum(mine) / 1e3 / max(nb_cf, 1)
            print(f"[10 profile] one {name} epoch: host wall {wall_us:.0f} "
                  f"us, device busy {busy:.0f} us ({busy / wall_us:.3f} of "
                  f"the wall), {len(spans)} device activities, "
                  f"{in_loop[name]:.5f} ms per kernel launch", flush=True)
            for n, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
                print(f"[10 profile]   {us / 1e3:9.2f} ms  {n[:90]}",
                      flush=True)
        # the profiles hold ~10⁵ Python objects; free them so no collector
        # pause lands in phase 11's timed host gaps
        del prof, spans
        gc.collect()

    # ---- 11. time each fused step and its plain version at B = W0 ----
    # `ms` and `plain_ms` are device times from CUDA graphs; the cold-L2
    # event reading and the back-to-back rate are printed beside them
    m = mfa(base)
    steps = dict(culsh_sgd=(lambda: sgd_kernel.culsh_sgd_step(*base),
                            lambda: culsh_sgd_step_ref(*base)),
                 mf_sgd=(lambda: sgd_kernel.mf_sgd_step(*m),
                         lambda: mf_sgd_step_ref(*m)))
    timed = {name: dict(ms=graph_ms(kern, dev), plain=graph_ms(pl, dev),
                        cold=median_ms(kern, dev),
                        b2b=back_to_back_ms(kern, dev))
             for name, (kern, pl) in steps.items()}
    # bytes: every tile read once and both outputs written once;
    # operations: the forward and the update of one sample (14 per factor,
    # 30 per neighbour slot, ~30 scalar) for each of the B samples
    culsh_bound, culsh_by = bound_ms(
        4 * (2 * W0 * (F + 1) + 2 * W0 * (F + 2 * K + 1) + 3 * W0 * K
             + 2 * W0 + 13), W0 * (14 * F + 30 * K + 30))
    mf_bound, mf_by = bound_ms(4 * (4 * W0 * F + 3 * W0 + 4),
                               W0 * (14 * F + 10))
    bounds = dict(culsh_sgd=(culsh_bound, culsh_by),
                  mf_sgd=(mf_bound, mf_by))
    for name, t in timed.items():
        bnd, by = bounds[name]
        print(f"[11 time] {name}_step at B={W0} F={F} K={K}: kernel "
              f"{t['ms']:.5f} ms (CUDA graph of 50 calls, median of 20 "
              f"replays), {t['cold']:.4f} ms cold L2 behind the scrub, "
              f"{t['b2b']:.4f} ms per call back to back (host-paced), "
              f"{in_loop.get(name, float('nan')):.5f} ms per launch in the "
              f"profiled epoch; plain version {t['plain']:.5f} ms (CUDA "
              f"graph); bound {bnd:.5f} ms ({by}); no single PyTorch call "
              f"computes the fused step (power limit {power})", flush=True)
    entries = [
        dict(name="culsh_sgd_step", route="cuda",
             source="src/repro_torch/csrc/culsh_sgd.cu",
             replaces="src/repro/kernels/mf_sgd/kernel.py:126",
             launches=culsh_launches, max_abs_err=culsh_err,
             ms=timed["culsh_sgd"]["ms"], plain_ms=timed["culsh_sgd"]["plain"],
             bound_ms=culsh_bound, bound_by=culsh_by, library_ms=None),
        dict(name="mf_sgd_step", route="cuda",
             source="src/repro_torch/csrc/mf_sgd.cu",
             replaces="src/repro/kernels/mf_sgd/kernel.py:160",
             launches=mf_launches, max_abs_err=mf_err,
             ms=timed["mf_sgd"]["ms"], plain_ms=timed["mf_sgd"]["plain"],
             bound_ms=mf_bound, bound_by=mf_by, library_ms=None),
    ]
    return entries, dict(res=res, sp=sp, tr=tr, te=te, shape=(M, N), cfg=cfg)


def encode_phase(sp, lsh, key, sigs, dev, on_card: bool, power: str) -> dict:
    """Phase 12: `encode_band` through the `simlsh_encode` kernel for every
    band of the serving catalog; → the kernel's entry of the kernels
    line."""
    from repro_torch.core import simlsh
    from repro_torch.kernels.simlsh_encode import kernel as enc_kernel
    from repro_torch.kernels.simlsh_encode.ops import (band_operands,
                                                       encode_band)
    from repro_torch.kernels.simlsh_encode.ref import simlsh_encode_ref

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.perf_counter()
    degree = torch.bincount(sp.cols.long(), minlength=sp.N)
    deg = -(-int(degree.max()) // 8) * 8       # max degree, rounded up to 8
    truncated = int((degree > deg).sum())
    bits = lsh.sig_bits
    enc_kernel.LAUNCHES = 0                    # the main path
    t_enc = time.perf_counter()
    accs = [encode_band(sp, lsh, key, band, deg=deg)
            for band in range(lsh.q)]
    sync()
    t_enc = time.perf_counter() - t_enc
    launches = enc_kernel.LAUNCHES
    if on_card and launches != lsh.q:
        raise AssertionError(f"simlsh_encode launched {launches} times for "
                             f"{lsh.q} bands")
    if truncated:
        raise AssertionError(f"{truncated} items have more than {deg} raters")
    err, ba_err, flipped = 0.0, 0.0, 0
    for band, S in enumerate(accs):
        w, phi = band_operands(sp, lsh, key, band, deg=deg)
        plain = simlsh_encode_ref(w, phi)
        torch.testing.assert_close(S, plain, rtol=1e-5, atol=1e-5)
        err = max(err, float((S - plain).abs().max()))
        del w, phi, plain
        S_ba = simlsh.band_accumulate(
            sp.rows, sp.cols, sp.vals, key, band, N=sp.N, bits=bits,
            psi_pow=lsh.psi_pow, psi_mode=lsh.psi_mode,
            psi_center=lsh.psi_center)
        torch.testing.assert_close(S, S_ba, rtol=1e-4, atol=1e-3)
        ba_err = max(ba_err, float((S - S_ba).abs().max()))
        x = simlsh.pack_bits(S >= 0) ^ sigs[band]
        flipped += sum(int(((x >> b) & 1).sum()) for b in range(bits))
    print(f"[12 encode] N={sp.N} deg={deg} (max degree {int(degree.max())}, "
          f"0 items truncated) bits={bits} q={lsh.q}: {launches} "
          f"simlsh_encode launches, {t_enc:.3f} s for the {lsh.q} bands; "
          f"kernel vs plain within rtol/atol 1e-5 (max abs err {err:.3g}), "
          f"vs band_accumulate within rtol 1e-4 / atol 1e-3 (max abs err "
          f"{ba_err:.3g}); {flipped} of {sp.N * bits * lsh.q} signature bits "
          f"differ from phase 3's", flush=True)
    del accs
    # one band: the kernel, its plain version and one cuBLAS batched GEMV
    w, phi = band_operands(sp, lsh, key, 0, deg=deg)
    ms = graph_ms(lambda: enc_kernel.simlsh_encode(w, phi), dev, n=10,
                  reps=10)
    plain_ms = graph_ms(lambda: simlsh_encode_ref(w, phi), dev, n=10,
                        reps=10)
    lib_ms = graph_ms(lambda: torch.bmm(w[:, None, :], phi), dev, n=10,
                      reps=10)
    # bytes: ψ and Φ read once, S written once; operations: a multiply-add
    # per (item, slot, bit)
    N = sp.N
    bnd, by = bound_ms(4 * (N * deg + N * deg * bits + N * bits),
                       2 * N * deg * bits)
    del w, phi
    print(f"[12 time] simlsh_encode at N={N} deg={deg} bits={bits}: kernel "
          f"{ms:.4f} ms (CUDA graph of 10 calls, median of 10 replays), "
          f"plain version {plain_ms:.4f} ms, torch.bmm {lib_ms:.4f} ms, "
          f"bound {bnd:.4f} ms ({by}) (power limit {power})", flush=True)
    print(f"[12 encode] phase seconds {time.perf_counter() - t0:.1f}",
          flush=True)
    return dict(name="simlsh_encode", route="cuda",
                source="src/repro_torch/csrc/simlsh_encode.cu",
                replaces="src/repro/kernels/simlsh_encode/kernel.py:47",
                launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bnd, bound_by=by, library_ms=lib_ms)


def legacy_phase(ctx: dict, dev) -> None:
    """Phase 13: the legacy fit path (``schedule="none"``) at full width,
    with checkpoints every epoch and a resume from step 2.  The
    checkpoints go to a temporary directory under ``build/``, removed at
    the end."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.trainer import fit

    t0 = time.perf_counter()
    tr, te, shape = ctx["tr"], ctx["te"], ctx["shape"]
    base = dataclasses.replace(ctx["cfg"], schedule="none", use_kernels=False)
    log = lambda tag: (lambda s: print(f"[13 legacy {tag}] {s}", flush=True))
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke-ckpt-",
                           dir=os.path.join(ROOT, "build"))
    try:
        d = os.path.join(tmp, "whole")
        whole = fit(tr, te, shape, dataclasses.replace(
            base, epochs=3, ckpt_dir=d, ckpt_every=1), log=log("3 epochs"),
            device=dev)
        rm = [h[2] for h in whole.history]
        ep_secs = np.diff([0.0] + [h[1] for h in whole.history])
        saves = whole.registry.span_durations("train.ckpt")
        print(f"[13 legacy] schedule='none' at M={shape[0]} N={shape[1]} "
              f"F={base.F} K={base.K}, batch {base.batch}: seconds per epoch "
              + ", ".join(f"{x:.3f}" for x in ep_secs) + "; rmse "
              + ", ".join(f"{r:.6f}" for r in rm) + "; train.ckpt spans "
              "(host copy + writer start) " + ", ".join(
                  f"{x:.3f}" for x in saves) + " s", flush=True)
        if not (np.isfinite(rm).all() and (np.diff(rm) < 0).all()):
            raise AssertionError(f"the legacy fit's RMSE did not fall every "
                                 f"epoch: {rm}")
        if ckpt.latest_step(d) != 3:
            raise AssertionError(f"latest checkpoint {ckpt.latest_step(d)}")
        shard = os.path.join(d, "step-00000003", ckpt.SHARD)
        t_save = time.perf_counter()
        ckpt.save(os.path.join(tmp, "timed"), whole.params, step=3,
                  sync=True)
        t_save = time.perf_counter() - t_save
        print(f"[13 ckpt] {os.path.getsize(shard) / 1e6:.1f} MB per "
              f"checkpoint; one synchronous save {t_save:.3f} s", flush=True)
        d2 = os.path.join(tmp, "resume")
        fit(tr, te, shape, dataclasses.replace(
            base, epochs=2, ckpt_dir=d2, ckpt_every=1), log=log("2 epochs"),
            device=dev)
        resumed = fit(tr, te, shape, dataclasses.replace(
            base, epochs=3, ckpt_dir=d2), log=log("resumed"), device=dev)
        first = resumed.history[0][0]
        gap = abs(resumed.history[-1][2] - rm[-1])
        print(f"[13 ckpt] resumed fit restarted at step {first}, final rmse "
              f"{resumed.history[-1][2]:.6f} vs {rm[-1]:.6f} uninterrupted: "
              f"gap {gap:.3g} (limit 1e-3)", flush=True)
        if first != 2 or len(resumed.history) != 1:
            raise AssertionError(f"the resumed fit ran epochs "
                                 f"{[h[0] for h in resumed.history]}")
        if not gap <= 1e-3:
            raise AssertionError("the resumed fit's RMSE is off the "
                                 "uninterrupted one's")
    finally:
        ckpt.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[13 legacy] phase seconds {time.perf_counter() - t0:.1f}",
          flush=True)


def predict_phase(ctx: dict, dev, on_card: bool, power: str) -> dict:
    """Phase 14: `predict_batch` through the `neighbor_predict` kernel on
    the test ratings of phase 10's fit; → the kernel's entry of the
    kernels line."""
    from repro_torch.core import model
    from repro_torch.kernels.neighbor_predict import kernel as pred_kernel
    from repro_torch.kernels.neighbor_predict.ops import (predict_batch,
                                                          predict_operands)
    from repro_torch.kernels.neighbor_predict.ref import neighbor_predict_ref

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.perf_counter()
    res, sp = ctx["res"], ctx["sp"]
    p = res.params
    te_r, te_c, te_v = (torch.as_tensor(a, device=dev) for a in ctx["te"])
    batches = list(model.eval_batches(sp, res.JK, te_r, te_c, te_v))
    pred_kernel.LAUNCHES = 0                   # the main path
    preds = [predict_batch(p, bt) for bt in batches]
    sync()
    launches = pred_kernel.LAUNCHES
    if on_card and launches != len(batches):
        raise AssertionError(f"neighbor_predict launched {launches} times "
                             f"for {len(batches)} batches")
    err, model_err = 0.0, 0.0
    sse = torch.zeros((), dtype=torch.float64, device=dev)
    for bt, pr in zip(batches, preds):
        want = model.predict(p, bt)[0]
        torch.testing.assert_close(pr, want, rtol=1e-4, atol=1e-4)
        model_err = max(model_err, float((pr - want).abs().max()))
        plain = neighbor_predict_ref(*predict_operands(p, bt))
        torch.testing.assert_close(pr, plain, rtol=1e-4, atol=1e-4)
        err = max(err, float((pr - plain).abs().max()))
        sse += ((bt.r - pr).double() ** 2 * bt.valid).sum()
    n = int(te_v.numel())
    rmse_k = float(torch.sqrt(sse / n))
    gap = abs(rmse_k - res.history[-1][2])
    B = batches[0].i.shape[0]
    print(f"[14 score] {n} test ratings in {len(batches)} batches of {B}: "
          f"{launches} neighbor_predict launches; within 1e-4 of "
          f"model.predict (max abs err {model_err:.3g}) and of the plain "
          f"version ({err:.3g}); kernel-scored rmse {rmse_k:.6f} vs the "
          f"fit's last rmse_cached {res.history[-1][2]:.6f}: gap {gap:.3g} "
          f"(limit 1e-4)", flush=True)
    if not gap <= 1e-4:
        raise AssertionError("the kernel-scored RMSE is off the fit's")
    ops = predict_operands(p, batches[0])
    F, K = ops[0].shape[1], ops[2].shape[1]
    ms = graph_ms(lambda: pred_kernel.neighbor_predict(*ops), dev)
    plain_ms = graph_ms(lambda: neighbor_predict_ref(*ops), dev)
    # bytes: the nine operands read once, the predictions written once;
    # operations: two per factor and four per neighbour slot, four scalar
    bnd, by = bound_ms(4 * (2 * B * F + 4 * B * K + 4 * B),
                       B * (2 * F + 4 * K + 4))
    print(f"[14 time] neighbor_predict at B={B} F={F} K={K}: kernel "
          f"{ms:.5f} ms (CUDA graph of 50 calls, median of 20 replays), "
          f"plain version {plain_ms:.5f} ms, bound {bnd:.5f} ms ({by}); no "
          f"single PyTorch call computes three row-wise dots and their "
          f"affine sum, so no library yardstick (power limit {power})",
          flush=True)
    print(f"[14 score] phase seconds {time.perf_counter() - t0:.1f}",
          flush=True)
    return dict(name="neighbor_predict", route="cuda",
                source="src/repro_torch/csrc/neighbor_predict.cu",
                replaces="src/repro/kernels/neighbor_predict/kernel.py:52",
                launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bnd, bound_by=by, library_ms=None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the smoke run) or cpu (rehearsal, no result)")
    ap.add_argument("--n-items", type=int, default=N_ITEMS,
                    help="serving catalog size (rehearsal only)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fit-scale", type=float, default=1.0,
                    help="scale of the fit's M, N and nnz (rehearsal only)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — nothing was run", file=sys.stderr)
        return 2
    if on_card and (args.n_items != N_ITEMS or args.fit_scale != 1.0):
        print("chip_smoke: --n-items and --fit-scale are for the CPU "
              "rehearsal; the card runs the full configurations",
              file=sys.stderr)
        return 2

    from repro_torch import convert, prng
    from repro_torch.core import simlsh
    from repro_torch.core.topk import SENTINEL
    from repro_torch.data.sparse import from_coo
    from repro_torch.kernels import _build
    from repro_torch.kernels.candidate_score import kernel as score_kernel
    from repro_torch.kernels.candidate_score.ref import (
        assert_topn_close, candidate_score_topn_ref)
    from repro_torch.kernels.lsh_retrieve import kernel as lsh_kernel
    from repro_torch.kernels.lsh_retrieve.ref import lsh_retrieve_topc_ref
    from repro_torch.serve import (RecsysService, ServeConfig, build_index,
                                   full_topn, insert, seed_items, tail_hits,
                                   window_slices)

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 (the default)
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. device, 2. build ----
    if on_card:
        smi = nvidia_smi()
        print(f"[1 device] {smi}", flush=True)
        print(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda} "
              f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
              flush=True)
        t0 = time.perf_counter()
        _build.library()
        print(f"[2 build] kernels built and loaded in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        for line in _build.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[2 build] {line.strip()}", flush=True)

    # ---- 3. catalog and state ----
    t0 = time.perf_counter()
    N = args.n_items
    U, V, bh, rows, cols, vals, M = make_catalog(N, dev, seed=args.seed)
    z = np.zeros((N, 1), np.float32)
    params = convert.params_from_numpy(U, V, np.zeros(M, np.float32), bh, z,
                                       z, 3.0, device=dev)
    sp = from_coo(rows, cols, vals, (M, N), device=dev)
    del rows, cols, vals
    lsh = simlsh.SimLSHConfig(G=9, p=2, q=10, band_cap=16)
    sigs = simlsh.encode(sp, lsh, prng.PRNGKey(args.seed, device=dev))
    index = build_index(sigs, tail_cap=128, device=dev)
    cfg = ServeConfig(topn=10, micro_batch=256, C=768, n_seeds=16, cap=8,
                      n_popular=64, tile_b=16, band_budget=768)
    svc = RecsysService(params, index, sp, cfg, device=dev)
    if on_card:
        torch.cuda.synchronize()
    mb = megabytes
    idx_t = [getattr(index, f) for f in ("sorted_sigs", "sorted_ids",
                                         "bucket_lo", "bucket_hi", "slot_of")]
    print(f"[3 state] N={N} M={M} nnz={sp.nnz} F={svc.planes.F} in "
          f"{time.perf_counter() - t0:.1f} s; col plane "
          f"{mb(svc.planes.col):.0f} MB, row plane {mb(svc.planes.row):.0f} "
          f"MB, index {mb(*idx_t):.0f} MB, ratings "
          f"{mb(sp.rows, sp.cols, sp.vals):.0f} MB", flush=True)

    # ---- 4. kernel vs plain, at the shapes of a real flush ----
    rng = np.random.default_rng(args.seed + 1)
    B = cfg.micro_batch
    users = torch.from_numpy(rng.integers(0, M, B).astype(np.int32)).to(dev)
    seeds = seed_items(sp, users, n_seeds=cfg.n_seeds, window=cfg.seed_window)
    starts, lens = window_slices(index, seeds, cap=cfg.cap)
    no_tail = torch.full((B, 1), SENTINEL, dtype=torch.int32, device=dev)
    popular = svc.popular
    core_C = cfg.C - popular.shape[0]
    lsh_args = (starts, lens, no_tail, svc._flat_ids(), popular)
    got = lsh_kernel.lsh_retrieve_topc(*lsh_args, C=core_C, cap=cfg.cap)
    if not torch.equal(got, lsh_retrieve_topc_ref(*lsh_args, C=core_C,
                                                  cap=cfg.cap)):
        raise AssertionError("lsh_retrieve differs from its plain version")
    filled = float((got != SENTINEL).float().mean())
    # tail: 64 new ids carrying the signatures of 64 seeds of this batch
    index_t = insert(index, sigs[:, seeds[:64, 0].long()],
                     torch.arange(N, N + 64, dtype=torch.int32, device=dev))
    extra = tail_hits(index_t, seeds)
    if not bool((extra != SENTINEL).any()):
        raise AssertionError("the tail case holds no tail hits")
    t_args = (starts, lens, extra, svc._flat_ids(), popular)
    got_t = lsh_kernel.lsh_retrieve_topc(*t_args, C=core_C, cap=cfg.cap)
    if not torch.equal(got_t, lsh_retrieve_topc_ref(*t_args, C=core_C,
                                                    cap=cfg.cap)):
        raise AssertionError("lsh_retrieve (non-empty tail) differs")
    if not bool(((got_t >= N) & (got_t != SENTINEL)).any()):
        raise AssertionError("no tail id reached the candidates")
    print(f"[4 check] lsh_retrieve bit-exact at B={B} I={starts.shape[1]} "
          f"cap={cfg.cap} C={core_C} (slots filled {filled:.3f}); with a "
          f"64-item tail (X={extra.shape[1]}) bit-exact", flush=True)

    cand = torch.cat([got, popular[None, :].expand(B, -1)], dim=1)
    F = svc.planes.F
    urow = svc.planes.row[users.long()]
    urow[:, F] += svc.planes.mu
    safe = cand.clamp(0, N - 1).contiguous()
    mask = (cand != SENTINEL).to(torch.float32)
    masked = mask.clone()
    masked[:8] = 0                      # all-masked rows
    b_odd = B - 6                       # not a multiple of tile_b
    sc_args = (urow, svc.planes.col, safe, mask)
    score_err = 0.0
    for args_ in (sc_args, (urow, svc.planes.col, safe, masked),
                  (urow[:b_odd], svc.planes.col, safe[:b_odd],
                   mask[:b_odd])):
        score_err = max(score_err, assert_topn_close(
            *score_kernel.candidate_score_topn(*args_, topn=cfg.topn),
            *candidate_score_topn_ref(*args_, topn=cfg.topn,
                                      tile_b=cfg.tile_b)))
    print(f"[4 check] candidate_score within 1e-5 (max abs err "
          f"{score_err:.3g}) at B={B} C={cfg.C} F={F} topn={cfg.topn}, with "
          f"8 all-masked rows and B={b_odd}", flush=True)

    # ---- 5. serve: the main path, counters zeroed just before ----
    lsh_kernel.LAUNCHES = 0
    score_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    svc.warmup()
    for _ in range(BATCHES):
        svc.submit(rng.integers(0, M, B).astype(np.int32))
    svc.flush()
    wall = time.perf_counter() - t0
    launches = dict(lsh_retrieve=lsh_kernel.LAUNCHES,
                    candidate_score=score_kernel.LAUNCHES)
    st = svc.stats()
    items = np.concatenate([r[2] for r in svc.take_results()])
    print(f"[5 serve] {st['batches']} flushes, {st['users']} users: "
          f"{st['qps']:.0f} users/s (busy time), p50 {st['p50_ms']:.3f} ms, "
          f"p99 {st['p99_ms']:.3f} ms per flush; wall {wall:.2f} s incl. "
          f"warmup; launches {launches}", flush=True)
    if items.shape != (BATCHES * B, cfg.topn):
        raise AssertionError(f"served {items.shape} answers")
    if not ((items >= 0) & (items < N)).all():
        raise AssertionError("served ids outside the catalog")
    if on_card:
        for name, n in launches.items():
            if n < st["batches"]:
                raise AssertionError(f"{name} launched {n} times in "
                                     f"{st['batches']} flushes")
        state = [svc.planes.row, svc.planes.col, svc.planes.mu, svc.sp.rows,
                 svc.sp.cols, svc.sp.vals, svc.popular, svc._flat_ids(),
                 *(getattr(svc.index, f) for f in (
                     "sorted_sigs", "sorted_ids", "bucket_lo", "bucket_hi",
                     "slot_of", "tail_sigs", "tail_ids"))]
        if any(t.device.type != "cuda" for t in state):
            raise AssertionError("serving state left the card")
        profile_flushes(svc, [rng.integers(0, M, B).astype(np.int32)
                              for _ in range(PROFILED)])

    # ---- 6. recall@10 against exact scoring ----
    probe = rng.integers(0, M, PROBE).astype(np.int32)
    svc.submit(probe)
    svc.flush()
    got_p = np.concatenate([r[2] for r in svc.take_results()])
    exact = np.concatenate([
        full_topn(svc.params, torch.from_numpy(probe[i:i + B]).to(dev),
                  topn=cfg.topn)[1].cpu().numpy()
        for i in range(0, PROBE, B)])
    recall = sum(len(set(g) & set(e))
                 for g, e in zip(got_p, exact)) / exact.size
    print(f"[6 recall] recall@{cfg.topn} = {recall:.4f} on {PROBE} probe "
          f"users (floor 0.5)", flush=True)
    if not recall >= 0.5:
        raise AssertionError(f"recall@10 {recall:.4f} below 0.5")

    # ---- 7. time each kernel and its plain version ----
    I, X, E = starts.shape[1], no_tail.shape[1], popular.shape[0]
    Wp = lsh_kernel.pool_width(I, cfg.cap, X)
    lsh_ms = median_ms(lambda: lsh_kernel.lsh_retrieve_topc(
        *lsh_args, C=core_C, cap=cfg.cap), dev)
    lsh_plain = median_ms(lambda: lsh_retrieve_topc_ref(
        *lsh_args, C=core_C, cap=cfg.cap), dev)
    # bytes: descriptors + extras + exclude read once, the valid window
    # slots read once, the [B, C] output written once; operations: the
    # n·log2(n) comparisons of two sorts of the Wp-wide pool
    lsh_bytes = 4 * (2 * B * I + B * X + E + int(lens.sum()) + B * core_C)
    lsh_bound, lsh_by = bound_ms(lsh_bytes, 2 * B * Wp * np.log2(Wp))
    sc_ms = median_ms(lambda: score_kernel.candidate_score_topn(
        *sc_args, topn=cfg.topn), dev)
    sc_plain = median_ms(lambda: candidate_score_topn_ref(
        *sc_args, topn=cfg.topn, tile_b=cfg.tile_b), dev)
    # bytes: user rows, ids and mask read once, one plane row per valid
    # slot, the outputs written once; operations: a multiply-add per
    # factor plus two bias adds per valid slot
    n_valid = int((mask > 0).sum())
    sc_bytes = 4 * (B * (F + 1) + 2 * B * cfg.C + n_valid * (F + 1)
                    + 2 * B * cfg.topn)
    sc_bound, sc_by = bound_ms(sc_bytes, n_valid * (2 * F + 2))
    power = smi.split(",")[-1].strip() if on_card else "cpu rehearsal"
    for name, ms, plain, bnd, by in (
            ("lsh_retrieve", lsh_ms, lsh_plain, lsh_bound, lsh_by),
            ("candidate_score", sc_ms, sc_plain, sc_bound, sc_by)):
        print(f"[7 time] {name}: kernel {ms:.4f} ms, plain version "
              f"{plain:.4f} ms, bound {bnd:.5f} ms ({by}); no single PyTorch "
              f"call computes this function, so no library yardstick "
              f"(power limit {power})", flush=True)

    kernels = [
        dict(name="lsh_retrieve", route="cuda",
             source="src/repro_torch/csrc/lsh_retrieve.cu",
             replaces="src/repro/kernels/lsh_retrieve/kernel.py:155",
             launches=launches["lsh_retrieve"], max_abs_err=0,
             ms=lsh_ms, plain_ms=lsh_plain, bound_ms=lsh_bound,
             bound_by=lsh_by, library_ms=None),
        dict(name="candidate_score", route="cuda",
             source="src/repro_torch/csrc/candidate_score.cu",
             replaces="src/repro/kernels/candidate_score/kernel.py:129",
             launches=launches["candidate_score"], max_abs_err=score_err,
             ms=sc_ms, plain_ms=sc_plain, bound_ms=sc_bound,
             bound_by=sc_by, library_ms=None),
    ]
    entries, ctx = fit_phases(args, dev, on_card, power)
    kernels += entries
    kernels.append(encode_phase(sp, lsh, prng.PRNGKey(args.seed, device=dev),
                                sigs, dev, on_card, power))
    legacy_phase(ctx, dev)
    kernels.append(predict_phase(ctx, dev, on_card, power))
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    if not on_card:
        print("chip_smoke: CPU rehearsal finished; a result needs a CUDA "
              "card", file=sys.stderr)
        return 3
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
