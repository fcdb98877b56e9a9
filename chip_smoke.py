#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving main path on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device — the card's name and power limit (nvidia-smi), CUDA version;
2. build — both hand-written kernels from ``src/repro_torch/csrc``;
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
   3.35 TB/s, operations over 67 TFLOP/s).

The second-last line is a JSON object listing the kernels; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA card the script
exits non-zero before printing any result.  ``--device cpu --n-items
20000`` rehearses phases 3–7 on the CPU with the plain versions and then
exits 3, also without a result.
"""
from __future__ import annotations

import argparse
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


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


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
    svc.take_results()
    print(f"[5 profile] {len(batches)} flushes: host wall {wall_us:.0f} us, "
          f"device busy {busy:.0f} us ({busy / wall_us:.3f} of the wall), "
          f"{len(spans)} device activities", flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"[5 profile]   {us / len(batches):9.2f} us/flush  "
              f"{name[:90]}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the smoke run) or cpu (rehearsal, no result)")
    ap.add_argument("--n-items", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — nothing was run", file=sys.stderr)
        return 2

    from repro_torch import convert
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
    sigs = simlsh.encode(sp, lsh, seed=args.seed)
    index = build_index(sigs, tail_cap=128, device=dev)
    cfg = ServeConfig(topn=10, micro_batch=256, C=768, n_seeds=16, cap=8,
                      n_popular=64, tile_b=16, band_budget=768)
    svc = RecsysService(params, index, sp, cfg, device=dev)
    if on_card:
        torch.cuda.synchronize()
    mb = lambda *ts: sum(t.numel() * t.element_size() for t in ts) / 1e6
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
