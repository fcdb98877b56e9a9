#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main paths — serving, the offline
fit, the simLSH encoder, the legacy fit with checkpoints, batch scoring,
online learning, its resilience layer, the always-on loop, the fit's
neighbour comparators, the other serving paths, the multi-device tiers,
the Table-10 comparison with the NCF models, the examples and dense LM
serving — on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device — the card's name and power limit (nvidia-smi), CUDA version;
2. build — the seven hand-written kernels from ``src/repro_torch/csrc``
   (the six TPU kernels' counterparts and the deterministic
   `segment_add` scatter);
3. catalog and state — a planted catalog at the repo's million-item
   serving scale (N = 1,000,000 items, M = 640,000 users, F = 48,
   24,000,000 ratings; the recipe of `benchmarks/bench_serve.py::
   make_catalog`), simLSH signatures with the 18-bit N ≥ 10⁶ settings
   (G=9, p=2, q=10) and the bucketed LSH index, all on the card;
4. kernel vs plain — each kernel against its plain PyTorch version on the
   card, at the shapes of a real 256-user flush, plus edge cases (all
   SENTINEL rows, a batch that is not a multiple of ``tile_b``, a
   non-empty index tail); the scorer is the fused `score_topn` (user-row
   gather, μ, id clip and mask, score, top-N, items), held with
   `assert_topn_close` at 1e-5, also at topn = 50;
5. serve — `RecsysService` warmup + 64 micro-batches of 256 users, with
   the kernels' launch counters zeroed just before and read just after;
   then 16 more flushes under `torch.profiler` for the device's busy
   share and its time by kernel (that window's host wall includes the
   profiler's own overhead);
6. recall@10 against exact scoring (`full_topn`) on 1,024 probe users;
7. timing — each kernel and its plain version at the phase-5 shapes
   (median of 30 CUDA-event-timed calls, each after an L2-evicting
   scrub; both kernels also in a CUDA graph), beside the least time the
   card could take (bytes over 3.35 TB/s, operations over 67 TFLOP/s);
8. fit set-up — the repo's ~100M-parameter LSH-MF model
   (`examples/train_lshmf_100m.py`: M = 700,000 users, N = 30,000 items,
   F = 128, K = 64) on `synthetic.MOVIELENS_LIKE` data reshaped to those
   M, N and 2,000,000 ratings (10 % held out), with each stage of `fit`
   timed on the card (encode, Top-K, the host scheduler, the
   schedule-ordered data, the eval cache), its resident MB, the
   schedule's statistics, and the signature bits that differ between two
   encodes (must be 0: the segment sum adds in COO order);
9. kernel vs plain — the fused in-place CULSH-MF step against the plain
   gather → step → delta scatter on copies of that state's planes
   (schedule windows of B = 512, 7, 250, a tier's last partial batch,
   all slots invalid, BCE both ways), the stale-b̂ hazard batch (every
   neighbour another live slot's col) launched 20 times, padding slots
   that repeat live ids adding nothing to the planes; the fused in-place
   CUSGD++ step (`mf_sgd_batch`) the same way against
   `apply_mf_sgd_ref` on the same windows, with its own padding check;
   in every case the rows no live slot owns stay bit for bit;
10. fit — `fit(use_kernels=True)` for 3 epochs with the `culsh_sgd`
    counter zeroed just before (it must equal the conflict-free steps x
    epochs), the same fit on the plain steps (final RMSE within 1e-3),
    one epoch of plain MF (``method="none"``) through the fused CUSGD++
    step (its counter must equal the conflict-free steps), then one more
    epoch of each under `torch.profiler`, the conflict-free tiers of
    each alone under it (device activities per step, at most 2), and one
    epoch of each in its two parts — tiers and leftover batches — timed
    alone;
11. timing — both fused SGD steps and their plain versions at B = 512: the
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
    B = 8,192 in CUDA graphs beside the bound;
15. online (paper Alg. 4) — phase 8's data relabelled (numpy seed 0) so
    a random 1 % of users and 4 % of items hold the top ids, cut at
    M0 < M1 < M and N0 < N1 < N (99 / 99.5 % and 96 / 98 %): the old
    world is fitted (phase 10's `FitConfig`, the `culsh_sgd` counter
    zeroed just before), indexed (tail_cap 1,024) and served with phase
    3's `ServeConfig`; `online_update` takes ΔΩ₁ to (M1, N1) — old
    slices and J^K bit for bit, signatures against a fresh encode by the
    near-zero rule, the new ids' test RMSE below the untrained one —
    and `ingest_online_update` puts its 600 items in the tail; 64
    flushes (half new users, counters zeroed just before: one launch
    of each serving kernel a flush) each against the plain versions,
    recall@10 against `full_topn`; ΔΩ₂ takes the catalog to N and
    overflows the tail, so the index is rebuilt synchronously (equal to
    `build_index`, `validate_index` clean, 16 more flushes checked);
    a NaN rating, learning rates ×10⁴ and a NaN accumulator are each
    refused while the service serves on; one `micro_epoch` over the
    merged ratings; update 1 run twice must be bit-identical, S too;
16. resilience — on phase 15's state an `OnlineUpdater` (ckpt_every 2)
    logs and applies three ΔΩ (a third of the test ratings each, plus new
    users and items), crashes on the third after logging it, and
    `recover` must equal an uninterrupted updater leaf for leaf (the
    `segment_add` counter zeroed just before); the WAL, checkpoint and
    replay costs; `segment_add` against the CPU's `index_add_` (bit for
    bit) and timed at the online step's shape.  On phase 3's N = 10⁶
    catalog with a 1,024-item tail: a 16-micro-batch burst against
    ``max_pending`` of 4 (shed into degraded popularity answers, in
    submission order); deadline shedding under an injected stall; an
    injected flush exception answered by `full_topn`; 1,100 new items
    overflowing the tail into a background rebuild while 32 flushes go
    on against index v, then the validated swap; a corrupt build refused
    by the validation gate and never served; and the gate's verdict and
    outcome on the fit's 8-bit catalog.  Every phase that injects no
    ``serve.flush`` fault must show 0 fallbacks;
17. the always-on loop — `OnlineLoop` on phase 15's final state (the
    fit's model at full width): `OnlineUpdater(K=64, epochs=3,
    batch=4096)`, `OnlineLoop.build_service` with phase 3's
    `ServeConfig` and a 1,024-item tail, `LoopConfig` defaults, a fixed
    20,000 of the held-out ratings as the drift probe; each slice
    submits 2 × 256 users (a quarter new ids) and even slices offer a ΔΩ
    (phase 16's recipe).  A 6-slice reference arm, the counters zeroed
    just before (one `lsh_retrieve` and one `candidate_score` launch a
    scored flush or warm-up; each slice's first flush against the plain
    versions), its states' leaf SHA-256 kept by seq; a drift trip forced
    on it (``drift_tol`` −0.5), whose requested rebuild of the fit's
    8-bit catalog ends as the validation gate says; then three arms
    killed at ``loop.slice`` call 3, ``loop.ckpt`` call 1 and
    ``loop.drift`` call 1, each recovered by `OnlineLoop.recover` to the
    reference's hashes at its seq and run one more slice with nothing
    dropped; the span seconds, staleness p99 and the time to recover
    (restore, WAL replay, `build_service` and warm-up);
18. comparators — `fit(use_kernels=True)` with ``rand``, ``rp_cos`` and
    ``minhash`` beside ``simlsh`` on phase 8's data and model for 2
    epochs, and ``gsm`` beside ``simlsh`` at `MOVIELENS_LIKE`'s M × N
    (69,878 × 10,677; 10⁶ ratings) with the paper's Table-7 settings
    (F = 16, K = 8, G = 8, p = 1, q = 20, band_cap 16, ψ 2.0) for 6
    epochs: the `culsh_sgd` counter equals conflict-free steps × epochs
    and the RMSE falls in each;
    minhash and random-K equal to their CPU run on one band, RP_cos run
    twice bit-identical; GSM's J^K against a float64 recompute on 64
    sampled rows; each method's neighbour seconds and device memory
    beside simLSH's, and GSM's dense-operand reckoning at the 100M
    model, which the card cannot hold.
19. serving paths — on phase 3's catalog at full width with its J^K
    (`topk_from_signatures(sigs, fold_in(key, 1), K=16, band_cap=16)`,
    `benchmarks/bench_serve.py`'s recipe) and a fresh index: the legacy
    pool + dedup oracle (``band_budget=0``) for warm-up + 64 flushes, the
    counters zeroed just before (one `candidate_score` launch a flush or
    warm-up, no `lsh_retrieve`), its first 8 flushes against
    `recommend_candidates(impl="ref")` at 1e-5, `retrieve_for_users` on
    the card equal to the CPU's, a ``pool_width=512`` flush; the plain
    walk (``impl="ref"``: no kernel launch), `walk_candidates` on the
    card equal to the CPU's; each arm's recall@10 on phase 6's probe
    users (floor 0.5) and the plain walk's top-10 overlap with the
    kernel path; ``route_full_below = N + 1`` answering `full_topn`'s
    ids and ``-1`` reporting its verdict; `profile_flush` on the kernel
    walk, plain walk and legacy services (the JAX span names, the staged
    answer equal to the fused flush's);
20. multi-device tiers — on four logical shards of the card
    (``REPRO_TORCH_LOGICAL_DEVICES=4``, printed with the card count):
    (a) on an N = 4,000 catalog of phase 3's recipe with nothing
    truncated (cap 4,096, budgets 16,384), D = 2 and 4 give the top-10 id
    sets of a single-device ``impl="ref"`` service, and the D = 4 flush
    at the bench settings equals the same flush on the CPU; (b) phase 3's
    catalog and `ServeConfig` with ``shards=4``: warm-up + 64 flushes
    with both serving kernels' counters zeroed just before (both must
    stay 0), recall@10 on phase 6's probe users (floor 0.5) beside phase
    19's plain walk (the JAX gate of −0.01, reported), `validate_index`
    clean on the sharded index, the three ingest entry points refused
    with `ShardedIngestUnsupported` and `OnlineLoop` refusing the
    service; (c) phase 8's model scheduled with ``shards=4``: the shard
    tier's cells, share of the ratings and MB; two epochs through the
    mesh and through the one-device replay from one state (every leaf
    and the test RMSE within 1e-5), each epoch's shard tier timed alone;
    `fit(shards=4, use_kernels=True)` for 2 epochs, its `culsh_sgd`
    counter zeroed just before equal to the width tiers' steps × 2 and
    its RMSE falling, beside phase 10's epochs.  Phases 8–18 fit with
    ``shards=1``, so their launch counts do not depend on the machine's
    card count;
21. Table 10 — `benchmarks/bench_ncf.py`'s planted implicit recipe and
    protocol, re-implemented here at `MOVIELENS_LIKE`'s M × N (69,878 ×
    10,677, 15 draws a user): each user's last positive held out against
    50 sampled negatives; CULSH-MF (``loss="bce"``, F = 16, K = 8, 40
    epochs, `bench_ncf.py`'s `Hyper`) on positives plus 3:1 negatives,
    the `culsh_sgd` counter zeroed just before (= conflict-free steps ×
    40), then the bce kernel against its plain version at these shapes
    (F = 16 and K = 8 leave lanes masked) on the trained state and the
    first and last window of each width tier of the fit's schedule;
    GMF, MLP and NeuMF (`core/ncf.py`, F = 16, tower (32, 16)) for
    200 full-batch Adam steps at lr 2e-2 on 1:1 negatives; each model's
    wall seconds, HR@10 and first and last loss (every loss must fall);
    NeuMF's first step on the card against the CPU (each gradient leaf
    within 1e-9 of its largest entry in float64 and 1e-3 in float32, the
    Adam update of the same gradients 1e-6);
22. examples — each `examples/torch_*.py` in a subprocess on the card at
    its default size (``torch_train_lshmf_100m --small``; the serving
    example also with ``--online-loop --slices 3``; the LM example in
    both arms, 10 steps each): exit 0, its last lines, and its ``--report`` line's
    launch counters (`culsh_sgd` in every LSH-MF one; `lsh_retrieve` and
    `candidate_score` in the serving ones; `segment_add` in the LM
    example's ``--lsh-softmax`` arm)
    and, for the serving example, its kernel walk held against the
    kernels' plain versions on one probe flush of its own shapes;
23. dense LM serving — `repro_torch.launch.serve.serve` at llama3-8b's
    full width (8.0·10⁹ float32 parameters drawn layer by layer on the
    card), batch 4, prompt 64, 32 decoded tokens: prefill and decode
    seconds, tokens/s beside the bound of reading the float32 weights
    once a step, resident and peak MB; on a 2-layer cut of the same
    widths, prefill's last-position logits against a 64-step decode (the
    KV cache) and the card's bfloat16 prefill against the CPU's float32,
    each within a stated multiple of bfloat16's unit roundoff.
24. LM training — on a 2-layer cut of qwen3-0.6b's widths (V = 151,936)
    one float32 train step on the card against the CPU (loss 1e-5
    relative, each gradient leaf within 1e-3 of its own max |g|, Adam of
    the card's gradients 1e-6) and the card's bfloat16 loss within 4u of
    the CPU's float32 one; `repro_torch.launch.train.train_loop` at full
    width (5.96·10⁸ float32 parameters, batch 8 × seq 128, the reference
    CLI's) for 20 steps in two calls, the second resuming from the first's
    step-10 checkpoint (restored bit for bit; in a temp dir under
    `build/`, removed): step seconds, tokens/s against a bound from the
    shapes, resident and peak MB, the loss at steps 0, 10 and 19 (it must
    fall), one step under the profiler; a microbatched step with
    ``mb_mask`` [1, 0] whose loss is microbatch 0's; the simLSH softmax
    (16,384 candidates, a refresh of the tied embedding every 10 steps)
    for 20 steps, the `segment_add` counter zeroed just before (its
    launches join phase 16's in the kernels line), its loss falling, the
    full-cover loss equal to the full softmax's, two 3-step runs from one
    state bit-equal, and `segment_add` at the candidate gradient's shape
    bit-equal to the CPU's `index_add_`.

The second-last line is a JSON object listing the kernels; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA card the script
exits non-zero before printing any result.  ``--device cpu --n-items
20000 --fit-scale 0.01`` rehearses phases 3–24 on the CPU with the plain
versions and then exits 3, also without a result; on the card both
sizes must keep their defaults, so a result always comes from the full
configurations.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM float32 rate outside tensor cores
BF16_OPS_PER_S = 989e12     # H100 SXM bfloat16 dense tensor-core rate
BATCHES = 64                # phase 5 micro-batches
PROFILED = 16               # flushes under the profiler
PROBE = 1024                # phase 6 probe users
N_ITEMS = 1_000_000         # the serving catalog (phases 3–7)
# the fit: the repo's ~100M-parameter LSH-MF model
# (`examples/train_lshmf_100m.py`), 3 epochs
FIT_M, FIT_N, FIT_NNZ, FIT_F, FIT_K, FIT_EPOCHS = (700_000, 30_000, 2_000_000,
                                                   128, 64, 3)
SGD_TOL = dict(rtol=1e-5, atol=1e-6)  # the JAX package's (tests/test_kernels.py)
# phase 18's GSM data: MOVIELENS_LIKE's M × N with 10⁶ of its 9,900,054
# ratings (the host generator's oversampling grows faster than linearly:
# 2·10⁶ took 79 s on the card's host; GSM's dense operands and products
# depend on M × N only)
GSM_NNZ = 1_000_000
# phase 21: Table 10 at MOVIELENS_LIKE's M × N, 15 interactions a user
# (`benchmarks/bench_ncf.py`'s recipe), 200 full-batch Adam steps a model
T10_M, T10_N, T10_PER_USER, T10_STEPS = 69_878, 10_677, 15, 200


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


def profile_flushes(svc, batches, tag: str = "5 profile") -> None:
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
    print(f"[{tag}] {len(batches)} flushes: host wall {wall_us:.0f} us, "
          f"device busy {busy:.0f} us ({busy / wall_us:.3f} of the wall), "
          f"{len(spans)} device activities", flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"[{tag}]   {us / len(batches):9.2f} us/flush  "
              f"{name[:90]}", flush=True)


def megabytes(*ts) -> float:
    return sum(t.numel() * t.element_size() for t in ts) / 1e6


def copy_planes(q):
    """A copy of packed fit planes (the fused steps update in place)."""
    import dataclasses
    return dataclasses.replace(q, row=q.row.clone(), col=q.col.clone())


def fused_vs_plain(state, b, hp, *, F: int, bce=False, mf=False):
    """The fused step (CUSGD++ with ``mf``, else CULSH-MF) on a copy of
    ``state`` against the plain gather → step → delta scatter on
    another; every row no live slot owns (and, for CUSGD++, every
    column past F) must stay bit for bit → (kernel planes, plain
    planes, max abs err)."""
    from repro_torch.kernels.mf_sgd import kernel as sgd_kernel
    from repro_torch.kernels.mf_sgd.ref import (apply_culsh_sgd_ref,
                                                apply_mf_sgd_ref)

    dev = state.row.device
    kern, plain = ((sgd_kernel.mf_sgd_batch, apply_mf_sgd_ref) if mf
                   else (sgd_kernel.culsh_sgd_batch, apply_culsh_sgd_ref))
    got = kern(copy_planes(state), b, hp, bce=bce)
    want = plain(copy_planes(state), b, hp, bce=bce)
    err = 0.0
    for g, w in ((got.row, want.row), (got.col, want.col)):
        torch.testing.assert_close(g, w, **SGD_TOL)
        err = max(err, float((g - w).abs().max()))
    live = b.valid > 0
    for g, x, ids in ((got.row, state.row, b.i), (got.col, state.col,
                                                   b.j)):
        rest = torch.ones(x.shape[0], dtype=torch.bool, device=dev)
        rest[ids[live].long()] = False
        if not torch.equal(g[rest], x[rest]):
            raise AssertionError("a row no live slot owns changed")
        if mf and not torch.equal(g[:, F:], x[:, F:]):
            raise AssertionError("the CUSGD++ step changed a column "
                                 "past F")
    return got, want, err


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
    from repro_torch.kernels.mf_sgd.ops import culsh_hyper, mf_hyper
    from repro_torch.kernels.mf_sgd.ref import (apply_culsh_sgd_ref,
                                                apply_mf_sgd_ref)
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
    # one shard: these phases' launch counts must not depend on how many
    # cards the machine has (phase 20 runs the shard tier)
    cfg = FitConfig(F=F, K=K, epochs=FIT_EPOCHS, method="simlsh",
                    lsh=simlsh.SimLSHConfig(G=8, p=1, q=10, band_cap=16),
                    seed=args.seed, use_kernels=True, shards=1)
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
          f"{sigs.numel() * cfg.lsh.sig_bits} signature bits differ "
          f"(limit 0: the segment sum adds in COO order)", flush=True)
    if flipped:
        raise AssertionError(f"two encodes differ in {flipped} signature "
                             f"bits")

    # ---- 9. kernel vs plain, on batches of the fit's state ----
    decay = sgd.lr_decay(cfg.hp, 0, dev)
    hpv = culsh_hyper(cfg.hp, decay, pp.mu)
    hmf = mf_hyper(cfg.hp, decay, dev)
    copy = copy_planes

    def window(t, k, width=None):
        width = width or sched.widths[t]
        return model.slice_batch(sd, int(sched.tier_starts[t][k]), width,
                                 torch.as_tensor(sched.tier_valid[t][k][:width],
                                                 device=dev).float())

    bt = window(0, 0)
    W0 = sched.widths[0]
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    wc = copy(pp)                       # W and C as a trained state has them
    wc.col[:, F:F + 2 * K] = 0.1 * torch.randn((N, 2 * K), generator=gen,
                                               device=dev)
    off = dataclasses.replace(bt, valid=torch.zeros_like(bt.valid))
    last_t = max(t for t, s in enumerate(sched.tier_starts) if len(s))
    last = window(last_t, -1)           # a tier's last, partial batch
    culsh_cases = {f"B={W0}": (pp, bt), f"B={W0} random W,C": (wc, bt),
                   "B=7": (wc, window(0, 0, 7)),
                   "B=250": (wc, window(0, 0, 250)), "all invalid": (wc, off),
                   f"last batch of width {sched.widths[last_t]} "
                   f"({int(last.valid.sum())} valid)": (wc, last)}
    culsh_err = 0.0
    for state, b in culsh_cases.values():
        for bce in (False, True):
            got, _, err = fused_vs_plain(state, b, hpv, F=F, bce=bce)
            culsh_err = max(culsh_err, err)
    got, _, _ = fused_vs_plain(wc, off, hpv, F=F)
    if not (torch.equal(got.row, wc.row) and torch.equal(got.col, wc.col)):
        raise AssertionError("an all-invalid batch changed the planes")
    mf_err = 0.0
    for state, b in culsh_cases.values():
        for bce in (False, True):
            mf_err = max(mf_err, fused_vs_plain(state, b, hmf, F=F,
                                                bce=bce, mf=True)[2])
    got, _, _ = fused_vs_plain(wc, off, hmf, F=F, mf=True)
    if not (torch.equal(got.row, wc.row) and torch.equal(got.col, wc.col)):
        raise AssertionError("an all-invalid batch changed the planes "
                             "(CUSGD++)")
    # the stale-b̂ hazard: every explicit neighbour of every slot is another
    # live slot's col; b̂ and W at larger rates so a stale read would show
    live_j = bt.j[bt.valid > 0]
    nxt = (torch.arange(W0, device=dev)[:, None] + 1
           + torch.arange(K, device=dev)[None, :]) % live_j.shape[0]
    hz = dataclasses.replace(bt, nb=live_j[nxt].contiguous(),
                             expl=torch.ones_like(bt.expl),
                             impl=torch.zeros_like(bt.impl))
    hp_hz = hpv.clone()
    hp_hz[1], hp_hz[4] = 0.3, 0.05                  # γ of b̂ and of W
    hz_err = 0.0
    for _ in range(20):
        _, want, err = fused_vs_plain(wc, hz, hp_hz, F=F)
        hz_err = max(hz_err, err)
    stale = copy(wc)                    # slot by slot: reads updated b̂
    for s_ in torch.nonzero(bt.valid > 0).flatten().tolist():
        apply_culsh_sgd_ref(stale, model.Batch(*(
            getattr(hz, f.name)[s_:s_ + 1] for f in dataclasses.fields(hz))),
            hp_hz)
    stale_gap = float((stale.col - want.col).abs().max())
    if torch.allclose(stale.col, want.col, **SGD_TOL):
        raise AssertionError("the hazard batch cannot tell a stale b̂")
    del stale, want
    # padding slots that repeat live ids add exactly nothing to the planes
    q = W0 // 4
    i2, j2, v2 = bt.i.clone(), bt.j.clone(), bt.valid.clone()
    i2[-q:], j2[-q:], v2[-q:] = bt.i[:q], bt.j[:q], 0.0
    with_pad = dataclasses.replace(bt, i=i2, j=j2, valid=v2)
    live = model.Batch(*(getattr(with_pad, f.name)[:W0 - q]
                         for f in dataclasses.fields(bt)))
    for step, hp_ in ((sgd_kernel.culsh_sgd_batch, hpv),
                      (sgd_kernel.mf_sgd_batch, hmf)):
        planes = [copy(wc) for _ in range(2)]
        step(planes[0], with_pad, hp_)
        step(planes[1], live, hp_)
        if not (torch.equal(planes[0].row, planes[1].row)
                and torch.equal(planes[0].col, planes[1].col)):
            raise AssertionError("padding slots that repeat live ids "
                                 "changed the planes")
    del planes, got
    culsh_err = max(culsh_err, hz_err)
    print(f"[9 check] culsh_sgd (fused, in place) within rtol 1e-5 / atol "
          f"1e-6 of the plain gather -> step -> scatter (max abs err "
          f"{culsh_err:.3g}), BCE both ways, on: " + ", ".join(culsh_cases)
          + f"; an all-invalid batch leaves the planes bit for bit; the "
          f"stale-b^ hazard batch ({int(bt.valid.sum())} live slots, every "
          f"neighbour another live slot's col) 20 launches within tolerance "
          f"(max abs err {hz_err:.3g}; read slot by slot it is off by "
          f"{stale_gap:.3g}); {q} padding slots repeating live i/j add "
          f"nothing to the planes; mf_sgd (fused, in place) within tolerance "
          f"of apply_mf_sgd_ref on the same cases (max abs err "
          f"{mf_err:.3g}), the same padding check; rows no live slot owns "
          f"bit for bit", flush=True)

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
    mf_secs = mf.history[-1][1]
    print(f"[10 fit] method='none': mf_sgd launches {mf_launches} = "
          f"{mf.schedule_stats['nb_cf']} conflict-free steps; epoch "
          f"{mf_secs:.3f} s, rmse {mf.history[-1][2]:.6f}", flush=True)
    if not np.isfinite(mf.history[-1][2]):
        raise AssertionError("the plain MF fit diverged")
    if on_card and mf_launches != mf.schedule_stats["nb_cf"]:
        raise AssertionError(f"mf_sgd launched {mf_launches} times")
    in_loop = {}
    if on_card:   # one more epoch of each engine under the profiler
        sd_mf = model.build_scheduled_data(sp, JK, sched, mf_only=True)
        key_ep = prng.fold_in(k_ep, cfg.epochs)
        kernel_of = dict(culsh_sgd="culsh_sgd_kernel",
                         mf_sgd="mf_sgd_kernel")

        def epoch(state, data_, mf_only):
            sgd.train_epoch_scheduled(state, data_, sched, key_ep,
                                      cfg.epochs, cfg.hp, mf_only=mf_only,
                                      use_kernels=True)

        def part(state, name, mf_only=False):
            """One part of a kernel epoch alone (plain MF with
            ``mf_only``), each batch through `sgd._cf_scan` as the epoch
            runs it (in the schedule's order): the conflict-free tiers, or
            the leftover batches."""
            on_dev = lambda a: torch.as_tensor(a, device=dev)
            decay_ = sgd.lr_decay(cfg.hp, cfg.epochs, dev)
            hv = (mf_hyper(cfg.hp, decay_, dev) if mf_only
                  else culsh_hyper(cfg.hp, decay_, state.mu))
            scan = lambda starts, valid, **kw: sgd._cf_scan(
                state, sd_mf if mf_only else sd, starts,
                on_dev(valid).float(), cfg.hp, decay_, hv, mf_only=mf_only,
                bce=False, **kw)
            if name == "tiers":
                for t, (starts, valid) in enumerate(zip(sched.tier_starts,
                                                        sched.tier_valid)):
                    if len(starts):
                        scan(starts, valid, width=sched.widths[t],
                             conflict_free=True, use_kernels=True)
            elif len(sched.lo_starts):
                scan(sched.lo_starts, sched.lo_valid, width=sched.widths[0],
                     conflict_free=False, use_kernels=False,
                     scales=(on_dev(sched.lo_scale_i),
                             on_dev(sched.lo_scale_j)))

        def profiled(run, *a):
            sync()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run(*a)
                sync()
                wall_us = (time.perf_counter() - t0) * 1e6
            return wall_us, device_activity(prof)

        for name, state, data_, mf_only in (
                ("culsh_sgd", model.pack_params(res.params), sd, False),
                ("mf_sgd", model.pack_params(mf.params), sd_mf, True)):
            wall_us, (spans, busy, by_name) = profiled(epoch, state, data_,
                                                       mf_only)
            mine = [us for n, us in by_name.items() if kernel_of[name] in n]
            in_loop[name] = sum(mine) / 1e3 / max(nb_cf, 1)
            print(f"[10 profile] one {name} epoch: host wall {wall_us:.0f} "
                  f"us, device busy {busy:.0f} us ({busy / wall_us:.3f} of "
                  f"the wall), {len(spans)} device activities, "
                  f"{in_loop[name]:.5f} ms per kernel launch", flush=True)
            for n, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
                print(f"[10 profile]   {us / 1e3:9.2f} ms  {n[:90]}",
                      flush=True)
        # the conflict-free tiers alone: device activities per step
        for name, params_, mf_only in (("culsh_sgd", res.params, False),
                                       ("mf_sgd", mf.params, True)):
            wall_us, (spans, busy, _) = profiled(
                part, model.pack_params(params_), "tiers", mf_only)
            per_step = len(spans) / max(nb_cf, 1)
            print(f"[10 profile] the {name} conflict-free tiers alone: "
                  f"{len(spans)} device activities in {nb_cf} steps = "
                  f"{per_step:.3f} per step (limit 2); host wall "
                  f"{wall_us:.0f} us, device busy {busy:.0f} us "
                  f"({busy / wall_us:.3f} of the wall)", flush=True)
            if per_step > 2:
                raise AssertionError(f"{per_step:.3f} device activities per "
                                     f"conflict-free {name} step")
        # the profiles hold ~10⁵ Python objects; free them so no collector
        # pause lands in the timed host gaps below and in phase 11
        del spans, by_name
        gc.collect()
        # one epoch of each in its two parts, unprofiled: the leftover share
        nb_lo = res.schedule_stats["nb_lo"]
        for name, params_, mf_only in (("kernel", res.params, False),
                                       ("plain-MF", mf.params, True)):
            secs_of = {}
            for part_name in ("tiers", "leftovers"):
                state = model.pack_params(params_)
                sync()
                t0 = time.perf_counter()
                part(state, part_name, mf_only)
                sync()
                secs_of[part_name] = time.perf_counter() - t0
            t_cf, t_lo = secs_of["tiers"], secs_of["leftovers"]
            print(f"[10 time] one {name} epoch in its two parts: {nb_cf} "
                  f"conflict-free steps {t_cf:.3f} s "
                  f"({t_cf / nb_cf * 1e6:.1f} us per step, host-paced), "
                  f"{nb_lo} leftover batches {t_lo:.3f} s "
                  f"({t_lo / max(nb_lo, 1) * 1e6:.0f} us per batch); "
                  f"leftover share {t_lo / (t_cf + t_lo):.3f}", flush=True)
        del state
        gc.collect()

    # ---- 11. time each fused step and its plain version at B = W0 ----
    # `ms` and `plain_ms` are device times from CUDA graphs; the cold-L2
    # event reading and the back-to-back rate are printed beside them.
    # Both fused steps update copies of the planes in place.
    st = [copy(wc) for _ in range(4)]
    steps = dict(
        culsh_sgd=(lambda: sgd_kernel.culsh_sgd_batch(st[0], bt, hpv),
                   lambda: apply_culsh_sgd_ref(st[1], bt, hpv)),
        mf_sgd=(lambda: sgd_kernel.mf_sgd_batch(st[2], bt, hmf),
                lambda: apply_mf_sgd_ref(st[3], bt, hmf)))
    timed = {name: dict(ms=graph_ms(kern, dev), plain=graph_ms(pl, dev),
                        cold=median_ms(kern, dev),
                        b2b=back_to_back_ms(kern, dev))
             for name, (kern, pl) in steps.items()}
    del st
    # CULSH-MF bytes, per live slot (an invalid one reads nothing but its
    # mask): both plane rows read and written back, the [K] rows nb, rnb,
    # expl and the K neighbour baselines b̂[nb], and i, j, r; the masks and
    # hp.  CUSGD++, per live slot: u and v read and written back in place,
    # and i, j, r; the masks and hp.  Operations: the forward and the update
    # of one sample (14 per factor, 30 per neighbour slot, ~30 scalar for
    # CULSH-MF; ~10 for CUSGD++) per live slot
    n_live = int(bt.valid.sum())
    culsh_bound, culsh_by = bound_ms(
        4 * (n_live * (2 * (F + 1) + 2 * (F + 2 * K + 1) + 4 * K + 3) + W0
             + 13), n_live * (14 * F + 30 * K + 30))
    mf_bound, mf_by = bound_ms(4 * (n_live * (4 * F + 3) + W0 + 4),
                               n_live * (14 * F + 10))
    bounds = dict(culsh_sgd=(culsh_bound, culsh_by),
                  mf_sgd=(mf_bound, mf_by))
    what = dict(culsh_sgd="the fused in-place step (gathers, step, writes)",
                mf_sgd="the fused in-place CUSGD++ step (gathers, step, "
                       "writes)")
    for name, t in timed.items():
        bnd, by = bounds[name]
        print(f"[11 time] {name} at B={W0} ({n_live} live) F={F} K={K}, "
              f"{what[name]}: kernel {t['ms']:.5f} ms (CUDA graph of 50 "
              f"calls, median of 20 replays), {t['cold']:.4f} ms cold L2 "
              f"behind the scrub, {t['b2b']:.4f} ms per call back to back "
              f"(host-paced), {in_loop.get(name, float('nan')):.5f} ms per "
              f"launch in the profiled epoch; plain version "
              f"{t['plain']:.5f} ms (CUDA graph); bound {bnd:.5f} ms ({by}); "
              f"no single PyTorch call computes the fused step (power limit "
              f"{power})", flush=True)
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


def online_phase(args, ctx: dict, scfg, dev, on_card: bool,
                 power: str) -> dict:
    """Phase 15: online learning (paper Alg. 4) on phase 8's data.

    A seeded relabelling gives a random 1 % of users and 4 % of items the
    top ids; the old world (ids below M0, N0) is fitted, indexed and
    served; ΔΩ₁ (ids below M1, N1) and then ΔΩ₂ (the rest) arrive through
    `online_update` and `RecsysService.ingest_online_update` — the first
    into the index tail, the second by a synchronous rebuild — with
    every flush after them held against the plain versions.  → the
    state phase 16 goes on from."""
    import dataclasses

    from repro_torch import obs, prng
    from repro_torch.core import model, online, simlsh
    from repro_torch.core.sgd import Hyper
    from repro_torch.data.sparse import from_coo
    from repro_torch.kernels.candidate_score import kernel as score_kernel
    from repro_torch.kernels.candidate_score.ref import assert_topn_close
    from repro_torch.kernels.lsh_retrieve import kernel as lsh_kernel
    from repro_torch.kernels.lsh_retrieve.ops import retrieve_candidates
    from repro_torch.kernels.mf_sgd import kernel as sgd_kernel
    from repro_torch.resil import (DivergenceError, PoisonBatchError,
                                   validate_index)
    from repro_torch.serve import (RecsysService, build_index, full_topn,
                                   recommend_walked_kernel)
    from repro_torch.serve.index import _sig_of_items
    from repro_torch.train.trainer import fit

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t_phase = time.perf_counter()
    M, N = ctx["shape"]
    cfg = ctx["cfg"]
    lsh, K, B = cfg.lsh, cfg.K, scfg.micro_batch
    # the world split: a seeded relabelling, then cuts at 99 / 99.5 % of
    # the users and 96 / 98 % of the items
    rng = np.random.default_rng(0)
    perm_u = rng.permutation(M).astype(np.int32)
    perm_i = rng.permutation(N).astype(np.int32)
    relabel = lambda t: (perm_u[t[0]], perm_i[t[1]], t[2])
    tr, te = relabel(ctx["tr"]), relabel(ctx["te"])
    M0, M1 = int(M * 0.99), int(M * 0.995)
    N0, N1 = int(N * 0.96), int(N * 0.98)
    tail_cap = max(1, round(1024 * args.fit_scale))
    box = lambda t, m, n: (t[0] < m) & (t[1] < n)
    old, in1 = box(tr, M0, N0), box(tr, M1, N1)
    sel = lambda t, mask: tuple(a[mask] for a in t)
    d1, d2 = sel(tr, in1 & ~old), sel(tr, ~in1)
    print(f"[15 online] M0={M0} M1={M1} M2={M} N0={N0} N1={N1} N2={N}: old "
          f"world {int(old.sum())} ratings, dOmega1 {d1[0].size}, dOmega2 "
          f"{d2[0].size} ({(d1[0].size + d2[0].size) / tr[0].size:.4f} of "
          f"{tr[0].size}); tail_cap {tail_cap}", flush=True)

    # ---- the old world: fit (culsh_sgd counted), index, service ----
    t0 = time.perf_counter()
    sgd_kernel.CULSH_LAUNCHES = 0
    res = fit(sel(tr, old), sel(te, box(te, M0, N0)), (M0, N0), cfg,
              device=dev)
    culsh_launches = sgd_kernel.CULSH_LAUNCHES
    nb_cf = res.schedule_stats["nb_cf"]
    print(f"[15 online] old-world fit {time.perf_counter() - t0:.2f} s: "
          f"rmse {[round(h[2], 6) for h in res.history]}, culsh_sgd_step "
          f"launches {culsh_launches} = {nb_cf} conflict-free steps x "
          f"{cfg.epochs} epochs, compile_seconds {res.compile_seconds:.3f}",
          flush=True)
    if on_card and culsh_launches != nb_cf * cfg.epochs:
        raise AssertionError(f"culsh_sgd_step launched {culsh_launches} "
                             f"times in the old-world fit")
    sp0 = from_coo(*sel(tr, old), (M0, N0), device=dev)
    st0 = online.OnlineState(params=res.params, S=res.S, JK=res.JK, sp=sp0,
                             M=M0, N=N0, hash_key=res.hash_key)
    # adopt 2 measures the synchronous rebuild (phase 16 the background
    # one)
    svc = RecsysService(st0.params, build_index(
        simlsh.pack_bits(st0.S >= 0), tail_cap=tail_cap, device=dev), sp0,
        dataclasses.replace(scfg, background_rebuild=False), device=dev)
    svc.warmup()

    def update(st, d, M_new, N_new, key, hp=cfg.hp, reg=None):
        return online.online_update(st, *d, lsh, hp, key, M_new=M_new,
                                    N_new=N_new, K=K, epochs=3, batch=4096,
                                    registry=reg)

    def frozen(p_new, p_old, m, n):
        return all(torch.equal(getattr(p_new, f)[:m if f in ("U", "b") else n],
                               getattr(p_old, f))
                   for f in ("U", "b", "V", "bh", "W", "C"))

    def signature_rule(st):
        """Incremental S and signatures against a fresh encode of the
        merged Ω̂, by the JAX package's rule (`tests/test_online.py`: S
        within rtol 1e-4 / atol 1e-3, bits equal wherever |S_fresh| ≥
        1e-3) with its atol widened by each column's float32 summation
        noise, 8·2⁻²⁴·√(n·Σψ²) for n ratings of weights ψ: a sum in
        another order differs by about 2⁻²⁴·√n times its partial sums'
        size, √(Σψ²) for ±ψ terms, which the rule's 1e-3 covers only at
        its test's size.  → (max |S − S_fresh|, elements outside the
        unwidened rule, largest widening, flipped bits)."""
        fresh_sigs, S_fresh = simlsh.encode(st.sp, lsh, st.hash_key,
                                            return_accumulators=True)
        w = simlsh.psi(st.sp.vals, lsh.psi_pow, lsh.psi_mode,
                       lsh.psi_center).double()
        cols = st.sp.cols.long()
        n = torch.zeros(st.N, dtype=torch.float64, device=dev).index_add_(
            0, cols, torch.ones_like(w))
        w2 = torch.zeros(st.N, dtype=torch.float64, device=dev).index_add_(
            0, cols, w * w)
        noise = (8 * 2.0 ** -24 * torch.sqrt(n * w2)).float()[None, :, None]
        err = (st.S - S_fresh).abs()
        limit = 1e-3 + 1e-4 * S_fresh.abs()
        outside = int((err > limit).sum())
        if bool((err > limit + noise).any()):
            raise AssertionError(f"S is off a fresh encode beyond the "
                                 f"summation noise: max abs err "
                                 f"{float(err.max()):.3g}")
        sigs = simlsh.pack_bits(st.S >= 0)
        near0 = S_fresh.abs() < 1e-3 + noise
        flips = 0
        for b in range(lsh.sig_bits):
            diff = ((sigs >> b) & 1) != ((fresh_sigs >> b) & 1)
            if bool((diff & ~near0[..., b]).any()):
                raise AssertionError(f"signature bit {b} differs where the "
                                     f"fresh accumulator is not near 0")
            flips += int(diff.sum())
        return float(err.max()), outside, float(noise.max()), flips

    def rmse_new(p, st, m_lo, n_lo, m_hi, n_hi):
        """Test RMSE over the ratings that touch an id ≥ (m_lo, n_lo) inside
        the (m_hi, n_hi) box."""
        mask = (box(te, m_hi, n_hi) & ((te[0] >= m_lo) | (te[1] >= n_lo)))
        r, c, v = (torch.as_tensor(a[mask], device=dev) for a in te)
        return float(model.rmse(p, st.sp, st.JK, r, c, v)), int(mask.sum())

    # ---- update 1: ΔΩ₁ → (M1, N1) ----
    key1 = prng.PRNGKey(args.seed + 15)
    reg = obs.Registry(enabled=True)
    st1 = update(st0, d1, M1, N1, key1, reg=reg)
    if not frozen(st1.params, st0.params, M0, N0):
        raise AssertionError("update 1 changed an old parameter")
    if not torch.equal(st1.JK[:N0], st0.JK):
        raise AssertionError("update 1 changed an old column's J^K")
    s_err, outside, widest, flips = signature_rule(st1)
    untrained = online.grow_params(st0.params, M1, N1, prng.split(key1, 3)[0])
    r_tr, n_te = rmse_new(st1.params, st1, M0, N0, M1, N1)
    r_un, _ = rmse_new(untrained, st1, M0, N0, M1, N1)
    del untrained
    print(f"[15 update 1] stats {st1.stats}; old slices and J^K[:N0] bit "
          f"for bit; S vs a fresh encode max abs err {s_err:.3g} ("
          f"{outside} of {st1.S.numel()} outside rtol 1e-4 / atol 1e-3, "
          f"all within it plus the column's summation noise, at most "
          f"{widest:.3g}), {flips} signature bits differ (all near 0); "
          f"rmse on the {n_te} test "
          f"ratings touching new ids: trained {r_tr:.6f}, untrained "
          f"{r_un:.6f}; guard trips {reg.counter('online.guard_trips'):.0f}",
          flush=True)
    if not r_tr < r_un:
        raise AssertionError("update 1 did not lower the new ids' RMSE")

    # ---- adopt 1: the new items go to the index tail ----
    svc.ingest_online_update(st1, N_old=N0)
    if (svc.index.tail_fill, svc.index.n_base) != (N1 - N0, N0):
        raise AssertionError(f"after adopt 1 the index holds n_base "
                             f"{svc.index.n_base}, tail {svc.index.tail_fill}")
    if svc.obs.span_durations("serve.ingest.rebuild"):
        raise AssertionError("adopt 1 rebuilt the index")
    new_ids = torch.arange(N0, N1, dtype=torch.int32, device=dev)
    if not torch.equal(_sig_of_items(svc.index, new_ids),
                       simlsh.pack_bits(st1.S[:, N0:N1] >= 0)):
        raise AssertionError("the tail's signatures are not the re-signed "
                             "columns")
    adopt1_s = svc.stats()["ingest_to_servable_s"]
    kw = dict(n_seeds=scfg.n_seeds, cap=scfg.cap, C=scfg.C,
              window=scfg.seed_window, topn=scfg.topn, tile_b=scfg.tile_b)

    def serve_and_check(n_flushes, M_old, M_new, tag):
        """``n_flushes`` flushes of B users, half of them new (ids in
        [M_old, M_new)), counters zeroed just before and read just after;
        then each flush against the plain versions on the same users:
        candidates bit for bit, top-N by `assert_topn_close` (1e-5).
        → (launches, max abs score err, items, candidate slots holding an
        id ≥ N0)."""
        batches = [np.concatenate([rng.integers(0, M_old, B - B // 2),
                                   rng.integers(M_old, M_new, B // 2)])
                   .astype(np.int32) for _ in range(n_flushes)]
        lsh_kernel.LAUNCHES = 0
        score_kernel.LAUNCHES = 0
        for users in batches:
            svc.submit(users)
        svc.flush()
        launches = dict(lsh_retrieve=lsh_kernel.LAUNCHES,
                        candidate_score=score_kernel.LAUNCHES)
        results = svc.take_results()
        if on_card and any(n != n_flushes for n in launches.values()):
            raise AssertionError(f"{tag}: launches {launches} in "
                                 f"{n_flushes} flushes")
        if svc.stats()["fallbacks"]:
            raise AssertionError(f"{tag}: a flush fell back to full_topn")
        err, cand_new = 0.0, 0
        tail_on = svc.index.tail_fill > 0
        for users, (u, s, i) in zip(batches, results):
            ids = torch.from_numpy(users).to(dev)
            args_ = (svc.index, svc.sp, ids)
            ckw = dict(n_seeds=kw["n_seeds"], cap=kw["cap"], C=kw["C"],
                       popular=svc.popular, window=kw["window"],
                       tail_scan=tail_on, ids_flat=svc._flat_ids())
            cand = retrieve_candidates(*args_, **ckw)
            if not torch.equal(cand, retrieve_candidates(*args_, impl="ref",
                                                         **ckw)):
                raise AssertionError(f"{tag}: lsh_retrieve differs from its "
                                     f"plain version")
            cand_new += int(((cand >= N0) & (cand < N)).sum())
            s_ref, i_ref = recommend_walked_kernel(
                svc.planes, svc.index, svc.sp, ids, svc.popular,
                svc._flat_ids(), tail_scan=tail_on, impl="ref", **kw)
            err = max(err, assert_topn_close(s, i, s_ref, i_ref))
        items = np.concatenate([r[2] for r in results])
        return launches, err, items, cand_new

    launches1, err1, items1, cand1 = serve_and_check(BATCHES, M0, M1,
                                                     "adopt 1")
    st = svc.stats()
    served_new = int(((items1 >= N0) & (items1 < N1)).sum())
    probe = rng.integers(0, M1, PROBE).astype(np.int32)
    svc.submit(probe)
    svc.flush()
    got_p = np.concatenate([r[2] for r in svc.take_results()])
    exact = np.concatenate([
        full_topn(svc.params, torch.from_numpy(probe[i:i + B]).to(dev),
                  topn=scfg.topn)[1].cpu().numpy()
        for i in range(0, PROBE, B)])
    recall = sum(len(set(g) & set(e))
                 for g, e in zip(got_p, exact)) / exact.size
    is_new = lambda a: int(((a >= N0) & (a < N1)).sum())
    print(f"[15 adopt 1] {N1 - N0} items into the tail in {adopt1_s:.4f} s "
          f"(ingest_to_servable_s); {BATCHES} flushes of {B} users (half "
          f"new): {st['qps']:.0f} users/s, p50 {st['p50_ms']:.3f} ms, p99 "
          f"{st['p99_ms']:.3f} ms; launches {launches1}; every flush within "
          f"1e-5 of the plain versions (max abs err {err1:.3g}), candidates "
          f"bit for bit; new items fill {cand1} candidate slots and "
          f"{served_new} served slots; recall@{scfg.topn} {recall:.4f} vs "
          f"full_topn on {PROBE} probe users, whose exact top-{scfg.topn} "
          f"holds {is_new(exact)} new items and served {is_new(got_p)} "
          f"(power limit {power})", flush=True)
    # the walk must reach the tail; whether a new item ranks in a top-N
    # is the model's answer, which full_topn holds the service to
    if not cand1:
        raise AssertionError("no new item reached the candidates")
    if not recall >= 0.5:
        raise AssertionError(f"recall@10 {recall:.4f} below 0.5")
    if on_card:          # where a flush with a 600-item tail spends its time
        profile_flushes(svc, [np.concatenate([
            rng.integers(0, M0, B - B // 2), rng.integers(M0, M1, B // 2)])
            .astype(np.int32) for _ in range(PROFILED)], tag="15 profile")

    # ---- update 2 and adopt 2: the tail overflows → synchronous rebuild ----
    st2 = update(st1, d2, M, N, prng.PRNGKey(args.seed + 16), reg=reg)
    if not frozen(st2.params, st1.params, M1, N1):
        raise AssertionError("update 2 changed an old parameter")
    svc.ingest_online_update(st2, N_old=N1)
    full = simlsh.pack_bits(st2.S >= 0)
    want = build_index(full, tail_cap=tail_cap, device=dev)
    if (svc.index.tail_fill, svc.index.n_base) != (0, N):
        raise AssertionError("adopt 2 did not rebuild the index")
    for f in ("sorted_sigs", "sorted_ids", "bucket_lo", "bucket_hi",
              "slot_of"):
        if not torch.equal(getattr(svc.index, f), getattr(want, f)):
            raise AssertionError(f"the rebuilt index's {f} differs from "
                                 f"build_index(full_sigs)")
    # the structural invariants must hold; the recall smoke (every probe
    # item among the first 4 slots of its own bucket) is exact only while
    # buckets hold at most 4 items, which the fit's 8-bit bands exceed,
    # so it must merely say of the rebuilt index what it says of a fresh
    # build_index of the same signatures
    probs = validate_index(svc.index, probe=0)
    if probs:
        raise AssertionError(f"validate_index: {probs}")
    smoke = validate_index(svc.index)
    if smoke != validate_index(want):
        raise AssertionError(f"validate_index's recall smoke differs from a "
                             f"fresh build's: {smoke}")
    biggest = int((svc.index.bucket_hi - svc.index.bucket_lo).max())
    rebuild_s = svc.obs.span_durations("serve.ingest.rebuild")[-1]
    adopt2_s = svc.stats()["ingest_to_servable_s"]
    launches2, err2, _, _ = serve_and_check(16, M1, M, "adopt 2")
    print(f"[15 adopt 2] update 2 stats {st2.stats}; {N - N1} more items "
          f"overflow the tail: synchronous rebuild {rebuild_s:.4f} s, "
          f"ingest_to_servable_s {adopt2_s:.4f}; the index equals "
          f"build_index(full_sigs) and passes validate_index's structural "
          f"checks; its recall smoke (cap 4; largest bucket {biggest} "
          f"items) says {smoke or 'nothing'}, as of a fresh build; "
          f"16 flushes: "
          f"launches {launches2}, within 1e-5 of the plain versions (max "
          f"abs err {err2:.3g})", flush=True)

    # ---- poison and rollback: each refused, the service serves on ----
    probe_users = np.arange(0, M, max(1, M // B), dtype=np.int32)[:B]

    def answers():
        svc.submit(probe_users)
        svc.flush()
        (_, s, i), = svc.take_results()
        return s, i

    s_before, i_before = answers()
    bad = tuple(a[:64].copy() for a in d2)
    bad[2][7] = np.nan
    refusals = []
    try:
        update(st2, bad, M, N, prng.PRNGKey(1))
    except PoisonBatchError as e:
        refusals.append(f"NaN rating: {e}"[:90])
    g = np.random.default_rng(1)
    grow = (np.repeat(np.arange(M, M + 100), 20).astype(np.int32),
            g.integers(0, N + 10, 2000).astype(np.int32),
            g.uniform(1, 5, 2000).astype(np.float32))
    hot = Hyper(**{f.name: getattr(cfg.hp, f.name) * (1e4 if f.name[:2] ==
                                                      "a_" else 1)
                   for f in dataclasses.fields(Hyper)})
    try:
        update(st2, grow, M + 100, N + 10, prng.PRNGKey(2), hp=hot)
    except DivergenceError as e:
        refusals.append(f"learning rates x1e4: {e}"[:90])
    S_bad = st2.S.clone()
    S_bad[3, N1 + 5, 2] = float("nan")
    q0 = svc.stats()["quarantined"]
    try:
        svc.ingest_online_update(dataclasses.replace(st2, S=S_bad), N_old=N1)
    except PoisonBatchError as e:
        refusals.append(f"NaN accumulator: {e}"[:90])
    del S_bad
    s_after, i_after = answers()
    print(f"[15 poison] {len(refusals)} of 3 refused: "
          + " | ".join(refusals) + f"; quarantined {q0} -> "
          f"{svc.stats()['quarantined']}; the probe flush after them equals "
          f"the one before: {np.array_equal(i_after, i_before)}", flush=True)
    if len(refusals) != 3 or svc.stats()["quarantined"] != q0 + 1:
        raise AssertionError("a poison or divergence case was not refused")
    if not (np.array_equal(i_after, i_before)
            and np.array_equal(s_after, s_before)):
        raise AssertionError("the service does not serve its prior state")

    # ---- micro_epoch over the merged Ω̂ (the plain packed steps) ----
    te_r, te_c, te_v = (torch.as_tensor(a, device=dev) for a in te)
    before = float(model.rmse(st2.params, st2.sp, st2.JK, te_r, te_c, te_v))
    mreg = obs.Registry(enabled=True)
    st3 = online.micro_epoch(st2, cfg.hp, prng.PRNGKey(args.seed + 17),
                             epoch=cfg.epochs, registry=mreg)
    after = float(model.rmse(st3.params, st3.sp, st3.JK, te_r, te_c, te_v))
    if not (st3.S is st2.S and st3.JK is st2.JK and st3.sp is st2.sp):
        raise AssertionError("micro_epoch did not share S, J^K and Omega")
    print(f"[15 micro] schedule build "
          f"{mreg.span_durations('online.micro.schedule')[-1]:.3f} s, one "
          f"micro-epoch over {st2.sp.nnz} ratings "
          f"{mreg.span_durations('online.micro')[-1]:.3f} s; test rmse "
          f"{before:.6f} -> {after:.6f} ({te_v.numel()} ratings)", flush=True)
    if not np.isfinite(after):
        raise AssertionError("the micro-epoch diverged")
    del st3

    # ---- determinism: update 1 again from the same inputs ----
    again = update(st0, d1, M1, N1, key1)
    diffs = [float((getattr(again.params, f) - getattr(st1.params, f))
                   .abs().max()) for f in ("U", "b", "V", "bh", "W", "C")]
    same = all(torch.equal(getattr(again.params, f), getattr(st1.params, f))
               for f in ("U", "b", "V", "bh", "W", "C"))
    same_S = torch.equal(again.S, st1.S)
    print(f"[15 determinism] update 1 run twice: bit-identical {same}, max "
          f"abs diff {max(diffs):.3g} (S equal: {same_S})", flush=True)
    if not (same and same_S and torch.equal(again.JK, st1.JK)):
        raise AssertionError("update 1 run twice is not bit-identical")
    if svc.stats()["fallbacks"]:
        raise AssertionError("a phase-15 flush fell back to full_topn")
    del again, st0, st1, res
    gc.collect()
    sync()
    print(f"[15 online] phase seconds {time.perf_counter() - t_phase:.1f}",
          flush=True)
    return dict(st=st2, te=te, hp=cfg.hp, lsh=lsh, K=K, svc=svc)


def resil_phase(args, octx: dict, serve: dict, dev, on_card: bool,
                power: str) -> dict:
    """Phase 16: resilience on the card.  On phase 15's online state (the
    fit's model at full width) an `OnlineUpdater` logs and applies three
    ΔΩ, crashes on the third after logging it, and `recover` must equal
    an uninterrupted updater leaf for leaf.  On phase 3's N = 10⁶ catalog
    with a 1,024-item tail: overload shedding, deadline shedding under a
    stall, the ``fallback_full`` path, a background rebuild behind the
    validation gate while flushes go on, and a corrupt build that is
    refused.  → the `segment_add` entry of the kernels line."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch import obs, prng
    from repro_torch.core import scatter
    from repro_torch.core.model import Params
    from repro_torch.kernels.candidate_score import kernel as score_kernel
    from repro_torch.kernels.candidate_score.ref import assert_topn_close
    from repro_torch.kernels.lsh_retrieve import kernel as lsh_kernel
    from repro_torch.resil import OnlineUpdater, faults, validate_index, wal
    from repro_torch.resil.faults import FaultSpec, InjectedFault
    from repro_torch.serve import (RecsysService, build_index, full_topn,
                                   recommend_walked_kernel)
    from repro_torch.serve.index import signatures_of

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t_phase = time.perf_counter()
    st, te = octx["st"], octx["te"]
    lsh, hp, K = octx["lsh"], octx["hp"], octx["K"]
    rng = np.random.default_rng(args.seed + 16)

    # ---- the write-ahead log: three deltas, a crash, recovery ----
    def deltas():
        """Three ΔΩ: a third of the test ratings each, plus new users
        rating 20 items each and new items rated by 20 old users each."""
        out, M_, N_ = [], st.M, st.N
        n_u = max(1, round(100 * args.fit_scale))
        n_i = max(1, round(50 * args.fit_scale))
        for k, part in enumerate(np.array_split(np.arange(te[0].size), 3)):
            M2, N2 = M_ + n_u, N_ + n_i
            r = np.concatenate([np.repeat(np.arange(M_, M2), 20),
                                rng.integers(0, M_, 20 * n_i)])
            c = np.concatenate([rng.integers(0, N2, 20 * n_u),
                                np.repeat(np.arange(N_, N2), 20)])
            key = np.unique(r.astype(np.int64) * N2 + c)
            r, c = key // N2, key % N2
            d = (np.concatenate([te[0][part], r]).astype(np.int32),
                 np.concatenate([te[1][part], c]).astype(np.int32),
                 np.concatenate([te[2][part], rng.integers(1, 6, r.size)])
                 .astype(np.float32))
            out.append((d, M2, N2, prng.PRNGKey(args.seed + 160 + k)))
            M_, N_ = M2, N2
        return out

    ds = deltas()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke-wal-",
                            dir=os.path.join(ROOT, "build"))
    kw = dict(K=K, epochs=3, batch=4096, ckpt_every=2)
    host = lambda x: (x.cpu() if isinstance(x, torch.Tensor)
                      else torch.from_numpy(np.asarray(x)))
    try:
        reg = obs.Registry(enabled=True)
        crash_dir = os.path.join(root, "crash")
        scatter.LAUNCHES = 0       # the main path: updates, crash, recovery
        up = OnlineUpdater(st, lsh, hp, root=crash_dir, registry=reg, **kw)
        crashed = False
        for k, (d, M2, N2, key) in enumerate(ds):
            if k < 2:
                up.update(*d, key, M_new=M2, N_new=N2)
                continue
            with faults.injected({"online.update":
                                  FaultSpec(at_calls=(0,))}):
                try:
                    up.update(*d, key, M_new=M2, N_new=N2)
                except InjectedFault:
                    crashed = True
        sync()
        wal_bytes = [os.path.getsize(up.wal._path(q)) for q in up.wal.seqs()]
        shard = os.path.join(crash_dir, "ckpt", "step-00000002", "shard-0.npz")
        ckpt_mb = os.path.getsize(shard) / 1e6
        t0 = time.perf_counter()
        rec = OnlineUpdater.recover(crash_dir, lsh, hp, device=dev,
                                    registry=reg, **kw)
        sync()
        recover_s = time.perf_counter() - t0
        seg_launches = scatter.LAUNCHES
        whole = OnlineUpdater(st, lsh, hp, root=os.path.join(root, "whole"),
                              **kw)
        for d, M2, N2, key in ds:
            whole.update(*d, key, M_new=M2, N_new=N2)
        ta, tb = wal.state_tree(rec.state), wal.state_tree(whole.state)
        unequal = [k for k in ta if not torch.equal(host(ta[k]),
                                                    host(tb[k]))]
        spans = {n: reg.span_durations(n) for n in (
            "resil.wal.append", "resil.ckpt", "resil.wal.replay")}
        print(f"[16 wal] M={st.M} N={st.N} F={st.params.U.shape[1]} K={K}: "
              f"3 deltas of " + "/".join(str(d[0].size) for d, *_ in ds)
              + f" ratings (to M={ds[-1][1]} N={ds[-1][2]}), ckpt_every=2, "
              f"a crash at online.update on the 3rd: WAL appends "
              + ", ".join(f"{x:.4f}" for x in spans["resil.wal.append"])
              + f" s, the unpruned entry {wal_bytes} bytes; checkpoint "
              f"{ckpt_mb:.1f} MB in "
              + ", ".join(f"{x:.3f}" for x in spans["resil.ckpt"])
              + f" s; recover {recover_s:.3f} s (replay "
              + ", ".join(f"{x:.3f}" for x in spans["resil.wal.replay"])
              + f" s) to seq {rec.seq}; {len(ta) - len(unequal)} of "
              f"{len(ta)} leaves equal the uninterrupted updater's "
              f"(torch.equal); segment_add launches {seg_launches}",
              flush=True)
        if not crashed or rec.seq != 3 or wal_bytes == [] or unequal:
            raise AssertionError(f"WAL recovery: crashed {crashed}, seq "
                                 f"{rec.seq}, unequal leaves {unequal}")
        if on_card and not seg_launches:
            raise AssertionError("segment_add never launched on the main "
                                 "path")

        # the kernel against its plain version at the online step's shape:
        # one batch of 4,096 ΔΩ columns scattered into V
        jv = torch.as_tensor(ds[0][0][1][:4096], device=dev).long()
        V = whole.state.params.V
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        src = 1e-3 * torch.randn((jv.numel(), V.shape[1]), generator=gen,
                                 device=dev)
        want = V.to("cpu", copy=True).index_add_(0, jv.cpu(), src.cpu())
        got = scatter.index_add_det_(V.clone(), jv, src)
        if not torch.equal(got.cpu(), want):
            raise AssertionError("segment_add differs from the CPU's "
                                 "index_add_")
        seg_err = float((got.cpu() - want).abs().max())
        atomic_err = float((V.clone().index_add_(0, jv, src) - got).abs()
                           .max())
        Vk, Vp = V.clone(), V.clone()
        seg_ms = graph_ms(lambda: scatter.index_add_det_(Vk, jv, src), dev)
        seg_cold = median_ms(lambda: scatter.index_add_det_(Vk, jv, src),
                             dev)
        plan = scatter.segment_plan(jv)
        kern_ms = graph_ms(lambda: scatter.index_add_det_(Vk, jv, src,
                                                          plan=plan), dev)
        plain_ms = graph_ms(lambda: Vp.index_add_(0, jv, src), dev)
        uniq = int(torch.unique(jv).numel())
        n, w = jv.numel(), V.shape[1]
        # bytes: the ids and src read once, each touched dst row read and
        # written once; operations: one add per src element
        seg_bound, seg_by = bound_ms(8 * n + 4 * n * w + 2 * 4 * uniq * w,
                                     n * w)
        print(f"[16 time] segment_add at n={n} ({uniq} distinct ids) "
              f"width={w} into V [{V.shape[0]}, {w}]: equal to the CPU's "
              f"index_add_ bit for bit (the card's atomic index_add_ is off "
              f"by up to {atomic_err:.3g}); with its sort {seg_ms:.5f} ms "
              f"(CUDA graph of 50 calls, median of 20 replays), "
              f"{seg_cold:.4f} ms cold L2; the kernel alone (sort reused) "
              f"{kern_ms:.5f} ms; index_add_ (the plain version and the "
              f"library call) {plain_ms:.5f} ms; bound {seg_bound:.5f} ms "
              f"({seg_by}) (power limit {power})", flush=True)
        del up, rec, whole, ta, tb, V, Vk, Vp, got, want
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()

    # ---- serving: the N = 10⁶ catalog with a 1,024-item tail ----
    params, sp, sigs, scfg = (serve[k] for k in ("params", "sp", "sigs",
                                                 "cfg"))
    B, M, N = scfg.micro_batch, sp.M, sp.N
    index_v = build_index(sigs, tail_cap=1024, device=dev)
    smoke = validate_index(index_v)
    biggest = int((index_v.bucket_hi - index_v.bucket_lo).max())
    print(f"[16 gate] validate_index on a fresh build_index of the N={N} "
          f"catalog (largest bucket {biggest} items): "
          f"{smoke or 'passes'}", flush=True)
    users_of = lambda n: rng.integers(0, M, n).astype(np.int32)
    pkw = dict(n_seeds=scfg.n_seeds, cap=scfg.cap, C=scfg.C,
               window=scfg.seed_window, topn=scfg.topn, tile_b=scfg.tile_b)

    def check_plain(svc, users, s, i):
        """A flush's answers against the plain versions on the same
        users and index → max abs score error."""
        s_ref, i_ref = recommend_walked_kernel(
            svc.planes, svc.index, svc.sp, torch.from_numpy(users).to(dev),
            svc.popular, svc._flat_ids(), tail_scan=svc.index.tail_fill > 0,
            impl="ref", **pkw)
        return assert_topn_close(s, i, s_ref, i_ref)

    def service(p=params, **kw):
        return RecsysService(p, index_v, sp, dataclasses.replace(scfg, **kw),
                             device=dev).warmup()

    def zero():
        lsh_kernel.LAUNCHES = score_kernel.LAUNCHES = 0

    def launches():
        return (lsh_kernel.LAUNCHES, score_kernel.LAUNCHES)

    # overload: a burst of 16 micro-batches against a bound of 4
    svc = service(max_pending=4 * B)
    burst = users_of(16 * B)
    zero()
    svc.submit(burst)
    svc.flush()
    so, n_o = svc.stats(), launches()
    res = svc.take_results()
    busy = svc.obs.counter("serve.busy_seconds")
    pop = svc.popular[:scfg.topn].cpu().numpy()
    degraded_ok = (len(res) == 5 and res[0][0].size == 12 * B
                   and (res[0][2] == pop).all())
    err_o = max(check_plain(svc, *r) for r in res[-4:])
    print(f"[16 overload] {16 * B} users against max_pending {4 * B}: shed "
          f"{so['shed']}, degraded {so['degraded']}, dropped {so['dropped']}, "
          f"fallbacks {so['fallbacks']}; {so['qps']:.0f} users/s answered "
          f"(degraded included), {4 * B / busy:.0f} users/s scored; p50 "
          f"{so['p50_ms']:.3f} ms, p99 {so['p99_ms']:.3f} ms over "
          f"{so['batches']} flushes; launches {n_o}; answers in submission "
          f"order; the 4 scored flushes within 1e-5 of the plain versions "
          f"(max abs err {err_o:.3g})", flush=True)
    if (so["shed"], so["degraded"], so["dropped"], so["fallbacks"]) != (
            12 * B, 12 * B, 0, 0):
        raise AssertionError(f"overload: {so}")
    if not np.array_equal(np.concatenate([r[0] for r in res]), burst):
        raise AssertionError("overload: answers out of submission order")
    if not degraded_ok:
        raise AssertionError("overload: the shed users did not get the "
                             "popularity answer")
    if on_card and n_o != (4, 4):
        raise AssertionError(f"overload: launches {n_o}")
    del svc, res

    # deadline: the first flush stalls 0.2 s; the rest wait past 0.05 s
    svc = service(deadline_s=0.05)
    users = users_of(4 * B)
    with faults.injected({"serve.flush": FaultSpec(kind="stall", stall_s=0.2,
                                                   at_calls=(0,))}):
        svc.submit(users)
        svc.flush()
    sd_ = svc.stats()
    res = svc.take_results()
    print(f"[16 deadline] {4 * B} users, deadline 0.05 s, a 0.2 s stall "
          f"injected at serve.flush: shed {sd_['shed']}, degraded "
          f"{sd_['degraded']}, fallbacks {sd_['fallbacks']}; p50 "
          f"{sd_['p50_ms']:.3f} ms over {sd_['batches']} scored flush(es)",
          flush=True)
    if (sd_["shed"], sd_["degraded"], sd_["fallbacks"]) != (3 * B, 3 * B, 0):
        raise AssertionError(f"deadline: {sd_}")
    if not np.array_equal(np.concatenate([r[0] for r in res]), users):
        raise AssertionError("deadline: answers out of submission order")
    del svc, res

    # fallback: flushes 1 and 3 raise at dispatch → exact full_topn
    svc = service()
    users = users_of(4 * B)
    zero()
    with faults.injected({"serve.flush": FaultSpec(at_calls=(1, 3))}):
        svc.submit(users)
        svc.flush()
    sf, n_f = svc.stats(), launches()
    res = svc.take_results()
    err_f = err_k = 0.0
    for k, (u, s, i) in enumerate(res):
        if k in (1, 3):
            s_x, i_x = full_topn(svc.params, torch.from_numpy(u).to(dev),
                                 topn=scfg.topn)
            err_f = max(err_f, assert_topn_close(s, i, s_x, i_x))
        else:
            err_k = max(err_k, check_plain(svc, u, s, i))
    print(f"[16 fallback] serve.flush raised at flushes 1 and 3 of 4: "
          f"fallbacks {sf['fallbacks']}, launches {n_f}; those rows equal "
          f"full_topn (max abs err {err_f:.3g}), the others the plain "
          f"versions ({err_k:.3g})", flush=True)
    if sf["fallbacks"] != 2 or (on_card and n_f != (2, 2)):
        raise AssertionError(f"fallback: {sf['fallbacks']} fallbacks, "
                             f"launches {n_f}")
    del svc, res

    # background rebuild: 1,100 new items (clones of items 0–1,099)
    # overflow the 1,024-slot tail.  The worker builds v+1 on its stream
    # while the first flushes run, then waits at serve.rebuild.index (a
    # hook that hands the index on unchanged) until the 32nd flush has
    # been dispatched, so all 32 run on index v with a rebuild in flight
    n_new = 1100
    src_items = torch.arange(n_new, device=dev)
    grow = lambda t: torch.cat([t, t[src_items]])
    params_g = Params(U=params.U, V=grow(params.V), b=params.b,
                      bh=grow(params.bh), W=grow(params.W), C=grow(params.C),
                      mu=params.mu)
    new_sigs = sigs[:, src_items].contiguous()
    full = torch.cat([sigs, new_sigs], dim=1)
    new_ids = torch.arange(N, N + n_new, dtype=torch.int32, device=dev)
    svc = service(params_g)
    v = svc.index
    go, held = threading.Event(), []

    def hold(idx):
        t_h = time.perf_counter()
        go.wait(600)
        held.append(time.perf_counter() - t_h)
        return idx

    with faults.injected({"serve.rebuild.index": FaultSpec(
            kind="corrupt", mutate=hold, at_calls=(0,))}):
        try:
            t0 = time.perf_counter()
            svc.ingest(new_sigs, new_ids, full_sigs=full)
            ingest_call_s = time.perf_counter() - t0
            if not (svc.stats()["index_stale"] and svc.index is v):
                raise AssertionError("the overflow did not go to the "
                                     "background")
            zero()
            on_v = 0
            for _ in range(32):
                svc.submit(users_of(B))
                on_v += svc.index is v
            svc.flush()
        finally:
            go.set()
        sb, n_b = svc.stats(), launches()
        lat = svc.obs.span_durations("serve.flush")[-32:]
        slow = int(np.argmax(lat))
        svc.take_results()
        svc._rebuilder.join(600)
    svc.submit(users_of(B))            # the swap lands at a loop edge
    svc.flush()
    swapped = svc.index is not v
    after = svc.stats()
    built = svc.obs.span_durations("serve.rebuild.bg")
    valid_s = svc.obs.span_durations("serve.rebuild.bg.validate")
    if swapped:
        want_ids = build_index(full, tail_cap=1024, device=dev).sorted_ids
        if not torch.equal(svc.index.sorted_ids, want_ids):
            raise AssertionError("the swapped index is not build_index(full)")
        (u, s, i), = svc.take_results()
        err_b = check_plain(svc, u, s, i)
        print(f"[16 rebuild] {n_new} new items overflow the 1,024-slot "
              f"tail: ingest returned in {ingest_call_s:.4f} s; {on_v} of 32 "
              f"flushes ran on index v while the worker built v+1 and then "
              f"held it before validation: p50 {sb['p50_ms']:.3f} ms, p99 "
              f"{sb['p99_ms']:.3f} ms (phase 5: {serve['p5'][0]:.3f} / "
              f"{serve['p5'][1]:.3f} ms; the slowest is flush {slow} at "
              f"{lat[slow] * 1e3:.3f} ms), launches {n_b}; on the worker's "
              f"stream: build + validate {built[-1] - held[0]:.4f} s "
              f"(validate {valid_s[-1]:.4f} s) besides the {held[0]:.4f} s "
              f"hold; swapped: ingest_to_servable_s "
              f"{after['ingest_to_servable_s']:.4f} (the hold included; "
              f"{after['ingest_to_servable_s'] - held[0]:.4f} without it), "
              f"n_items {svc.index.n_items}, the index equals "
              f"build_index(full), the next flush within 1e-5 of the plain "
              f"versions ({err_b:.3g}) (power limit {power})", flush=True)
        if svc.index.n_items != N + n_new or after["index_stale"]:
            raise AssertionError("the swap did not land")
    else:
        print(f"[16 rebuild] {n_new} new items overflow the tail; the "
              f"validation gate refused every build ({smoke}): rolled back, "
              f"index v serves on (gave_up "
              f"{svc.obs.counter('serve.rebuild.gave_up'):.0f})", flush=True)
    if bool(smoke) == swapped:
        raise AssertionError("the rebuild's outcome disagrees with the "
                             "gate's verdict on a fresh build")
    if on_v != 32:
        raise AssertionError(f"only {on_v} of 32 flushes ran on index v")
    if after["fallbacks"] or (on_card and n_b != (32, 32)):
        raise AssertionError(f"rebuild: fallbacks {after['fallbacks']}, "
                             f"launches {n_b}")
    del svc

    # a corrupt build is refused by the gate, retried, given up on
    svc = service(params_g)
    v = svc.index
    bad = []

    def corrupt(idx):
        ids = idx.sorted_ids.clone()
        ids[0, 0] = ids[0, 1]
        bad.append(dataclasses.replace(idx, sorted_ids=ids))
        return bad[-1]

    with faults.injected({"serve.rebuild.index": FaultSpec(
            kind="corrupt", mutate=corrupt, at_calls=(0, 1, 2))}):
        svc.ingest(new_sigs, new_ids, full_sigs=full)
        served = []
        for _ in range(6):
            svc._rebuilder.join(600)
            users = users_of(B)
            svc.submit(users)
            svc.flush()
            served += [svc.index is b for b in bad]
    (u, s, i), = svc.take_results()[-1:]
    err_c = check_plain(svc, u, s, i)
    sc = svc.stats()
    print(f"[16 corrupt] serve.rebuild.index corrupted 3 builds: "
          f"failures {svc._rebuilder.failures}, gave_up "
          f"{svc.obs.counter('serve.rebuild.gave_up'):.0f}; index v served "
          f"throughout (a corrupt index never served), index_stale "
          f"{sc['index_stale']}, fallbacks {sc['fallbacks']}; the last flush "
          f"within 1e-5 of the plain versions on v ({err_c:.3g})", flush=True)
    if (svc._rebuilder.failures != 3 or any(served) or svc.index is not v
            or sc["fallbacks"]):
        raise AssertionError("a corrupt build reached the service")
    del svc, bad, params_g, full, index_v

    # the fit's catalog (8-bit bands): the gate's verdict, and its outcome
    svc15 = octx["svc"]
    v15 = svc15.index
    verdict = validate_index(build_index(signatures_of(v15),
                                         tail_cap=v15.tail_cap, device=dev))
    svc15.request_rebuild(signatures_of(v15))
    for _ in range(4):
        svc15._rebuilder.join(600)
        svc15.flush()
    kept = svc15.index is v15
    print(f"[16 gate] the fit's catalog (N={v15.n_base}, 8-bit bands): "
          f"validate_index on a fresh build says {verdict or 'passes'}; a "
          f"background rebuild of it was "
          + ("refused and rolled back (gave_up "
             f"{svc15.obs.counter('serve.rebuild.gave_up'):.0f})" if kept
             else "swapped in"), flush=True)
    if bool(verdict) != kept:
        raise AssertionError("the fit catalog's rebuild disagrees with the "
                             "gate's verdict")
    sync()
    print(f"[16 resil] phase seconds {time.perf_counter() - t_phase:.1f}",
          flush=True)
    return dict(name="segment_add", route="cuda",
                source="src/repro_torch/csrc/segment_add.cu",
                replaces="none: no TPU kernel (the card's deterministic "
                         "index_add_, src/repro_torch/core/scatter.py)",
                launches=seg_launches, max_abs_err=seg_err, ms=seg_ms,
                plain_ms=plain_ms, bound_ms=seg_bound, bound_by=seg_by,
                library_ms=plain_ms)


def loop_phase(args, octx: dict, scfg, dev, on_card: bool,
               power: str) -> None:
    """Phase 17: the always-on `OnlineLoop` at full width, on phase 15's
    state.  A 6-slice reference arm (its states' leaf hashes kept by
    seq), a drift trip forced on it, and three arms killed at
    ``loop.slice`` call 3, ``loop.ckpt`` call 1 and ``loop.drift`` call
    1, each recovered with `OnlineLoop.recover` and held to the
    reference's hashes at its seq."""
    import dataclasses
    import hashlib
    import shutil
    import tempfile

    from repro_torch import obs, prng
    from repro_torch.core import scatter
    from repro_torch.kernels.candidate_score import kernel as score_kernel
    from repro_torch.kernels.candidate_score.ref import assert_topn_close
    from repro_torch.kernels.lsh_retrieve import kernel as lsh_kernel
    from repro_torch.loop import LoopConfig, OnlineLoop
    from repro_torch.resil import OnlineUpdater, faults, wal
    from repro_torch.resil.faults import FaultPlan, FaultSpec, InjectedFault
    from repro_torch.serve import recommend_walked_kernel

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t_phase = time.perf_counter()
    st0, te = octx["st"], octx["te"]
    lsh, hp, K = octx["lsh"], octx["hp"], octx["K"]
    B = scfg.micro_batch
    rng = np.random.default_rng(args.seed + 17)
    n_hold = min(round(20_000 * args.fit_scale), te[0].size // 4)
    holdout = tuple(torch.as_tensor(a[:n_hold], device=dev) for a in te)
    rest = tuple(a[n_hold:] for a in te)
    cfg = LoopConfig(tail_cap=max(1, round(1024 * args.fit_scale)))
    up_kw = dict(K=K, epochs=3, batch=4096)

    # the stream, the same in every arm: a ΔΩ on slices 0, 2 and 4 (a
    # third of the remaining held-out ratings each, plus new users rating
    # 20 items and new items rated by 20 old users: phase 16's recipe),
    # and 2 × B users a slice, a quarter of them new ids
    deltas, M_, N_ = [], st0.M, st0.N
    n_u = max(1, round(100 * args.fit_scale))
    n_i = max(1, round(50 * args.fit_scale))
    for k, part in enumerate(np.array_split(np.arange(rest[0].size), 3)):
        M2, N2 = M_ + n_u, N_ + n_i
        r = np.concatenate([np.repeat(np.arange(M_, M2), 20),
                            rng.integers(0, M_, 20 * n_i)])
        c = np.concatenate([rng.integers(0, N2, 20 * n_u),
                            np.repeat(np.arange(N_, N2), 20)])
        key = np.unique(r.astype(np.int64) * N2 + c)
        r, c = key // N2, key % N2
        deltas.append(((np.concatenate([rest[0][part], r]).astype(np.int32),
                        np.concatenate([rest[1][part], c]).astype(np.int32),
                        np.concatenate([rest[2][part],
                                        rng.integers(1, 6, r.size)])
                        .astype(np.float32)),
                       M2, N2, prng.PRNGKey(args.seed + 170 + k)))
        M_, N_ = M2, N2
    traffic = []
    for s in range(6):
        m_hi = deltas[s // 2][1]
        traffic.append(np.concatenate([
            rng.integers(0, st0.M, 2 * B - B // 2),
            rng.integers(st0.M, m_hi, B // 2)]).astype(np.int32))

    def leaf_hashes(st):
        out = {}
        for k, v in wal.state_tree(st).items():
            a = v.cpu().numpy() if isinstance(v, torch.Tensor) else v
            out[k] = hashlib.sha256(np.ascontiguousarray(a).tobytes()
                                    + str((a.dtype, a.shape)).encode()
                                    ).hexdigest()
        return out

    def new_loop(root, reg):
        up = OnlineUpdater(st0, lsh, hp, root=root, registry=reg, **up_kw)
        svc = OnlineLoop.build_service(st0, scfg, tail_cap=cfg.tail_cap)
        return OnlineLoop(up, svc, cfg, holdout=holdout, registry=reg)

    def drive(loop, slices, kill=None, hashes=None, on_slice=None):
        """Run ``slices`` of the stream; a kill raises at its site.  →
        True when killed."""
        plan = (faults.install(FaultPlan({kill[0]: FaultSpec(
            at_calls=(kill[1],))})) if kill else None)
        try:
            for s in slices:
                loop.svc.submit(traffic[s])
                if s % 2 == 0:
                    d, M2, N2, key = deltas[s // 2]
                    loop.offer_delta(*d, key, M_new=M2, N_new=N2)
                if on_slice is not None:
                    on_slice(s, loop)
                try:
                    loop.run_slice()
                except InjectedFault:
                    return True
                if hashes is not None:
                    hashes[loop.updater.seq] = leaf_hashes(loop.state)
            return False
        finally:
            if plan is not None:
                faults.uninstall()

    def settle(svc):
        """Let a requested rebuild end: swapped, or given up on."""
        for _ in range(2 * svc.cfg.rebuild_retries + 2):
            if svc._rebuilder is None or svc._rebuild_sigs is None:
                break
            svc._rebuilder.join(600)
            svc.flush()

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    base = tempfile.mkdtemp(prefix="chip_smoke-loop-",
                            dir=os.path.join(ROOT, "build"))
    try:
        # ---- the reference arm: the main path, counters zeroed before ----
        reg = obs.Registry(enabled=True)
        loop = new_loop(os.path.join(base, "ref"), reg)
        svc = loop.svc
        served, checked, err = [], 0, 0.0

        def snapshot(s, lp):
            served.append((lp.svc.planes, lp.svc.index, lp.svc.sp,
                           lp.svc.popular, lp.svc._flat_ids()))

        ref = {}
        lsh_kernel.LAUNCHES = 0
        score_kernel.LAUNCHES = 0
        scatter.LAUNCHES = 0
        t0 = time.perf_counter()
        kw = dict(n_seeds=scfg.n_seeds, cap=scfg.cap, C=scfg.C,
                  window=scfg.seed_window, topn=scfg.topn,
                  tile_b=scfg.tile_b)
        for s in range(6):
            drive(loop, [s], hashes=ref, on_slice=snapshot)
            # the slice's first flush against the plain versions, on the
            # state it served from
            planes, index, sp_, popular, flat = served[-1]
            (u, sc, it), *_ = svc.take_results()
            s_ref, i_ref = recommend_walked_kernel(
                planes, index, sp_, torch.from_numpy(u).to(dev), popular,
                flat, tail_scan=index.tail_fill > 0, impl="ref", **kw)
            err = max(err, assert_topn_close(sc, it, s_ref, i_ref))
            checked += 1
            served[-1] = None
        sync()
        wall = time.perf_counter() - t0
        launches = dict(lsh_retrieve=lsh_kernel.LAUNCHES,
                        candidate_score=score_kernel.LAUNCHES)
        seg_launches = scatter.LAUNCHES
        st = svc.stats()
        warmups = sum(len(svc.obs.span_durations(n)) for n in (
            "serve.ingest_online.warmup", "serve.ingest.warmup",
            "serve.rebuild.swap"))
        spans = {n: reg.span_durations(n) for n in (
            "loop.slice", "loop.serve", "loop.train", "loop.drift",
            "loop.publish", "loop.ckpt", "online.update", "online.micro",
            "resil.wal.append")}
        stale = reg.hist_summary("loop.staleness_s")
        c = lambda n: int(reg.counter(n))
        print(f"[17 loop] M={st0.M} N={st0.N} F={st0.params.U.shape[1]} "
              f"K={K}, LoopConfig defaults (tail_cap {cfg.tail_cap}), "
              f"holdout {n_hold} ratings; 6 slices in {wall:.2f} s to "
              f"M={loop.state.M} N={loop.state.N} "
              f"({loop.state.sp.nnz} ratings), seq {loop.updater.seq}; "
              f"deltas of " + "/".join(str(d[0][0].size) for d in deltas)
              + " ratings", flush=True)
        print("[17 loop] span seconds (count: each): " + "; ".join(
            f"{n} ({len(v)}: " + ", ".join(f"{x:.3f}" for x in v) + ")"
            for n, v in spans.items()), flush=True)
        print(f"[17 loop] staleness p99 {stale.get('p99', float('nan')):.3f}"
              f" s (max {stale.get('max', float('nan')):.3f}, "
              f"{stale.get('count', 0)} readings); publishes "
              f"{c('loop.publishes')}, checkpoints {c('loop.ckpts')}, "
              f"slices trained {c('loop.slices_trained')}, guard trips "
              f"{c('loop.guard_trips')} (per-delta {c('resil.guard_trips')})"
              f", drift trips {c('loop.drift_rebuilds')}, slice failures "
              f"{c('loop.slice_failures')}, quarantined "
              f"{c('loop.quarantined')}; drift rmse now "
              f"{reg.gauge('loop.drift_rmse'):.6f}", flush=True)
        print(f"[17 serve] {st['batches']} flushes, {st['users']} users: "
              f"{st['qps']:.0f} users/s, p50 {st['p50_ms']:.3f} ms, p99 "
              f"{st['p99_ms']:.3f} ms; launches {launches} = flushes "
              f"{st['batches']} + warm-ups {warmups}; {checked} flushes (one "
              f"a slice) within 1e-5 of the plain versions (max abs err "
              f"{err:.3g}); dropped {st['dropped']}, fallbacks "
              f"{st['fallbacks']}; segment_add launches {seg_launches} "
              f"(power limit {power})", flush=True)
        if c("loop.slice_failures") or st["dropped"] or st["fallbacks"]:
            raise AssertionError(f"reference arm: slice failures "
                                 f"{c('loop.slice_failures')}, dropped "
                                 f"{st['dropped']}, fallbacks "
                                 f"{st['fallbacks']}")
        if c("loop.slices_trained") != 6 or c("online.updates") != 3:
            raise AssertionError("the reference arm did not train every "
                                 "slice and apply every delta")
        if on_card and any(n != st["batches"] + warmups
                           for n in launches.values()):
            raise AssertionError(f"launches {launches} for {st['batches']} "
                                 f"flushes and {warmups} warm-ups")
        if on_card and not seg_launches:
            raise AssertionError("segment_add never launched in the loop")

        # ---- a drift trip on the loop's own path: the fit's catalog ----
        trip = OnlineLoop(loop.updater, svc, dataclasses.replace(
            cfg, drift_every=1, drift_tol=-0.5, micro_epochs=0,
            ckpt_every=0), holdout=holdout, registry=obs.Registry(
                enabled=True))
        gave0 = int(svc.obs.counter("serve.rebuild.gave_up"))
        swaps0 = int(svc.obs.counter("serve.rebuild.swaps"))
        before_idx = svc.index
        trip.run(3, degrade=False)
        settle(svc)
        tripped = int(trip.obs.counter("loop.drift_rebuilds"))
        gave = int(svc.obs.counter("serve.rebuild.gave_up")) - gave0
        swapped = int(svc.obs.counter("serve.rebuild.swaps")) - swaps0
        outcome = ("gave_up" if gave else "swapped" if swapped
                   else "pending")
        print(f"[17 drift] drift_tol -0.5 on the reference loop: "
              f"{tripped} trip(s) over 3 probes; the requested rebuild "
              f"ended {outcome} (index kept: {svc.index is before_idx}, "
              f"index_stale {svc.stats()['index_stale']}, builds "
              f"{svc._rebuilder.builds}, failures {svc._rebuilder.failures})",
              flush=True)
        if tripped != 1 or outcome == "pending":
            raise AssertionError(f"drift trips {tripped}, rebuild "
                                 f"{outcome}")
        del trip, loop, svc, served
        gc.collect()

        # ---- three arms killed at the loop's fault sites, recovered ----
        for site, call in (("loop.slice", 3), ("loop.ckpt", 1),
                           ("loop.drift", 1)):
            root = os.path.join(base, site)
            arm = new_loop(root, obs.Registry(enabled=True))
            if not drive(arm, range(6), kill=(site, call)):
                raise AssertionError(f"the fault at {site} never fired")
            del arm
            gc.collect()
            rreg = obs.Registry(enabled=True)
            sync()
            t0 = time.perf_counter()
            rec = OnlineLoop.recover(root, lsh, hp, scfg, cfg=cfg,
                                     base_state=st0, holdout=holdout,
                                     registry=rreg, **up_kw)
            sync()
            rec_s = time.perf_counter() - t0
            q = rec.updater.seq
            got = leaf_hashes(rec.state)
            unequal = sorted(k for k in got if got[k] != ref.get(q, {}).get(k))
            nxt = rec.slice_count
            drive(rec, [nxt % 6])
            sync()
            rst = rec.svc.stats()
            part = lambda n: sum(rreg.span_durations(n))
            print(f"[17 kill] {site} call {call}: recovered to seq {q} "
                  f"(slice {nxt}) in {rec_s:.3f} s = restore "
                  f"{part('loop.recover.restore'):.3f} + WAL replay "
                  f"{part('resil.wal.replay'):.3f} "
                  f"({len(rreg.span_durations('resil.wal.replay'))} "
                  f"entries) + build_service and warm-up "
                  f"{part('loop.recover.service'):.3f} s; "
                  f"{len(got) - len(unequal)} of {len(got)} leaf hashes "
                  f"equal the reference's at seq {q}; one more slice: "
                  f"dropped {rst['dropped']}, fallbacks {rst['fallbacks']}, "
                  f"slice failures "
                  f"{int(rreg.counter('loop.slice_failures'))}", flush=True)
            if q not in ref or unequal:
                raise AssertionError(f"{site}: seq {q}, unequal leaves "
                                     f"{unequal}")
            if (rst["dropped"] or rst["fallbacks"]
                    or rreg.counter("loop.slice_failures")):
                raise AssertionError(f"{site}: the recovered loop's slice "
                                     f"failed or dropped users")
            del rec
            gc.collect()
    finally:
        shutil.rmtree(base, ignore_errors=True)
    sync()
    print(f"[17 loop] phase seconds {time.perf_counter() - t_phase:.1f}",
          flush=True)


def comparators_phase(args, ctx: dict, dev, on_card: bool,
                      power: str) -> None:
    """Phase 18: the fit's Top-K comparators.  ``rand``, ``rp_cos`` and
    ``minhash`` on phase 8's data and model; ``gsm`` beside ``simlsh`` at
    `MOVIELENS_LIKE`'s own M × N with the paper's Table-7 settings."""
    import dataclasses

    from repro_torch import prng
    from repro_torch.core import baselines, gsm, simlsh
    from repro_torch.data import synthetic
    from repro_torch.data.sparse import from_coo, train_test_split
    from repro_torch.kernels.mf_sgd import kernel as sgd_kernel
    from repro_torch.train.trainer import FitConfig, build_neighbours, fit

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t_phase = time.perf_counter()

    def run(tag, tr, te, shape, cfg):
        """Neighbours alone (seconds, the device's peak MB above what was
        resident), then `fit` with the `culsh_sgd` counter zeroed just
        before.  → the `FitResult`."""
        sp = from_coo(*tr, shape, device=dev)
        k_nb = prng.split(prng.PRNGKey(cfg.seed), 3)[0]
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        JK, S, _ = build_neighbours(sp, cfg, k_nb)
        sync()
        nb_s = time.perf_counter() - t0
        peak = ((torch.cuda.max_memory_allocated() - held) / 1e6 if on_card
                else float("nan"))
        kept = megabytes(JK, *(() if S is None else (S,)))
        del sp, JK, S
        sgd_kernel.CULSH_LAUNCHES = 0
        res = fit(tr, te, shape, cfg, device=dev)
        launches = sgd_kernel.CULSH_LAUNCHES
        nb_cf = res.schedule_stats["nb_cf"]
        rm = [h[2] for h in res.history]
        ep = np.diff([0.0] + [h[1] for h in res.history])
        print(f"[18 {tag}] method={cfg.method} M={shape[0]} N={shape[1]} "
              f"F={cfg.F} K={cfg.K}: neighbours {nb_s:.3f} s alone "
              f"(peak {peak:.1f} MB on the card above what was resident; "
              f"J^K{' + S' if cfg.method == 'simlsh' else ''} kept "
              f"{kept:.1f} MB), {res.neighbour_seconds:.3f} s in the fit; "
              f"epochs s " + ", ".join(f"{x:.3f}" for x in ep)
              + f"; rmse " + ", ".join(f"{x:.6f}" for x in rm)
              + f"; culsh_sgd launches {launches} = {nb_cf} conflict-free "
              f"steps x {cfg.epochs} epochs (power limit {power})",
              flush=True)
        if not (np.isfinite(rm).all() and rm[-1] < rm[0]):
            raise AssertionError(f"{cfg.method}: the fit did not train: {rm}")
        if on_card and launches != nb_cf * cfg.epochs:
            raise AssertionError(f"{cfg.method}: culsh_sgd launched "
                                 f"{launches} times, expected "
                                 f"{nb_cf * cfg.epochs}")
        return res

    # ---- rand, rp_cos, minhash on phase 8's data and model ----
    tr, te, shape, cfg = ctx["tr"], ctx["te"], ctx["shape"], ctx["cfg"]
    base = ctx["res"]
    ep = np.diff([0.0] + [h[1] for h in base.history])
    print(f"[18 simlsh] phase 10's fit: neighbours "
          f"{base.neighbour_seconds:.3f} s; epochs s "
          + ", ".join(f"{x:.3f}" for x in ep) + "; rmse "
          + ", ".join(f"{h[2]:.6f}" for h in base.history), flush=True)
    # simLSH again beside them, at the same depth in the same state of the
    # process (phase 10's epochs ran before phases 11–17)
    for method in ("simlsh", "rand", "rp_cos", "minhash"):
        run("fit", tr, te, shape, dataclasses.replace(cfg, method=method,
                                                      epochs=2))
        gc.collect()
    # bit-equality: minhash and random-K against the CPU on one band, and
    # RP_cos run twice on the card
    k_sig, k_top = prng.split(prng.split(prng.PRNGKey(cfg.seed), 3)[0])
    one = dataclasses.replace(cfg.lsh, q=1)
    sp_card = from_coo(*tr, shape, device=dev)
    sp_cpu = from_coo(*tr, shape, device="cpu")
    mh = baselines.minhash_signatures(sp_card, one, k_sig)
    mh_eq = torch.equal(mh.cpu(), baselines.minhash_signatures(sp_cpu, one,
                                                               k_sig))
    rk = baselines.rand_topk(k_top, shape[1], cfg.K, device=dev)
    rk_eq = torch.equal(rk.cpu(), baselines.rand_topk(k_top, shape[1],
                                                      cfg.K))
    rp = [baselines.rp_cos_signatures(sp_card, cfg.lsh, k_sig)
          for _ in range(2)]
    rp_eq = torch.equal(rp[0], rp[1])
    print(f"[18 check] minhash (one band) equal to the CPU's: {mh_eq}; "
          f"rand_topk equal to the CPU's: {rk_eq}; rp_cos ({cfg.lsh.q} "
          f"bands) run twice on the card bit-identical: {rp_eq}", flush=True)
    if not (mh_eq and rk_eq and rp_eq):
        raise AssertionError("a comparator's bits moved")
    del sp_card, sp_cpu, mh, rk, rp
    gc.collect()

    # ---- gsm beside simlsh at MOVIELENS_LIKE's M × N, Table-7 settings ----
    spec7 = synthetic.MOVIELENS_LIKE
    M7 = max(64, int(spec7.M * args.fit_scale))
    N7 = max(32, int(spec7.N * args.fit_scale))
    nnz7 = int(GSM_NNZ * args.fit_scale)
    t0 = time.perf_counter()
    rows, cols, vals, _ = synthetic.generate(dataclasses.replace(
        spec7, M=M7, N=N7, nnz=nnz7), seed=args.seed)
    tr7, te7 = train_test_split(np.random.default_rng(args.seed), rows, cols,
                                vals)
    gen_s = time.perf_counter() - t0
    print(f"[18 gsm] MOVIELENS_LIKE at M={M7} N={N7} with {nnz7} ratings "
          f"(of its {spec7.nnz}) generated in {gen_s:.1f} s (host numpy)",
          flush=True)
    cfg7 = FitConfig(F=16, K=8, epochs=6, batch=4096, method="gsm",
                     lsh=simlsh.SimLSHConfig(G=8, p=1, q=20, band_cap=16,
                                             psi_pow=2.0),
                     seed=args.seed, use_kernels=True, shards=1)
    res_g = run("gsm", tr7, te7, (M7, N7), cfg7)
    run("gsm", tr7, te7, (M7, N7), dataclasses.replace(cfg7,
                                                       method="simlsh"))
    # J^K of 64 sampled rows against a float64 recompute of their scores
    sp7 = from_coo(*tr7, (M7, N7), device=dev)
    r, c, v = sp7.rows.long(), sp7.cols.long(), sp7.vals.double()
    cnt = torch.zeros(N7, dtype=torch.float64, device=dev).index_add_(
        0, c, torch.ones_like(v))
    mean = torch.zeros(N7, dtype=torch.float64, device=dev).index_add_(
        0, c, v) / cnt.clamp(min=1.0)
    xc = v - mean[c]
    picks = torch.from_numpy(np.random.default_rng(args.seed).choice(
        N7, size=min(64, N7), replace=False)).to(dev)
    pos = torch.full((N7,), -1, dtype=torch.long, device=dev)
    pos[picks] = torch.arange(picks.numel(), device=dev)
    hit = pos[c] >= 0
    sub = lambda w: torch.zeros((M7, picks.numel()), dtype=torch.float64,
                                device=dev).index_put_(
        (r[hit], pos[c][hit]), w[hit])

    def gram(w, x):
        """[N, 64]: Σ_i w[i, j2] · x[i, k] over the ratings (i, j2)."""
        return torch.zeros((N7, picks.numel()), dtype=torch.float64,
                           device=dev).index_add_(0, c, w[:, None] * x[r])

    ones = torch.ones_like(xc)
    num = gram(xc, sub(xc))                          # [N, 64]
    n = gram(ones, sub(ones))
    d1 = gram(xc * xc, sub(ones))                    # Σ B[i,j1] X2[i,j2]
    d2 = gram(ones, sub(xc * xc))                    # Σ X2[i,j1] B[i,j2]
    S = (n / (n + 100.0) * num / torch.sqrt(torch.clamp(d2 * d1, min=1e-12))
         ).T                                           # [64, N]
    S[torch.arange(picks.numel(), device=dev), picks] = float("-inf")
    jk = res_g.JK[picks].long()
    picked = torch.gather(S, 1, jk).sort(dim=1, descending=True).values
    best = torch.topk(S, cfg7.K, dim=1).values
    gsm_err = float((picked - best).abs().max())
    flops, full_bytes = gsm.gsm_flops_bytes(M7, N7, cfg7.K)
    flops100, full100 = gsm.gsm_flops_bytes(FIT_M, FIT_N, FIT_K)
    cap = (torch.cuda.get_device_properties(0).total_memory if on_card
           else float("nan"))
    print(f"[18 gsm] J^K of {picks.numel()} sampled rows against a float64 "
          f"recompute: their scores within {gsm_err:.3g} of the K best "
          f"(limit 1e-5); at M={M7} N={N7} one dense [M, N] float32 "
          f"operand is {4 * M7 * N7 / 1e9:.2f} GB, the full GSM "
          f"{full_bytes / 1e9:.3f} GB and {flops:.3g} flops; at the 100M "
          f"model (M={FIT_M}, N={FIT_N}) one operand would be "
          f"{4 * FIT_M * FIT_N / 1e9:.1f} GB against the card's "
          f"{cap / 1e9:.1f} GB (the full GSM {full100 / 1e9:.1f} GB, "
          f"{flops100:.3g} flops), so GSM is not run there", flush=True)
    if not gsm_err <= 1e-5:
        raise AssertionError(f"GSM's J^K is off the float64 scores by "
                             f"{gsm_err:.3g}")
    del sp7, S, num, n, d1, d2, res_g
    gc.collect()
    sync()
    print(f"[18 comparators] phase seconds "
          f"{time.perf_counter() - t_phase:.1f}", flush=True)


def serve_paths_phase(args, serve: dict, dev, on_card: bool,
                      power: str) -> None:
    """Phase 19: the serving paths beside the kernel walk, on phase 3's
    catalog at full width with its J^K (`benchmarks/bench_serve.py`'s
    recipe) and a fresh index (tail_cap 128): the legacy pool + dedup
    oracle (``band_budget=0``) through the `candidate_score` kernel, the
    plain walk (``impl="ref"``, no kernel), small-catalog routing and
    `profile_flush` on three paths."""
    import dataclasses

    from repro_torch import prng
    from repro_torch.core import topk
    from repro_torch.kernels.candidate_score import kernel as score_kernel
    from repro_torch.kernels.candidate_score.ref import assert_topn_close
    from repro_torch.kernels.lsh_retrieve import kernel as lsh_kernel
    from repro_torch.core.topk import SENTINEL
    from repro_torch.serve import (RecsysService, build_index,
                                   recommend_candidates, retrieve_for_users,
                                   walk_candidates)

    t_phase = time.perf_counter()
    params, sp, sigs, scfg = (serve[k] for k in ("params", "sp", "sigs",
                                                 "cfg"))
    probe, exact = serve["probe"], serve["exact"]
    B, M, N = scfg.micro_batch, sp.M, sp.N
    t0 = time.perf_counter()
    JK = topk.topk_from_signatures(sigs, prng.fold_in(serve["key"], 1),
                                   K=16, band_cap=16)
    index = build_index(sigs, tail_cap=128, device=dev)
    if on_card:
        torch.cuda.synchronize()
    print(f"[19 state] J^K [{N}, 16] and a fresh index in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(args.seed + 19)
    batches = [rng.integers(0, M, B).astype(np.int32)
               for _ in range(BATCHES)]
    rkw = dict(n_seeds=scfg.n_seeds, cap=scfg.cap, window=scfg.seed_window)

    def service(**kw):
        return RecsysService(params, index, sp, dataclasses.replace(scfg, **kw),
                             JK=JK, device=dev)

    def launches():
        return dict(lsh_retrieve=lsh_kernel.LAUNCHES,
                    candidate_score=score_kernel.LAUNCHES)

    def drive(tag, svc):
        """Warm-up + the 64 flushes, the counters zeroed just before; the
        probe users' recall@10 after.  → (stats, results, launches,
        probe answers, recall)."""
        lsh_kernel.LAUNCHES = score_kernel.LAUNCHES = 0
        svc.warmup()
        for users in batches:
            svc.submit(users)
        svc.flush()
        n = launches()
        st, res = svc.stats(), svc.take_results()
        svc.submit(probe)
        svc.flush()
        got = np.concatenate([r[2] for r in svc.take_results()])
        rec = sum(len(set(g) & set(e)) for g, e in zip(got, exact)) / exact.size
        print(f"[19 {tag}] {st['batches']} flushes, {st['users']} users: "
              f"{st['qps']:.0f} users/s (busy time), p50 {st['p50_ms']:.3f} "
              f"ms, p99 {st['p99_ms']:.3f} ms per flush; launches {n}; "
              f"recall@{scfg.topn} {rec:.4f} on {len(probe)} probe users "
              f"(floor 0.5; power limit {power})", flush=True)
        if st["fallbacks"] or not rec >= 0.5:
            raise AssertionError(f"{tag}: fallbacks {st['fallbacks']}, "
                                 f"recall {rec:.4f}")
        return st, res, n, got, rec

    # ---- (a) the legacy pool + dedup oracle ----
    legacy = service(band_budget=0)
    st, res, n, got_legacy, _ = drive("legacy", legacy)
    if on_card and n != dict(lsh_retrieve=0,
                             candidate_score=st["batches"] + 1):
        raise AssertionError(f"legacy: launches {n} for {st['batches']} "
                             f"flushes + 1 warm-up")
    ckw = dict(rkw, C=scfg.C, pool_width=0, fold_mates=True, tail_scan=False,
               topn=scfg.topn, tile_b=scfg.tile_b)
    err = 0.0
    for users, s, i in res[:8]:
        s_ref, i_ref = recommend_candidates(
            legacy.planes, index, sp, torch.from_numpy(users).to(dev),
            legacy.JK, legacy.popular, impl="ref", **ckw)
        err = max(err, assert_topn_close(s, i, s_ref, i_ref))
    users = torch.from_numpy(batches[0]).to(dev)
    index_c, sp_c = index.to("cpu"), sp.to("cpu")    # the CPU's copies
    cand = retrieve_for_users(index, sp, users, C=scfg.C, JK=legacy.JK,
                              popular=legacy.popular, tail_scan=False, **rkw)
    cand_cpu = retrieve_for_users(index_c, sp_c, users.cpu(), C=scfg.C,
                                  JK=legacy.JK.cpu(),
                                  popular=legacy.popular.cpu(),
                                  tail_scan=False, **rkw)
    if not torch.equal(cand.cpu(), cand_cpu):
        raise AssertionError("legacy: retrieve_for_users on the card differs "
                             "from the CPU's")
    filled = float((cand != SENTINEL).float().mean())
    wide = service(band_budget=0, pool_width=512)
    cand_w = retrieve_for_users(index, sp, users, C=scfg.C, JK=wide.JK,
                                popular=wide.popular, pool_width=512,
                                tail_scan=False, **rkw).cpu().numpy()
    P = wide.popular.shape[0]
    uniq = all(len(set(r[r != SENTINEL])) == int((r != SENTINEL).sum())
               for r in cand_w)
    wide.submit(batches[0])
    wide.flush()
    items_w = wide.take_results()[0][2]
    uniq &= all(len(set(r)) == len(r) for r in items_w)
    print(f"[19 legacy] first 8 flushes within 1e-5 of recommend_candidates("
          f"impl='ref') (max abs err {err:.3g}); retrieve_for_users on the "
          f"card equal to the CPU's (slots filled {filled:.3f}); pool_width "
          f"512: ids unique per row {uniq}, shortlist in the last {P} slots",
          flush=True)
    if not uniq or not (cand_w[:, -P:] == wide.popular.cpu().numpy()).all():
        raise AssertionError("legacy: pool_width=512 candidates")
    del wide

    # ---- (b) the plain walk ----
    plain = service(impl="ref")
    st, res, n, got_plain, rec_plain = drive("plain walk", plain)
    if n != dict(lsh_retrieve=0, candidate_score=0):
        raise AssertionError(f"plain walk launched kernels: {n}")
    wkw = dict(rkw, budget=scfg.band_budget)
    ids, seeds = walk_candidates(index, sp, users, **wkw)
    ids_c, seeds_c = walk_candidates(index_c, sp_c, users.cpu(), **wkw)
    if not (torch.equal(ids.cpu(), ids_c) and torch.equal(seeds.cpu(),
                                                          seeds_c)):
        raise AssertionError("walk_candidates on the card differs from the "
                             "CPU's")
    kern = serve["probe_items"]
    overlap = lambda a: sum(len(set(g) & set(e))
                            for g, e in zip(a, kern)) / kern.size
    print(f"[19 plain walk] walk_candidates on the card equal to the CPU's "
          f"(slots used {float((ids != SENTINEL).float().mean()):.3f} of "
          f"{scfg.band_budget}); top-10 overlap with the kernel path (phase "
          f"6) {overlap(got_plain):.4f}, legacy with the kernel path "
          f"{overlap(got_legacy):.4f}", flush=True)

    # ---- (c) small-catalog routing ----
    routed = service(route_full_below=N + 1)
    routed.submit(probe)
    routed.flush()
    got_r = np.concatenate([r[2] for r in routed.take_results()])
    auto = service(route_full_below=-1)
    rd = auto.route_decision()
    thr = 48 * scfg.C                   # the auto threshold (36,864 items)
    print(f"[19 route] route_full_below={N + 1}: {routed.route_decision()}, "
          f"answers equal full_topn's {np.array_equal(got_r, exact)}; "
          f"route_full_below=-1: {rd}", flush=True)
    if not np.array_equal(got_r, exact):
        raise AssertionError("routed answers differ from full_topn's")
    if rd != dict(enabled=True, threshold=thr, n_items=N,
                  decision="full" if N <= thr else "candidate") or \
            auto.stats()["route"] != rd:
        raise AssertionError(f"route_full_below=-1: {rd}")
    del routed, auto, index_c, sp_c

    # ---- (d) profile_flush: staged spans, staged answer = fused ----
    walk = ["serve.flush", "serve.flush.retrieve",
            "serve.flush.retrieve.desc", "serve.flush.retrieve.walk",
            "serve.flush.score"]
    want = {"kernel walk": walk, "plain walk": walk + ["serve.flush.select"],
            "legacy": ["serve.flush", "serve.flush.retrieve",
                       "serve.flush.retrieve.pool",
                       "serve.flush.retrieve.dedup", "serve.flush.score"]}
    for tag, svc in (("kernel walk", service().warmup()),
                     ("plain walk", plain), ("legacy", legacy)):
        svc.submit(batches[1])
        svc.flush()
        _, s_f, i_f = svc.take_results()[0]
        secs = svc.profile_flush(batches[1])
        s_p, i_p = (x.cpu().numpy() for x in svc.profiled)
        same = (np.array_equal(i_p, i_f)
                and float(np.abs(s_p - s_f).max()) <= 1e-5)
        print(f"[19 profile] {tag}: " + ", ".join(
            f"{k.removeprefix('serve.flush.') if k != 'serve.flush' else k} "
            f"{v * 1e3:.3f} ms" for k, v in secs.items())
            + f"; staged answer = fused {same}", flush=True)
        if sorted(secs) != sorted(want[tag]) or not same:
            raise AssertionError(f"profile_flush ({tag}): {sorted(secs)}, "
                                 f"staged = fused {same}")
    print(f"[19 paths] phase seconds {time.perf_counter() - t_phase:.1f}",
          flush=True)
    return rec_plain


def shard_phase(args, serve: dict, ctx: dict, dev, on_card: bool,
                power: str) -> None:
    """Phase 20: the multi-device tiers on four logical shards of the one
    card (`REPRO_TORCH_LOGICAL_DEVICES`): (a) the sharded flush exact on
    a small catalog, against the single-device plain walk and the CPU;
    (b) sharded serving on phase 3's catalog; (c) the fit's shard tier on
    phase 8's model, the mesh against the one-device replay, and
    `fit(shards=4)`."""
    import dataclasses

    from repro_torch import convert, prng
    from repro_torch.core import model, sgd, simlsh
    from repro_torch.core.topk import SENTINEL
    from repro_torch.data.sparse import conflict_free_schedule, from_coo
    from repro_torch.kernels.candidate_score import kernel as score_kernel
    from repro_torch.kernels.candidate_score.ref import assert_topn_close
    from repro_torch.kernels.lsh_retrieve import kernel as lsh_kernel
    from repro_torch.kernels.mf_sgd import kernel as sgd_kernel
    from repro_torch.launch import mesh as shard_mesh
    from repro_torch.loop import OnlineLoop
    from repro_torch.resil import validate_index
    from repro_torch.serve import (RecsysService, ServeConfig,
                                   ShardedIngestUnsupported, build_index,
                                   signatures_of)
    from repro_torch.train.trainer import fit

    t_phase = time.perf_counter()
    D = 4
    os.environ[shard_mesh.LOGICAL_DEVICES] = str(D)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    n_cards = torch.cuda.device_count() if on_card else 0
    mesh = shard_mesh.make_shard_mesh(D, dev)
    print(f"[20 mesh] {shard_mesh.LOGICAL_DEVICES}={D}: "
          f"torch.cuda.device_count() {n_cards}, mesh "
          f"{[str(d) for d in mesh.devices]} (logical shards run one after "
          f"another on one stream: their seconds are the sharded program's "
          f"total work on one card, not a {D}-card wall time)", flush=True)

    # ---- (a) exactness on a small catalog (phase 3's recipe) ----
    U, V, bh, rows, cols, vals, M_a = make_catalog(4000, dev, seed=args.seed)
    z = np.zeros((4000, 1), np.float32)
    params_a = convert.params_from_numpy(U, V, np.zeros(M_a, np.float32), bh,
                                         z, z, 3.0, device=dev)
    sp_a = from_coo(rows, cols, vals, (M_a, 4000), device=dev)
    sigs_a = simlsh.encode(sp_a, simlsh.SimLSHConfig(G=8, p=2, q=10,
                                                     band_cap=16),
                           prng.PRNGKey(args.seed, device=dev))
    index_a = build_index(sigs_a, tail_cap=0, device=dev)
    users_a = np.random.default_rng(args.seed + 20).integers(
        0, M_a, 128).astype(np.int32)
    exact = dict(topn=10, micro_batch=128, n_seeds=8, cap=4096,
                 band_budget=16384, shard_budget=16384, n_popular=0,
                 use_jk=False)

    def top_sets(s, i):
        s, i = s.cpu().numpy(), i.cpu().numpy()
        return [(frozenset(i[u][i[u] != SENTINEL].tolist()),
                 np.sort(s[u][i[u] != SENTINEL])) for u in range(len(i))]

    ref_out = RecsysService(params_a, index_a, sp_a,
                            ServeConfig(**exact, impl="ref"), device=dev
                            )._recommend(torch.from_numpy(users_a).to(dev))
    for d_ in (2, D):
        got = RecsysService(params_a, index_a, sp_a,
                            ServeConfig(**exact, shards=d_), device=dev
                            )._recommend(torch.from_numpy(users_a).to(dev))
        err = 0.0
        for (ids_a, s_a), (ids_b, s_b) in zip(top_sets(*got),
                                              top_sets(*ref_out)):
            if ids_a != ids_b:
                raise AssertionError(f"D={d_}: the top-N ids differ from the "
                                     f"single-device walk's")
            np.testing.assert_allclose(s_a, s_b, rtol=1e-5, atol=1e-5)
            err = max(err, float(np.abs(s_a - s_b).max(initial=0.0)))
        print(f"[20 exact] D={d_}, nothing truncated (cap 4096, budgets "
              f"16384): top-10 id sets equal to the single-device plain "
              f"walk's on {len(users_a)} users (max abs score err "
              f"{err:.3g})", flush=True)
    bench = dict(topn=10, micro_batch=128, C=512, n_seeds=16, cap=8,
                 n_popular=64, tile_b=16, band_budget=512, shards=D)
    s_card, i_card = RecsysService(params_a, index_a, sp_a,
                                   ServeConfig(**bench), device=dev
                                   )._recommend(torch.from_numpy(users_a
                                                                 ).to(dev))
    s_cpu, i_cpu = RecsysService(params_a.to("cpu"), index_a.to("cpu"),
                                 sp_a.to("cpu"), ServeConfig(**bench),
                                 device="cpu")._recommend(
        torch.from_numpy(users_a))
    err = assert_topn_close(s_card, i_card, s_cpu, i_cpu)
    print(f"[20 exact] D={D} at the bench settings: the card's flush within "
          f"1e-5 of the CPU's (max abs err {err:.3g}; ids equal "
          f"{torch.equal(i_card.cpu(), i_cpu)})", flush=True)
    del params_a, sp_a, sigs_a, index_a

    # ---- (b) sharded serving at full width (phase 3's catalog) ----
    params, sp, sigs, scfg = (serve[k] for k in ("params", "sp", "sigs",
                                                 "cfg"))
    probe, exact_ids = serve["probe"], serve["exact"]
    B, M, N = scfg.micro_batch, sp.M, sp.N
    index = build_index(sigs, tail_cap=128, device=dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() if on_card else 0
    t0 = time.perf_counter()
    svc = RecsysService(params, index, sp,
                        dataclasses.replace(scfg, shards=D), device=dev)
    sync()
    t_build = time.perf_counter() - t0
    tier = svc._shard_state
    mb_tier = (torch.cuda.memory_allocated() - held) / 1e6 if on_card else 0
    probs = validate_index(tier.index)
    print(f"[20 serve] shards={D}: bounds {tier.index.bounds.tolist()}, "
          f"block {tier.index.block}, per-shard budget "
          f"{svc.cfg.resolved_shard_budget(D)}; tier built in {t_build:.2f} "
          f"s, {mb_tier:.0f} MB on the card; validate_index: "
          f"{probs or 'clean'}", flush=True)
    if probs:
        raise AssertionError(f"the sharded index is invalid: {probs}")
    rng = np.random.default_rng(args.seed + 21)
    batches = [rng.integers(0, M, B).astype(np.int32)
               for _ in range(BATCHES)]
    lsh_kernel.LAUNCHES = score_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    svc.warmup()
    for users in batches:
        svc.submit(users)
    svc.flush()
    wall = time.perf_counter() - t0
    n = dict(lsh_retrieve=lsh_kernel.LAUNCHES,
             candidate_score=score_kernel.LAUNCHES)
    st = svc.stats()
    items = np.concatenate([r[2] for r in svc.take_results()])
    svc.submit(probe)
    svc.flush()
    got = np.concatenate([r[2] for r in svc.take_results()])
    rec = sum(len(set(g) & set(e))
              for g, e in zip(got, exact_ids)) / exact_ids.size
    rec_plain = serve["plain_recall"]
    print(f"[20 serve] {st['batches']} flushes, {st['users']} users: "
          f"{st['qps']:.0f} users/s (busy time), p50 {st['p50_ms']:.3f} ms, "
          f"p99 {st['p99_ms']:.3f} ms per flush; wall {wall:.2f} s incl. "
          f"warm-up; launches {n}; recall@{scfg.topn} {rec:.4f} on "
          f"{len(probe)} probe users (floor 0.5) beside the single-device "
          f"plain walk's {rec_plain:.4f} (phase 19) and the kernel walk's "
          f"{serve['recall']:.4f} (phase 6); the JAX gate (sharded ≥ single "
          f"- 0.01) {'holds' if rec >= rec_plain - 0.01 else 'misses'} "
          f"(power limit {power})", flush=True)
    if n != dict(lsh_retrieve=0, candidate_score=0):
        raise AssertionError(f"the sharded flush launched kernels: {n}")
    if (st["fallbacks"] or not rec >= 0.5
            or items.shape != (BATCHES * B, scfg.topn)
            or not ((items >= 0) & (items < N)).all()):
        raise AssertionError(f"sharded serving: fallbacks {st['fallbacks']}, "
                             f"recall {rec:.4f}, answers {items.shape}")
    secs = svc.profile_flush(batches[0])
    print(f"[20 serve] profile_flush: " + ", ".join(
        f"{k} {v * 1e3:.3f} ms" for k, v in secs.items()), flush=True)
    full = signatures_of(index)
    refused = []
    for name, call in (
            ("ingest", lambda: svc.ingest(full[:, :1], torch.tensor(
                [N], dtype=torch.int32, device=dev), full_sigs=full)),
            ("ingest_online_update", lambda: svc.ingest_online_update(
                None, N)),
            ("request_rebuild", lambda: svc.request_rebuild(full))):
        try:
            call()
        except ShardedIngestUnsupported:
            refused.append(name)
    try:       # the loop refuses the service before it reads the updater
        OnlineLoop(None, svc)
        loop_refused = False
    except ValueError as e:
        loop_refused = "single-device" in str(e)
    print(f"[20 serve] read-only: refused {refused}, ingest_rejected "
          f"{svc.stats()['ingest_rejected']}; OnlineLoop refuses the "
          f"service {loop_refused}", flush=True)
    if len(refused) != 3 or not loop_refused:
        raise AssertionError("the sharded service must be read-only")
    del svc, tier, index, full

    # ---- (c) the fit's shard tier at full width (phase 8's model) ----
    tr, te, (M, N), cfg = ctx["tr"], ctx["te"], ctx["shape"], ctx["cfg"]
    sp = from_coo(*tr, (M, N), device=dev)
    JK, res1 = ctx["res"].JK, ctx["res"]
    k_nb, k_init, k_ep = prng.split(prng.PRNGKey(cfg.seed), 3)
    t0 = time.perf_counter()
    sched = conflict_free_schedule(
        sp.rows.cpu().numpy(), sp.cols.cpu().numpy(), batch=cfg.cf_batch,
        tiers=cfg.tiers, tier_shrink=cfg.tier_shrink,
        min_fill_frac=cfg.min_fill_frac, shards=D, M=M, N=N, seed=cfg.seed)
    t_sched = time.perf_counter() - t0
    sd = model.build_scheduled_data(sp, JK, sched)
    shd = model.build_shard_data(sp, JK, sched)
    sync()
    sh = sched.stats()["shard"]
    fields = lambda x: [getattr(x, f.name) for f in dataclasses.fields(x)]
    print(f"[20 fit] shards={D} schedule in {t_sched:.2f} s (host): shard "
          f"tier {sh['rounds']} cells of width {sh['width']} ({sh['n']} "
          f"ratings, {sh['n'] / sp.nnz:.4f} of {sp.nnz}, fill "
          f"{sh['fill']:.3f}); ShardData {megabytes(*fields(shd)):.1f} MB, "
          f"the rest's ScheduledData {megabytes(*fields(sd)):.1f} MB; "
          f"extents rows {sh['extent_rows']} cols {sh['extent_cols']}",
          flush=True)
    te_r, te_c, te_v = (torch.as_tensor(a, device=dev) for a in te)
    p0 = model.remap_params(model.init_from_data(k_init, sp, cfg.F, cfg.K),
                            sched)

    def epochs(meshed: bool):
        pp = model.pack_params(p0)
        tier_s, epoch_s = [], []
        for ep in range(2):
            key = prng.fold_in(k_ep, ep)
            start = dataclasses.replace(pp, row=pp.row.clone(),
                                        col=pp.col.clone())
            sync()
            t0 = time.perf_counter()
            sgd.train_epoch_scheduled(pp, sd, sched, key, ep, cfg.hp,
                                      shd=shd, use_kernels=True,
                                      mesh=mesh if meshed else None)
            sync()
            epoch_s.append(time.perf_counter() - t0)
            # the shard tier alone, as the epoch ran it: the same start
            # state, round order (keys[0] of the epoch's split) and decay
            cp = start
            shd_p, valid_p = sgd._shard_round_shuffle(
                shd, sched, prng.split(key, 2 + len(sched.tier_starts))[0])
            decay = sgd.lr_decay(cfg.hp, ep, dev)
            sync()
            t0 = time.perf_counter()
            if meshed:
                sgd._sharded_tier(cp, shd_p, valid_p, sched, cfg.hp, decay,
                                  mesh, mf_only=False, bce=False)
            else:
                sgd._shard_replay(cp, shd_p, valid_p, sched, cfg.hp, decay,
                                  mf_only=False, bce=False)
            sync()
            tier_s.append(time.perf_counter() - t0)
            del start, cp, shd_p, valid_p
        p = model.unmap_params(model.unpack_params(pp), sched)
        return p, model.rmse(p, sp, JK, te_r, te_c, te_v), epoch_s, tier_s

    p_mesh, r_mesh, ep_mesh, tier_mesh = epochs(True)
    p_rep, r_rep, ep_rep, tier_rep = epochs(False)
    diff = max(float((getattr(p_mesh, f) - getattr(p_rep, f)).abs().max())
               for f in ("U", "V", "b", "bh", "W", "C"))
    r_mesh, r_rep = float(r_mesh), float(r_rep)
    print(f"[20 fit] two epochs through the mesh and through the replay: "
          f"max leaf |diff| {diff:.3g} (limit 1e-5), test rmse {r_mesh:.6f} "
          f"/ {r_rep:.6f} (limit 1e-5); epoch s mesh "
          f"{[round(x, 3) for x in ep_mesh]}, replay "
          f"{[round(x, 3) for x in ep_rep]}; the shard tier alone s mesh "
          f"{[round(x, 3) for x in tier_mesh]}, replay "
          f"{[round(x, 3) for x in tier_rep]} ({sh['rounds']} cells on the "
          f"packed steps, host-paced)", flush=True)
    if not (diff <= 1e-5 and abs(r_mesh - r_rep) <= 1e-5):
        raise AssertionError("the mesh shard tier differs from the replay")
    del p_mesh, p_rep, sd, shd, p0

    sgd_kernel.CULSH_LAUNCHES = 0
    res = fit(tr, te, (M, N), dataclasses.replace(cfg, shards=D, epochs=2),
              device=dev)
    launches = sgd_kernel.CULSH_LAUNCHES
    st4 = res.schedule_stats
    width_steps = sum(t["rounds"] for t in st4["tiers"])
    rm = [h[2] for h in res.history]
    ep_s = np.diff([0.0] + [h[1] for h in res.history]).round(3).tolist()
    ep1 = np.diff([0.0] + [h[1] for h in res1.history]).round(3).tolist()
    share = np.mean(tier_mesh) / np.mean(ep_mesh)
    print(f"[20 fit] fit(shards={D}, use_kernels=True, epochs=2): rmse "
          f"{rm} (phase 10's one-shard fit: {[h[2] for h in res1.history][:2]}"
          f"); schedule cf_frac {st4['cf_frac']:.4f} (phase 8's one-shard "
          f"{res1.schedule_stats['cf_frac']:.4f}), {st4['nb_lo']} leftover "
          f"batches ({res1.schedule_stats['nb_lo']}); culsh_sgd_step "
          f"launches {launches} = {width_steps} width-tier steps x 2 epochs "
          f"(the shard tier's {st4['shard']['rounds']} cells run the packed "
          f"steps); epoch s {ep_s} beside phase 10's {ep1}; the shard tier "
          f"{share:.3f} of a mesh epoch (power limit {power})", flush=True)
    if not (np.isfinite(rm).all() and rm[-1] < rm[0]):
        raise AssertionError(f"the sharded fit did not train: rmse {rm}")
    if st4["shard"]["shards"] != D or not st4["shard"]["n"]:
        raise AssertionError(f"the fit has no {D}-shard tier: {st4['shard']}")
    if on_card and launches != width_steps * 2:
        raise AssertionError(f"culsh_sgd_step launched {launches} times, "
                             f"expected {width_steps * 2}")
    del os.environ[shard_mesh.LOGICAL_DEVICES]
    print(f"[20 shards] phase seconds {time.perf_counter() - t_phase:.1f}",
          flush=True)


def table10_phase(args, dev, on_card: bool, power: str) -> dict:
    """Phase 21: the paper's Table 10 — CULSH-MF on implicit feedback
    (``loss="bce"``) against GMF, MLP and NeuMF (`core/ncf.py`), with
    `benchmarks/bench_ncf.py`'s recipe and protocol re-implemented here
    at `MOVIELENS_LIKE`'s M × N.  → the bce fit's `culsh_sgd` count."""
    import dataclasses

    from repro_torch import prng
    from repro_torch import tree as T
    from repro_torch.core import model, ncf, sgd
    from repro_torch.core.sgd import Hyper
    from repro_torch.core.simlsh import SimLSHConfig
    from repro_torch.data.sparse import conflict_free_schedule, from_coo
    from repro_torch.kernels.mf_sgd import kernel as sgd_kernel
    from repro_torch.kernels.mf_sgd.ops import culsh_hyper
    from repro_torch.train.trainer import FitConfig, fit

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t_phase = time.perf_counter()
    M = max(200, int(T10_M * min(1.0, args.fit_scale * 10)))
    N = max(100, int(T10_N * min(1.0, args.fit_scale * 10)))
    # the planted implicit recipe (bench_ncf.py::make_implicit): user u
    # likes items around 7u mod N; duplicate (u, i) draws collapse
    rng = np.random.default_rng(0)
    users = np.repeat(np.arange(M), T10_PER_USER).astype(np.int32)
    items = ((users * 7 + rng.integers(0, 6, len(users))) % N).astype(
        np.int32)
    _, uq = np.unique(users.astype(np.int64) * N + items, return_index=True)
    users, items = users[uq], items[uq]
    vals = np.ones(len(users), np.float32)
    # the protocol: each user's last positive held out, 50 sampled
    # negatives to rank it against
    rng = np.random.default_rng(1)
    te_mask = np.zeros(len(users), bool)
    _, last = np.unique(users[::-1], return_index=True)
    te_mask[len(users) - 1 - last] = True
    tr = (users[~te_mask], items[~te_mask], vals[~te_mask])
    te_u, te_i = users[te_mask], items[te_mask]
    cands = rng.integers(0, N, (len(te_u), 50)).astype(np.int32)
    print(f"[21 data] M={M} N={N}: {len(users)} positives from "
          f"{M * T10_PER_USER} draws ({T10_PER_USER} a user, 6 items "
          f"apart at most), {len(te_u)} held out, 50 negatives each",
          flush=True)
    te_t, ti_t, cand_t = (torch.from_numpy(a).to(dev)
                          for a in (te_u, te_i, cands))

    def hr_mf(p) -> float:
        """`bench_ncf.py::hr_mf`: the held-out positive's rank by the MF
        score U·V + μ + b + b̂ among its 50 negatives."""
        it = torch.cat([ti_t[:, None], cand_t], dim=1).long()
        u = te_t.long()
        z = ((p.U[u][:, None, :] * p.V[it]).sum(-1) + p.mu + p.b[u][:, None]
             + p.bh[it])
        return float(((z > z[:, :1]).sum(1) < 10).float().mean())

    # CULSH-MF: positives = 1 plus 3:1 sampled negatives = 0
    negs_mf = rng.integers(0, N, 3 * len(tr[0])).astype(np.int32)
    tr_mf = (np.concatenate([tr[0]] * 4), np.concatenate([tr[1], negs_mf]),
             np.concatenate([tr[2], np.zeros(3 * len(tr[0]), np.float32)]))
    test = (te_u, te_i, np.ones(len(te_u), np.float32))
    cfg = FitConfig(F=16, K=8, epochs=40, batch=2048, method="simlsh",
                    lsh=SimLSHConfig(G=8, p=1, q=10, psi_pow=1.0),
                    hp=Hyper(a_u=0.2, a_v=0.2, a_b=0.1, a_bh=0.1, beta=0.02),
                    loss="bce", eval_every=0, use_kernels=True, shards=1)
    sp_mf = from_coo(*tr_mf, (M, N), device=dev)
    sample = np.random.default_rng(2).choice(len(tr_mf[0]), 200_000)
    s_r, s_c, s_y = (torch.from_numpy(a[sample]).to(dev) for a in tr_mf)

    def mf_loss(res) -> float:
        """The training BCE of the fit's logits (Eq. 1) on a fixed sample
        of 200,000 of its pairs."""
        z = torch.cat([model.predict(res.params, bt)[0] for bt in
                       model.eval_batches(sp_mf, res.JK, s_r, s_c, s_y)])
        return float(ncf.bce(z[:len(sample)], s_y))

    first = fit(tr_mf, test, (M, N), dataclasses.replace(cfg, epochs=1),
                device=dev)
    loss_first = mf_loss(first)
    del first
    sync()
    sgd_kernel.CULSH_LAUNCHES = 0                   # the bce fit's path
    t0 = time.perf_counter()
    res = fit(tr_mf, test, (M, N), cfg, device=dev)
    sync()
    t_culsh = time.perf_counter() - t0
    launches = sgd_kernel.CULSH_LAUNCHES
    nb_cf = res.schedule_stats["nb_cf"]
    loss_last, hr_c = mf_loss(res), hr_mf(res.params)
    print(f"[21 culsh-mf] fit(loss='bce', F=16, K=8, 40 epochs) on "
          f"{len(tr_mf[0])} pairs: {t_culsh:.2f} s wall (neighbours "
          f"{res.neighbour_seconds:.2f} s), HR@10 {hr_c:.4f}, training BCE "
          f"{loss_first:.4f} after epoch 1 -> {loss_last:.4f} after epoch "
          f"40; culsh_sgd launches {launches} = {nb_cf} conflict-free steps "
          f"x 40 epochs (power limit {power})", flush=True)
    if not (np.isfinite(hr_c) and loss_last < loss_first):
        raise AssertionError(f"CULSH-MF (bce): HR {hr_c}, BCE {loss_first} "
                             f"-> {loss_last}")
    if on_card and not launches == nb_cf * cfg.epochs > 0:
        raise AssertionError(f"the bce fit launched culsh_sgd {launches} "
                             f"times, expected {nb_cf * cfg.epochs}")
    # the bce kernel against its plain version at this path's shapes
    # (F = 16, K = 8: the lanes past F and K are masked), on the trained
    # state and the first and last window of each width tier of the
    # fit's own schedule, at the last epoch's rates
    sched = conflict_free_schedule(
        sp_mf.rows.cpu().numpy(), sp_mf.cols.cpu().numpy(),
        batch=min(cfg.cf_batch, cfg.batch), tiers=cfg.tiers,
        tier_shrink=cfg.tier_shrink, min_fill_frac=cfg.min_fill_frac,
        shards=1, M=M, N=N, seed=cfg.seed)
    sd = model.build_scheduled_data(sp_mf, res.JK, sched)
    state = model.pack_params(model.remap_params(res.params, sched))
    hpv = culsh_hyper(cfg.hp, sgd.lr_decay(cfg.hp, cfg.epochs - 1, dev),
                      state.mu)
    k_err, windows = 0.0, []
    for t, (starts, valid) in enumerate(zip(sched.tier_starts,
                                            sched.tier_valid)):
        w = sched.widths[t]
        for k in sorted({0, len(starts) - 1}) if len(starts) else ():
            b = model.slice_batch(sd, int(starts[k]), w, torch.as_tensor(
                valid[k][:w], device=dev).float())
            k_err = max(k_err, fused_vs_plain(state, b, hpv, F=cfg.F,
                                              bce=True)[2])
            windows.append(f"{w}:{int(b.valid.sum())}")
    print(f"[21 check] culsh_sgd (bce, F=16, K=8) within rtol 1e-5 / atol "
          f"1e-6 of the plain gather -> step -> scatter on the trained "
          f"state, {len(windows)} windows of the fit's schedule (width:live "
          f"{', '.join(windows)}), max abs err {k_err:.3g}", flush=True)
    del res, sp_mf, sd, state

    # the NCF family: positives plus 1:1 sampled negatives, full batch
    negs = rng.integers(0, N, len(tr[0])).astype(np.int32)
    i_all, j_all, y_all = (torch.from_numpy(a).to(dev) for a in (
        np.concatenate([tr[0], tr[0]]), np.concatenate([tr[1], negs]),
        np.concatenate([np.ones(len(tr[0])), np.zeros(len(tr[0]))]).astype(
            np.float32)))
    rows = dict(culsh_mf=dict(s=t_culsh, hr10=hr_c, loss=(loss_first,
                                                          loss_last)))
    for kind in ("gmf", "mlp", "neumf"):
        c = ncf.NCFConfig(M=M, N=N, F=16, mlp_layers=(32, 16), kind=kind)
        p = ncf.init(c, prng.PRNGKey(0), device=dev)
        m = T.tree_map(torch.zeros_like, p)
        v = T.tree_map(torch.zeros_like, p)
        if kind == "neumf":
            first_step_vs_cpu(p, c, i_all, j_all, y_all)
        with torch.no_grad():
            loss0 = float(ncf.bce_loss(p, c, i_all, j_all, y_all))
        sync()
        t0 = time.perf_counter()
        for t in range(1, T10_STEPS + 1):
            p, m, v = ncf.adam_step(p, m, v, t, c, i_all, j_all, y_all,
                                    lr=2e-2)
        sync()
        t_dl = time.perf_counter() - t0
        with torch.no_grad():
            loss1 = float(ncf.bce_loss(p, c, i_all, j_all, y_all))
        hr = float(ncf.hit_ratio(p, c, te_t, ti_t, cand_t, topk=10))
        rows[kind] = dict(s=t_dl, hr10=hr, loss=(loss0, loss1))
        print(f"[21 {kind}] {T10_STEPS} full-batch Adam steps (lr 2e-2) on "
              f"{len(i_all)} pairs: {t_dl:.2f} s wall ({t_dl / t_culsh:.2f}x "
              f"CULSH-MF's), HR@10 {hr:.4f}, BCE {loss0:.4f} before step 1 "
              f"-> {loss1:.4f} after step {T10_STEPS}", flush=True)
        if not (np.isfinite(hr) and loss1 < loss0):
            raise AssertionError(f"{kind}: HR {hr}, BCE {loss0} -> {loss1}")
    print(f"[21 done] phase 21 in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return dict(rows=rows, culsh_launches=launches)


def first_step_vs_cpu(p, c, i, j, y) -> None:
    """The card's first NeuMF step against the same step on the CPU, each
    gradient leaf held to its own largest entry (an embedding entry's
    gradient over this phase's pairs is ~1e-9, so an absolute bound would
    pass a zero or sign-flipped leaf):

    * in float64, card = CPU within 1e-9 of each leaf's max |g| — the
      same autograd graph on both, rounding at 2⁻⁵³;
    * in float32 (the path's dtype), card = CPU within 1e-3 of each
      leaf's max |g|: every leaf sums ~10⁶ pair terms that cancel to a
      small result, so float32 fixes a leaf only to ~1e-4–1e-3 of its
      scale (the CPU's own float32 gradient against its float64 one is
      printed); a zero or sign-flipped leaf is off by 1–2× its scale;
    * the Adam update of the *same* float32 gradients within 1e-6 (Adam's
      first step is ≈ lr·sign(g), so a gradient near 0 that flips sign
      between summation orders would move an entry by 2·lr)."""
    from repro_torch import tree as T
    from repro_torch.core import ncf

    if p["gmf_u"].device.type != "cuda":
        return
    host = lambda tree: T.tree_map(lambda a: a.cpu(), tree)
    f64 = lambda tree: T.tree_map(lambda a: a.double(), tree)
    g_card = ncf.grads(p, c, i, j, y)
    g_cpu = ncf.grads(host(p), c, i.cpu(), j.cpu(), y.cpu())
    g64_card = ncf.grads(f64(p), c, i, j, y.double())
    g64_cpu = ncf.grads(f64(host(p)), c, i.cpu(), j.cpu(), y.cpu().double())
    names = [k if not isinstance(p[k], list) else f"{k}[{n}]"
             for k in sorted(p)
             for n in range(len(p[k]) if isinstance(p[k], list) else 1)]
    rel = lambda a, b, r: float((a.cpu().double() - b.double()).abs().max()
                                / r.abs().max())
    rows, r32, r64 = [], 0.0, 0.0
    for name, a, b, a64, b64 in zip(names, *map(T.leaves, (
            g_card, g_cpu, g64_card, g64_cpu))):
        if not float(b64.abs().max()) > 0:
            raise AssertionError(f"NeuMF's gradient leaf {name} is zero")
        e32, e64 = rel(a, b, b64), rel(a64, b64, b64)
        r32, r64 = max(r32, e32), max(r64, e64)
        rows.append(f"{name} {float(b64.abs().max()):.3g}: {e32:.3g} / "
                    f"{e64:.3g} (CPU f32 vs f64 {rel(b, b64, b64):.3g})")
    zeros = lambda tree: T.tree_map(torch.zeros_like, tree)
    with torch.no_grad():
        card = ncf.adam_update(p, zeros(p), zeros(p), g_card, 1, lr=2e-2)
        cpu = ncf.adam_update(host(p), zeros(host(p)), zeros(host(p)),
                              host(g_card), 1, lr=2e-2)
    u_err = max(float((a.cpu() - b).abs().max())
                for tc, th in zip(card, cpu)
                for a, b in zip(T.leaves(tc), T.leaves(th)))
    with torch.no_grad():
        l_card = float(ncf.bce_loss(card[0], c, i, j, y))
        l_cpu = float(ncf.bce_loss(ncf.adam_update(
            host(p), zeros(host(p)), zeros(host(p)), g_cpu, 1, lr=2e-2)[0],
            c, i.cpu(), j.cpu(), y.cpu()))
    print(f"[21 check] NeuMF's first step, card vs CPU, each gradient leaf "
          f"(max |g|: float32 / float64 error over it): " + "; ".join(rows)
          + f" -- limits 1e-3 / 1e-9; the Adam update of the same "
          f"gradients within {u_err:.3g} (limit 1e-6), the loss after "
          f"each side's own step {l_card:.7f} / {l_cpu:.7f}", flush=True)
    if not (r32 <= 1e-3 and r64 <= 1e-9 and u_err <= 1e-6
            and abs(l_card - l_cpu) <= 1e-5):
        raise AssertionError(f"NeuMF's first step: gradients {r32} / "
                             f"{r64} of their scales, update {u_err}, "
                             f"loss {l_card} / {l_cpu}")


def examples_phase(args, dev, on_card: bool, power: str) -> dict:
    """Phase 22: each `examples/torch_*.py` as a user runs it, in a
    subprocess on the card at its own default size (the 100M script
    with ``--small``: phases 8–10 run its full size), with ``--report``
    printing the kernels' launch counters."""
    build = os.path.join(ROOT, "build", "chip_smoke_examples")
    runs = [("torch_quickstart", []), ("torch_online_learning", []),
            ("torch_serve_recsys", []),
            ("torch_serve_recsys", ["--online-loop", "--slices", "3",
                                    "--root", os.path.join(build, "loop")]),
            ("torch_train_lshmf_100m", ["--small", "--ckpt-dir",
                                        os.path.join(build, "ckpt"),
                                        "--trace", os.path.join(
                                            build, "train_trace.json")]),
            # cut from the example's 40 steps for time: phase 24 trains
            # at full width
            ("torch_train_lm", ["--steps", "10"]),
            ("torch_train_lm", ["--lsh-softmax", "--steps", "10"])]
    small = ["--M", "600", "--N", "100", "--nnz", "12000", "--epochs", "2"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t_phase = time.perf_counter()
    import shutil
    shutil.rmtree(build, ignore_errors=True)
    os.makedirs(build)
    out = {}
    for name, extra in runs:
        argv = [sys.executable, os.path.join(ROOT, "examples", f"{name}.py"),
                "--report", *extra]
        if not on_card:                          # rehearsal: the CPU, tiny
            argv += ["--device", "cpu"] + (
                ["--shape", "2000,300,16,8,20000,2"]
                if name == "torch_train_lshmf_100m" else ["--steps", "3"]
                if name == "torch_train_lm" else small)
        t0 = time.perf_counter()
        done = subprocess.run(argv, env=env, capture_output=True, text=True,
                              timeout=600, cwd=build)
        wall = time.perf_counter() - t0
        tag = " ".join([name.replace("torch_", ""), *extra[:1]]) if (
            extra and extra[0] in ("--online-loop", "--lsh-softmax")) else \
            name.replace("torch_", "")
        lines = done.stdout.strip().splitlines()
        print(f"[22 {tag}] exit {done.returncode} in {wall:.1f} s; last "
              f"lines:", flush=True)
        for line in lines[-4:]:
            print(f"[22 {tag}]   {line}", flush=True)
        if done.returncode != 0:
            print(done.stderr[-4000:], file=sys.stderr)
            raise AssertionError(f"{name} {extra} exited "
                                 f"{done.returncode}")
        rep = [json.loads(line[len("report "):]) for line in lines
               if line.startswith("report ")]
        if len(rep) != 1:
            raise AssertionError(f"{name}: no report line")
        launches = rep[0]["launches"]
        out[tag] = dict(wall=wall, **rep[0])
        # the LM example's softmax arm adds its candidate rows'
        # gradients through segment_add; its full arm runs no kernel
        need = ((["segment_add"] if "--lsh-softmax" in extra else [])
                if "train_lm" in name
                else ["culsh_sgd"] + (["lsh_retrieve", "candidate_score"]
                                      if "serve_recsys" in name else []))
        if on_card and not all(launches[k] > 0 for k in need):
            raise AssertionError(f"{tag}: launches {launches}: each of "
                                 f"{need} must run")
        if on_card and tag == "serve_recsys":
            # the example held its kernel walk against the kernels' plain
            # versions on one probe flush (`assert_topn_close`, 1e-5)
            chk = rep[0].get("walk_vs_plain")
            if not chk or not np.isfinite(chk["max_abs_err"]):
                raise AssertionError(f"{tag}: no kernel-vs-plain check in "
                                     f"its report: {rep[0]}")
            print(f"[22 {tag}] kernel walk vs plain on {chk['users']} "
                  f"probe users: max abs score err "
                  f"{chk['max_abs_err']:.3g}", flush=True)
    shutil.rmtree(build, ignore_errors=True)
    print(f"[22 done] phase 22 in {time.perf_counter() - t_phase:.1f} s "
          f"(power limit {power})", flush=True)
    return out


def lm_phase(args, dev, on_card: bool, power: str) -> dict:
    """Phase 23: dense LM serving (`repro_torch.launch.serve.serve`) at
    llama3-8b's full width; its KV cache (prefill's last-position logits
    against a token-by-token decode of the same prompt) and the card
    against the CPU (float32) on a 2-layer cut of the same widths."""
    import dataclasses

    from repro_torch import prng
    from repro_torch.configs import base as CB
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm, steps

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t_phase = time.perf_counter()
    full = CB.get("llama3-8b")
    if not on_card:
        full = CB.reduced(full)                  # rehearsal size
    u = 2.0 ** -8                                # bfloat16's unit roundoff
    B, S = 4, 64
    # ---- (a) 2-layer cut of the full widths: cache and card vs CPU ----
    cut = dataclasses.replace(full, L=2)
    p = lm.init_params(cut, prng.PRNGKey(0), model_shards=1, device=dev)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cut.vocab, (B, S)).astype(np.int32)).to(dev)
    pre, _ = steps.make_prefill(cut)(p, {"tokens": toks})
    dec = steps.make_decode_step(cut)
    cache = steps.init_cache(cut, B, S, device=dev)
    for t in range(S):
        lg, cache = dec(p, cache, toks[:, t:t + 1])
    sync()
    rms = float(pre.float().pow(2).mean().sqrt())
    err = (lg[:, 0] - pre).abs()
    d_max, d_mean = float(err.max()), float(err.mean())
    print(f"[23 cache] {cut.name} cut to L=2 (d={cut.d_model}, "
          f"ff={cut.d_ff}, V={cut.vocab_padded(1)}), bfloat16: prefill's "
          f"last-position logits vs a {S}-step decode of the same prompts: "
          f"max abs {d_max:.4g}, mean {d_mean:.4g} (logit rms {rms:.4g}; "
          f"limits 16u·rms {16 * u * rms:.4g} and 4u·rms {4 * u * rms:.4g}, "
          f"u = 2^-8)", flush=True)
    if not (d_max <= 16 * u * rms and d_mean <= 4 * u * rms):
        raise AssertionError("the decode's KV cache disagrees with prefill")
    host = {k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict)
                else v.cpu()) for k, v in p.items()}
    t0 = time.perf_counter()
    with torch.no_grad():
        ref, _ = steps.make_prefill(dataclasses.replace(cut, dtype="float32"))(
            host, {"tokens": toks.cpu()})
    t_cpu = time.perf_counter() - t0
    rms32 = float(ref.pow(2).mean().sqrt())
    err = (pre.cpu() - ref).abs()
    c_max, c_mean = float(err.max()), float(err.mean())
    print(f"[23 cpu] the same prefill on the CPU in float32 ({t_cpu:.1f} s): "
          f"card (bfloat16) within max abs {c_max:.4g}, mean {c_mean:.4g} "
          f"(logit rms {rms32:.4g}; limits 32u·rms {32 * u * rms32:.4g} and "
          f"8u·rms {8 * u * rms32:.4g}); greedy tokens equal on "
          f"{float((pre.cpu().argmax(-1) == ref.argmax(-1)).float().mean()):.2f}"
          f" of the rows", flush=True)
    if not (c_max <= 32 * u * rms32 and c_mean <= 8 * u * rms32):
        raise AssertionError("the card's logits disagree with the CPU's")
    del p, host, cache, pre, lg, ref
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # ---- (b) the served model at full width ----
    held = torch.cuda.memory_allocated() / 1e6 if on_card else 0.0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(full, prng.PRNGKey(0), model_shards=1,
                            device=dev)
    sync()
    t_init = time.perf_counter() - t0
    logs = []
    out, st = serve(full, batch=B, prompt_len=S, gen=32, seed=0,
                    log=logs.append, device=dev, params=params)
    nparam = sum(t.numel() for v in params.values() for t in (
        v.values() if isinstance(v, dict) else (v,)))
    bound_s = 4 * nparam / HBM_BYTES_PER_S       # float32 weights, one read
    print(f"[23 serve] {full.name} ({nparam / 1e9:.3f}e9 float32 params, "
          f"{4 * nparam / 1e9:.1f} GB) batch {B}, prompt {S}, gen 32: "
          f"params drawn in {t_init:.1f} s, prefill "
          f"{st['prefill_s']:.3f} s, decode {st['decode_s']:.3f} s, "
          f"{st['tok_per_s']:.1f} tokens/s (bound {B / bound_s:.0f} tokens/s:"
          f" the float32 weights read once a step, {1e3 * bound_s:.2f} ms); "
          + (f"resident {st['resident_mb']:.0f} MB, peak {st['peak_mb']:.0f}"
             f" MB (phases before it held {held:.0f} MB) " if on_card else "")
          + f"(power limit {power})", flush=True)
    o = out.cpu().numpy()
    if o.shape != (B, 33) or not ((o >= 0) & (o < full.vocab)).all():
        raise AssertionError(f"served tokens {o.shape} out of range")
    if on_card:
        profile_decode(full, params, B, S, dev)
    print(f"[23 done] phase 23 in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return dict(st, nparam=nparam, bound_tok_s=B / bound_s, cache=(
        d_max, d_mean), cpu=(c_max, c_mean))


def profile_decode(cfg, params, B: int, S: int, dev, steps_n: int = 3):
    """``steps_n`` decode steps of the served model under `torch.profiler`
    (after a prefill and two warm steps): the device's busy share of the
    window and its time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import steps

    toks = torch.zeros((B, S), dtype=torch.int32, device=dev)
    cache = steps.init_cache(cfg, B, S + 2 + steps_n, device=dev)
    _, pc = steps.make_prefill(cfg)(params, {"tokens": toks})
    cache["k"][:, :, :S], cache["v"][:, :, :S] = pc["k"], pc["v"]
    cache["pos"] = S
    dec = steps.make_decode_step(cfg)
    last = toks[:, -1:]
    for _ in range(2):
        _, cache = dec(params, cache, last)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps_n):
            _, cache = dec(params, cache, last)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, busy, by_name = device_activity(prof)       # µs
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"[23 profile] {steps_n} decode steps in {1e3 * wall:.1f} ms "
          f"(profiled): {len(spans)} device activities, busy "
          f"{busy / 1e3:.1f} ms (share {busy / 1e6 / wall:.3f}); by kernel "
          f"ms: " + "; ".join(f"{n[:70]} {t / 1e3:.2f}" for n, t in top),
          flush=True)


def lm_step_flops(cfg, B: int, S: int) -> tuple[float, float]:
    """(bf16, float32) multiply-add FLOPs of one train step from the
    shapes: the layers' projections and the one-hot embedding product
    run in bfloat16; the logits and the attention scores in float32
    (the reference's float32 products of bf16 operands).  Forward once,
    the layers again under remat, backward twice each product (the
    one-hot embedding product once: its one-hot takes no gradient)."""
    D, Hq, Hk, hd, ff = (cfg.d_model, cfg.n_heads_padded, cfg.n_kv, cfg.hd,
                         cfg.d_ff)
    V, n = cfg.vocab_padded(1), B * S
    proj = 2 * n * D * (2 * Hq * hd + 2 * Hk * hd + 3 * ff)   # per layer
    attn = 2 * 2 * B * Hq * S * S * hd                       # per layer
    emb = logits = 2 * n * V * D
    bf16 = cfg.L * proj * 4 + emb * 2
    f32 = cfg.L * attn * 4 + logits * 3
    return float(bf16), float(f32)


def lm_train_phase(args, dev, on_card: bool, power: str) -> int:
    """Phase 24: LM training (`repro_torch.launch.train.train_loop`) at
    qwen3-0.6b's full width; the card against the CPU on a 2-layer cut;
    the simLSH softmax; a straggler microbatch dropped.  → the
    `segment_add` launches of its main path (the simLSH arm)."""
    import dataclasses
    import shutil

    from repro_torch import prng
    from repro_torch import tree as T
    from repro_torch.configs import base as CB
    from repro_torch.core import scatter
    from repro_torch.launch import train as ltrain
    from repro_torch.models import lm, steps
    from repro_torch.models import lsh_softmax as LS
    from repro_torch.train import checkpoint as ckpt

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t_phase = time.perf_counter()
    full = CB.get("qwen3-0.6b")
    if not on_card:
        full = CB.reduced(full)                  # rehearsal size
    u = 2.0 ** -8                                # bfloat16's unit roundoff
    rng = np.random.default_rng(args.seed + 24)
    host = lambda tree: T.tree_map(lambda t: t.to("cpu", copy=True), tree)
    on_dev = lambda b: {k: v.to(dev) for k, v in b.items()}

    def tokens(cfg, B, S):
        return {k: torch.from_numpy(rng.integers(0, cfg.vocab, (
            B, S)).astype(np.int32)) for k in ("tokens", "labels")}

    # ---- (a) 2-layer cut of the full widths: the card against the CPU ----
    cut = dataclasses.replace(full, L=2, dtype="float32")
    p = lm.init_params(cut, prng.PRNGKey(0), model_shards=1, device=dev)
    hp = host(p)
    b = tokens(cut, 2, 32)
    # each leaf's gradient sums 64 tokens' terms, and the hidden states'
    # sums 151,936 vocabulary rows (p_v − y_v)·E_v: float32 fixes such a
    # sum to ~√n·2⁻²⁴ of its scale at random rounding (2.3e-5 for the
    # vocabulary sum); the card read 2.46e-6 of a leaf's max |g| (PERF.md,
    # PR 22 run 1), and TF32 products (2⁻¹¹ a product) read far above
    # 1e-4 — each leaf within 1e-4 of its own max |g|, never an absolute
    # bound
    GRAD_REL = 1e-4

    def leaf_errs(got, want):
        """[(path, card vs CPU max abs over the leaf's max |g|)]."""
        out = []
        for (path, w), a in zip(T.leaves_with_paths(want), T.leaves(got)):
            scale = float(w.abs().max())
            err = float((a.cpu() - w).abs().max())
            out.append((path, err / scale if scale > 0 else float("inf")))
        return out

    def card_vs_cpu(cfg, batch, tag):
        """One `value_and_grad` on the card and on the CPU → (loss rel,
        worst leaf, the card's gradients); raises past the bounds."""
        lc, g_dev = steps.value_and_grad(cfg, p, on_dev(batch))
        l0, g0 = steps.value_and_grad(cfg, hp, batch)
        path, worst = max(leaf_errs(g_dev, g0), key=lambda pe: pe[1])
        rel = abs(float(lc) - float(l0)) / abs(float(l0))
        if not (rel <= 1e-5 and worst <= GRAD_REL):
            raise AssertionError(f"[24 cpu] {tag}: loss card {float(lc)} vs "
                                 f"CPU {float(l0)}; gradient leaf {path} off "
                                 f"by {worst:.3g} of its max |g|")
        return float(lc), float(l0), rel, worst, g_dev, g0

    t0 = time.perf_counter()
    lc, l0, loss_rel, worst, g_dev, g0 = card_vs_cpu(cut, b, "full softmax")
    t_cpu = time.perf_counter() - t0
    # the lower-precision control: the same gradients with TF32 products
    tf_path, tf_worst = "-", float("nan")
    if on_card:
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            _, g_tf = steps.value_and_grad(cut, p, on_dev(b))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        tf_path, tf_worst = max(leaf_errs(g_tf, g0), key=lambda pe: pe[1])
        del g_tf
    # the simLSH arm: zipf labels (they repeat) and the config's own
    # candidates from a refresh of the cut's tied embedding, so both
    # gathers' backward add colliding rows (`segment_add` on the card)
    lcut = dataclasses.replace(cut, lsh_softmax=True)
    sb = ltrain.synth_batch(np.random.default_rng(args.seed), lcut, 2, 32)
    st = LS.refresh(lm.out_embedding(p, lcut), prng.PRNGKey(7))
    sb["cands"] = LS.candidates_for(st, sb["labels"].to(dev), prng.PRNGKey(9),
                                    n_cands=lcut.lsh_candidates).cpu()
    del st
    l_lsh, l0_lsh, lsh_rel, lsh_worst, *_ = card_vs_cpu(lcut, sb, "simLSH")
    rep_lab = sb["labels"].numel() - sb["labels"].unique().numel()
    rep_c = sb["cands"].numel() - sb["cands"].unique().numel()
    grads = T.tree_map(lambda t: t.cpu(), g_dev)
    upd_cpu = steps.adam_update(cut, T.tree_map(torch.clone, hp), grads,
                                steps.init_opt(cut, hp))
    upd_dev = steps.adam_update(cut, p, g_dev, steps.init_opt(cut, p))
    adam_err = max(float((a.cpu().double() - w.double()).abs().max())
                   for a, w in zip(T.leaves(upd_dev[:2]),
                                   T.leaves(upd_cpu[:2])))
    print(f"[24 cpu] {cut.name} cut to L=2 (d={cut.d_model}, ff={cut.d_ff}, "
          f"V={cut.vocab_padded(1)}), float32, B=2 S=32: loss card "
          f"{lc:.6f} vs CPU {l0:.6f} (rel {loss_rel:.3g}, limit 1e-5; CPU "
          f"{t_cpu:.1f} s with the card's); worst gradient leaf {worst:.3g} "
          f"of its max |g| (limit {GRAD_REL}); control, TF32 products on the "
          f"card: worst leaf {tf_worst:.3g} ({tf_path}); Adam update of the "
          f"card's gradients card vs CPU max abs {adam_err:.3g} (limit 1e-6)",
          flush=True)
    print(f"[24 cpu] simLSH arm, {lcut.lsh_candidates} candidates ({rep_c} "
          f"repeats) and zipf labels ({rep_lab} repeats of 64): loss card "
          f"{l_lsh:.6f} vs CPU {l0_lsh:.6f} (rel {lsh_rel:.3g}, limit 1e-5); "
          f"worst gradient leaf {lsh_worst:.3g} of its max |g| (limit "
          f"{GRAD_REL})", flush=True)
    if on_card and not tf_worst > GRAD_REL:
        raise AssertionError("the gradient bound passes TF32 products: it "
                             "does not hold the card to float32")
    if not adam_err <= 1e-6:
        raise AssertionError("the card's Adam update disagrees with the "
                             "CPU's")
    # bfloat16 compute on the card against float32 on the CPU
    bcut = dataclasses.replace(cut, dtype="bfloat16")
    p = T.tree_map(lambda t: t.to(dev), hp)
    with torch.no_grad():
        lb = float(steps.lm_loss(bcut, p, on_dev(b)))
        l32 = float(steps.lm_loss(cut, hp, b))
    print(f"[24 cpu] the card at bfloat16: loss {lb:.6f} vs the CPU's "
          f"float32 {l32:.6f}: |diff| {abs(lb - l32):.4g} (limit 4u·loss "
          f"{4 * u * abs(l32):.4g}, u = 2^-8)", flush=True)
    if not abs(lb - l32) <= 4 * u * abs(l32):
        raise AssertionError("the card's bfloat16 loss disagrees with the "
                             "CPU's float32 one")
    del p, hp, g_dev, g0, grads, upd_cpu, upd_dev, sb
    gc_collect(on_card)

    # ---- (b) the trained model at full width ----
    B, S, N_STEPS, N_TIMED = 8, 128, 20, 16
    held = torch.cuda.memory_allocated() / 1e6 if on_card else 0.0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    d = os.path.join(ROOT, "build", "chip_smoke_lm_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    logs = []
    t0 = time.perf_counter()
    params, opt, losses = ltrain.train_loop(
        full, steps_n=N_STEPS // 2, batch=B, seq=S, ckpt_dir=d,
        log=logs.append, device=dev, seed=args.seed)
    wall1 = time.perf_counter() - t0
    nparam = sum(t.numel() for t in T.leaves(params))
    peak = torch.cuda.max_memory_allocated() / 1e6 if on_card else 0.0
    resident = torch.cuda.memory_allocated() / 1e6 if on_card else 0.0
    saved = host((params, opt))
    t0 = time.perf_counter()
    got, step = ckpt.restore(d, (params, opt))
    t_restore = time.perf_counter() - t0
    same = all(torch.equal(a.cpu(), w) and a.dtype == w.dtype
               for a, w in zip(T.leaves(got), T.leaves(saved)))
    del got, saved, params, opt
    gc_collect(on_card)
    t0 = time.perf_counter()
    params, opt, more = ltrain.train_loop(
        full, steps_n=N_STEPS, batch=B, seq=S, ckpt_dir=d,
        log=logs.append, device=dev, seed=args.seed)
    wall2 = time.perf_counter() - t0
    # the step's own time: the loop's step function over batches drawn
    # beforehand, each step synchronised (median of steps 3 on)
    step_fn = steps.make_train_step(full)
    trng = np.random.default_rng(args.seed + 1)
    marks = []
    for tb in [ltrain.synth_batch(trng, full, B, S, device=dev)
               for _ in range(N_TIMED)]:
        t = time.perf_counter()
        params, opt, _ = step_fn(params, opt, tb)
        sync()
        marks.append(time.perf_counter() - t)
    losses += more
    step_s = float(np.median(marks[3:]))
    bf, f32 = lm_step_flops(full, B, S)
    adam_bytes = 28 * nparam       # p, g, m, v read; p, m, v written: 7·4 B
    b_peak = (bf + f32) / BF16_OPS_PER_S + adam_bytes / HBM_BYTES_PER_S
    b_typed = (bf / BF16_OPS_PER_S + f32 / F32_OPS_PER_S
               + adam_bytes / HBM_BYTES_PER_S)
    print(f"[24 train] {full.name} ({nparam / 1e6:.2f}e6 float32 params, "
          f"L={full.L} d={full.d_model} V={full.vocab_padded(1)}) batch {B} "
          f"seq {S}, {N_STEPS} steps in two train_loop calls (a checkpoint "
          f"at step 10, the second resumes from it): loop wall {wall1:.1f} "
          f"(the parameters' draw included) + {wall2:.1f} s (checkpoint "
          f"saves included); then {N_TIMED} steps of make_train_step, step "
          f"s median of steps 3-{N_TIMED - 1} {step_s:.4f} (min "
          f"{min(marks[3:]):.4f}, max {max(marks[3:]):.4f}), "
          f"{B * S / step_s:.0f} tokens/s; loss step 0 "
          f"{losses[0]:.4f}, step 10 {losses[10]:.4f}, step 19 "
          f"{losses[19]:.4f}; "
          + (f"after the first 10 steps resident {resident:.0f} MB, peak "
             f"{peak:.0f} MB (phases before it held {held:.0f} MB) "
             if on_card else "")
          + f"(power limit {power})", flush=True)
    print(f"[24 bound] {bf / 1e12:.3f} TFLOP in bf16 products + "
          f"{f32 / 1e12:.3f} TFLOP in float32 products (logits, attention "
          f"scores) a step, Adam {adam_bytes / 1e9:.2f} GB: all FLOPs at the "
          f"bf16 peak {BF16_OPS_PER_S / 1e12:.0f} TFLOP/s plus Adam's bytes "
          f"at {HBM_BYTES_PER_S / 1e12:.2f} TB/s {1e3 * b_peak:.2f} ms; the "
          f"float32 products at {F32_OPS_PER_S / 1e12:.0f} TFLOP/s instead "
          f"{1e3 * b_typed:.2f} ms; the step took {1e3 * step_s:.2f} ms",
          flush=True)
    print(f"[24 ckpt] step {step} restored in {t_restore:.1f} s: every leaf "
          f"equal to the state saved at step 10: {same}", flush=True)
    if not (same and step == N_STEPS // 2
            and f"resumed from step {N_STEPS // 2}" in logs):
        raise AssertionError("the step-10 checkpoint did not restore bit "
                             "for bit")
    if not (np.isfinite(losses).all() and losses[19] < losses[10]
            < losses[0]):
        raise AssertionError(f"the full-width loss did not fall: {losses}")
    b = on_dev(ltrain.synth_batch(np.random.default_rng(1), full, B, S))
    if on_card:
        profile_train_step(full, params, opt, b)
    shutil.rmtree(d, ignore_errors=True)

    # ---- (d) straggler: µ = 2, microbatch 1 dropped ----
    mcfg = dataclasses.replace(full, microbatches=2)
    with torch.no_grad():
        loss0 = float(steps.lm_loss(full, params, {k: v[:B // 2]
                                                   for k, v in b.items()}))
    _, opt, aux = steps.make_train_step(mcfg)(params, opt, dict(
        b, mb_mask=torch.tensor([1.0, 0.0], device=dev)))
    rel = abs(float(aux["loss"]) - loss0) / abs(loss0)
    print(f"[24 straggler] microbatches=2, mb_mask [1, 0]: step loss "
          f"{float(aux['loss']):.6f} vs microbatch 0 alone {loss0:.6f} (rel "
          f"{rel:.3g}, limit 1e-4)", flush=True)
    if not rel <= 1e-4:
        raise AssertionError("the straggler step's loss is not microbatch "
                             "0's")
    del params, opt, b
    gc_collect(on_card)

    # ---- (c) the simLSH softmax at full width ----
    lcfg = dataclasses.replace(full, lsh_softmax=True)
    C = lcfg.lsh_candidates
    params = lm.init_params(lcfg, prng.PRNGKey(args.seed), model_shards=1,
                            device=dev)
    opt = steps.init_opt(lcfg, params)
    step_fn = steps.make_train_step(lcfg)
    brng = np.random.default_rng(args.seed)
    batches = [ltrain.synth_batch(brng, lcfg, B, S, device=dev)
               for _ in range(N_STEPS)]
    # full cover: the candidates are the whole vocabulary
    V = lcfg.vocab_padded(1)
    with torch.no_grad():
        cover = float(steps.lm_loss(lcfg, params, dict(
            batches[0], cands=torch.arange(V, dtype=torch.int32,
                                           device=dev))))
        whole = float(steps.lm_loss(full, params, batches[0]))
    print(f"[24 lsh] cands = all {V} ids: simLSH loss {cover:.6f} vs the "
          f"full softmax {whole:.6f} (|diff| {abs(cover - whole):.3g}, "
          f"limit 1e-3)", flush=True)
    if not abs(cover - whole) < 1e-3:
        raise AssertionError("the full-cover simLSH loss is not the full "
                             "loss")
    scatter.LAUNCHES = 0           # the main path: 20 simLSH steps
    t0 = time.perf_counter()
    lsh_losses, t_refresh = [], 0.0
    for s_, b in enumerate(batches):
        if s_ % 10 == 0:
            t1 = time.perf_counter()
            st = LS.refresh(lm.out_embedding(params, lcfg),
                            prng.fold_in(prng.PRNGKey(7), s_))
            sync()
            t_refresh += time.perf_counter() - t1
        b["cands"] = LS.candidates_for(st, b["labels"], prng.fold_in(
            prng.PRNGKey(9), s_), n_cands=C)
        params, opt, aux = step_fn(params, opt, b)
        lsh_losses.append(float(aux["loss"]))
    sync()
    wall = time.perf_counter() - t0
    seg = scatter.LAUNCHES
    print(f"[24 lsh] {N_STEPS} steps with {C} candidates, refresh of the "
          f"{V} x {lcfg.d_model} tied embedding every 10 steps ({t_refresh:.2f}"
          f" s for 2): {wall:.2f} s, loss {lsh_losses[0]:.4f} -> "
          f"{lsh_losses[10]:.4f} -> {lsh_losses[-1]:.4f}; segment_add "
          f"launches {seg}", flush=True)
    if not (np.isfinite(lsh_losses).all()
            and lsh_losses[-1] < lsh_losses[0]):
        raise AssertionError(f"the simLSH loss did not fall: {lsh_losses}")
    if on_card and seg < 2 * N_STEPS:
        raise AssertionError("segment_add did not launch on the simLSH path")
    # bit-reproducible: 3 steps twice from the same state
    runs = []
    for _ in range(2):
        pr, orun = T.tree_map(torch.clone, (params, opt))
        for b in batches[:3]:
            pr, orun, _ = step_fn(pr, orun, b)
        runs.append(pr)
    equal = all(torch.equal(a, w) for a, w in zip(*map(T.leaves, runs)))
    print(f"[24 lsh] 3 steps run twice from one state: parameters "
          f"bit-equal: {equal}", flush=True)
    if not equal:
        raise AssertionError("two simLSH runs from one state differ")
    # segment_add at both of this path's shapes against its plain version:
    # the candidate gather's backward and the label gather's (B·S zipf
    # labels: long segments of the frequent tokens)
    E = lm.out_embedding(params, lcfg)
    gen = torch.Generator().manual_seed(0)
    for what, ids in (("candidate", batches[0]["cands"]),
                      ("label", batches[0]["labels"])):
        ids = ids.reshape(-1).long()
        gsrc = torch.randn((ids.numel(), E.shape[1]), generator=gen).to(dev)
        got = scatter.index_add_det_(torch.zeros_like(E), ids, gsrc)
        want = torch.zeros(E.shape).index_add_(0, ids.cpu(), gsrc.cpu())
        run = int(torch.bincount(ids).max())
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"segment_add differs from index_add_ at "
                                 f"the {what} gather's shape")
        print(f"[24 lsh] segment_add at the {what} gradient's shape "
              f"({ids.numel()} rows of {E.shape[1]} into {V}, longest "
              f"segment {run}) bit-equal to the CPU's index_add_",
              flush=True)
    del params, opt, runs, batches, E, gsrc, got, want
    gc_collect(on_card)
    print(f"[24 done] phase 24 in {time.perf_counter() - t_phase:.1f} s "
          f"(power limit {power})", flush=True)
    return seg


def gc_collect(on_card: bool) -> None:
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()


def profile_train_step(cfg, params, opt, batch) -> None:
    """One full-width train step under `torch.profiler` (after the loop's
    warm steps): the device's busy share of the window and its three
    largest costs by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import steps

    step_fn = steps.make_train_step(cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(params, opt, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, busy, by_name = device_activity(prof)       # µs
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    print(f"[24 profile] one train step in {1e3 * wall:.1f} ms (profiled): "
          f"{len(spans)} device activities, busy {busy / 1e3:.1f} ms (share "
          f"{busy / 1e6 / wall:.3f}); largest device costs ms: "
          + "; ".join(f"{n[:70]} {t / 1e3:.2f}" for n, t in top),
          flush=True)


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
    from repro_torch.kernels.candidate_score.ref import (assert_topn_close,
                                                        score_topn_ref)
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
        entry = ""                       # ptxas: registers and spills
        for line in _build.build_log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
            elif "registers" in line or "spill" in line:
                print(f"[2 build] {entry}: {line.strip()}", flush=True)

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
    # the kernel walk: what impl="auto" resolves to on the card, named so
    # that the CPU rehearsal walks the same way through the kernels'
    # plain versions (its "auto" there is the plain walk)
    cfg = ServeConfig(topn=10, micro_batch=256, C=768, n_seeds=16, cap=8,
                      n_popular=64, tile_b=16, band_budget=768, impl="cuda")
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
    masked = cand.clone()
    masked[:8] = SENTINEL               # all-SENTINEL rows
    b_odd = B - 6                       # not a multiple of tile_b
    planes = (svc.planes.row, svc.planes.mu, svc.planes.col)
    sc_args = (*planes, users, cand)
    score_err = 0.0
    for args_, topn in ((sc_args, cfg.topn), ((*planes, users, masked),
                                               cfg.topn),
                        ((*planes, users[:b_odd], cand[:b_odd]), cfg.topn),
                        (sc_args, 50)):
        score_err = max(score_err, assert_topn_close(
            *score_kernel.score_topn(*args_, topn=topn),
            *score_topn_ref(*args_, topn=topn, tile_b=cfg.tile_b)))
    print(f"[4 check] candidate_score (score_topn: user rows, mu, ids, "
          f"top-N, items) within 1e-5 (max abs err {score_err:.3g}) at "
          f"B={B} C={cfg.C} F={F} topn={cfg.topn}, with 8 all-SENTINEL rows, "
          f"B={b_odd}, and topn=50 (two selection passes)", flush=True)

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
    if st["fallbacks"]:
        raise AssertionError("a flush fell back to full_topn")
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
    lsh_graph = graph_ms(lambda: lsh_kernel.lsh_retrieve_topc(
        *lsh_args, C=core_C, cap=cfg.cap), dev, n=20, reps=10)
    lsh_plain = median_ms(lambda: lsh_retrieve_topc_ref(
        *lsh_args, C=core_C, cap=cfg.cap), dev)
    # bytes: descriptors + extras + exclude read once, the valid window
    # slots read once, the [B, C] output written once; operations: the
    # n·log2(n) comparisons of one sort of the Wp-wide pool
    lsh_bytes = 4 * (2 * B * I + B * X + E + int(lens.sum()) + B * core_C)
    lsh_bound, lsh_by = bound_ms(lsh_bytes, B * Wp * np.log2(Wp))
    score = lambda: score_kernel.score_topn(*sc_args, topn=cfg.topn)
    sc_ms = median_ms(score, dev)
    sc_graph = graph_ms(score, dev, n=20, reps=10)
    sc_plain = median_ms(lambda: score_topn_ref(
        *sc_args, topn=cfg.topn, tile_b=cfg.tile_b), dev)
    # bytes: the user ids and rows, μ and the candidate ids read once, one
    # plane row per non-SENTINEL slot, the outputs written once;
    # operations: a multiply-add per factor plus two bias adds per slot
    n_valid = int((cand != SENTINEL).sum())
    sc_bytes = 4 * (B + B * (F + 1) + 1 + B * cfg.C + n_valid * (F + 1)
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
    for name, graph, cold in (("lsh_retrieve", lsh_graph, lsh_ms),
                              ("candidate_score", sc_graph, sc_ms)):
        print(f"[7 time] {name}: {graph:.4f} ms per call in a CUDA graph of "
              f"20 calls (warm L2, median of 10 replays) beside the "
              f"{cold:.4f} ms cold-L2 reading", flush=True)

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
    octx = online_phase(args, ctx, cfg, dev, on_card, power)
    kernels.append(resil_phase(
        args, octx, dict(params=params, sp=sp, sigs=sigs, cfg=cfg,
                         p5=(st["p50_ms"], st["p99_ms"])),
        dev, on_card, power))
    loop_phase(args, octx, cfg, dev, on_card, power)
    comparators_phase(args, ctx, dev, on_card, power)
    serve = dict(params=params, sp=sp, sigs=sigs, cfg=cfg, probe=probe,
                 exact=exact, probe_items=got_p, recall=recall,
                 key=prng.PRNGKey(args.seed, device=dev))
    serve["plain_recall"] = serve_paths_phase(args, serve, dev, on_card,
                                              power)
    shard_phase(args, serve, ctx, dev, on_card, power)
    table10_phase(args, dev, on_card, power)
    examples_phase(args, dev, on_card, power)
    lm_phase(args, dev, on_card, power)
    seg24 = lm_train_phase(args, dev, on_card, power)
    for k in kernels:                  # phase 16's main path and phase 24's
        if k["name"] == "segment_add":
            print(f"[24 kernels] segment_add launches: phase 16 "
                  f"{k['launches']}, phase 24 {seg24}", flush=True)
            k["launches"] += seg24
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
