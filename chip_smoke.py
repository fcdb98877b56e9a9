#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main paths — serving, the offline
fit, the simLSH encoder, the legacy fit with checkpoints, batch scoring,
online learning, its resilience layer, the always-on loop, the fit's
neighbour comparators, the other serving paths, the multi-device tiers,
the Table-10 comparison with the NCF models, the examples, dense LM
serving and training, the ssm and hybrid LM families, moe LM serving
and training, encdec and vlm LM serving and training, and bfloat16
parameters serving llama3-405b and arctic-480b and training them in
bfloat16 parameters, gradients and moments, the analytic roofline
of every config × shape cell on meta tensors, and the dry run of every
cell on a meta 16 × 16 mesh with one serving cell's peak measured — on
one CUDA card.

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
   M, N and 2,000,000 ratings (10 % held out; made on the host in a
   worker thread beside phases 2–4), with each stage of `fit` timed on
   the card (encode, Top-K, the host scheduler, the
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
    epochs), one epoch of the same fit on the plain steps (its RMSE
    within 1e-3 of the kernel fit's first),
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
    submits 2 × 256 users (a quarter new ids) and the first offers a ΔΩ
    (phase 16's recipe; a sixth of the held-out ratings).  A 3-slice
    reference arm (`LOOP_SLICES`; 6 slices and a ΔΩ on each even one
    until phase 33 needed the script's time), the counters zeroed
    just before (one `lsh_retrieve` and one `candidate_score` launch a
    scored flush or warm-up; each slice's first flush against the plain
    versions), its states' leaf SHA-256 kept by seq; a drift trip forced
    on it (``drift_tol`` −0.5), whose requested rebuild of the fit's
    8-bit catalog ends as the validation gate says; then three arms
    killed at ``loop.slice`` call 2, ``loop.ckpt`` call 0 and
    ``loop.drift`` call 0 (0-based; 3, 1 and 1 with 6 slices), each
    recovered by `OnlineLoop.recover` to the
    reference's hashes at its seq and run one more slice with nothing
    dropped; the span seconds, staleness p99 and the time to recover
    (restore, WAL replay, `build_service` and warm-up);
18. comparators — `fit(use_kernels=True)` with ``rand``, ``rp_cos`` and
    ``minhash`` beside ``simlsh`` on phase 8's data and model for 2
    epochs, and ``gsm`` beside ``simlsh`` at `MOVIELENS_LIKE`'s M × N
    (69,878 × 10,677; 5·10⁵ ratings) with the paper's Table-7 settings
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
    tier's cells, share of the ratings and MB; one epoch (two before
    phase 29 took the script's time) through the mesh and through the
    one-device replay from one state (every leaf and the test RMSE
    within 1e-5), its shard tier timed alone;
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
    its default size, the seven at once (``torch_train_lshmf_100m --small``; the serving
    example also with ``--online-loop --slices 3``; the LM example in
    both arms, 10 steps each): exit 0, its last lines, and its ``--report`` line's
    launch counters (`culsh_sgd` in every LSH-MF one; `lsh_retrieve` and
    `candidate_score` in the serving ones; `segment_add` in the LM
    example's ``--lsh-softmax`` arm)
    and, for the serving example, its kernel walk held against the
    kernels' plain versions on one probe flush of its own shapes;
23. dense LM serving — `repro_torch.launch.serve.serve` at llama3-8b's
    full width cut to 8 of its 32 layers (16 until phase 31; 2.8·10⁹
    float32 parameters
    drawn on the card), batch 4, prompt 64, 32 decoded tokens: prefill
    and decode seconds, tokens/s beside the bound of reading the float32 weights
    once a step, resident and peak MB; on a 2-layer cut of the same
    widths, prefill's last-position logits against a 64-step decode (the
    KV cache) and the card's bfloat16 prefill against the CPU's float32,
    each within a stated multiple of bfloat16's unit roundoff.
24. LM training — on a 2-layer cut of qwen3-0.6b's widths (V = 151,936)
    one float32 train step on the card against the CPU (loss 1e-5
    relative, each gradient leaf within 1e-4 of its own max |g| and a
    TF32 control above it, Adam of the card's gradients 1e-6) and the
    card's bfloat16 loss within 4u of the CPU's float32 one;
    `repro_torch.launch.train.train_loop` at full width cut to 4 of the
    28 layers (7 until phase 34; 2.18·10⁸ float32 parameters, batch 8 ×
    seq 128, the
    reference CLI's) for 20 steps in two calls, the second resuming from the first's
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
25. the ssm and hybrid LM families — on 2-layer cuts of mamba2-370m's
    and zamba2-7b's full widths: a 64-step bfloat16 decode against the
    forward at every position and prefill's last-position logits (the
    SSM and conv states), the card's bfloat16 forward against the CPU's
    float32 one, `ssd_chunked` at chunk 64 against 256 (S = 256,
    float32, the JAX test's 1e-4), each limit beside a control that must
    read above it (the conv state dropped each step; each chunk alone);
    `repro_torch.launch.serve.serve` at full width (both cut to 6
    layers — mamba2-370m of its 48, zamba2-7b of its 81, one of its 14
    groups; 12 until phase 34; batch 4, a 64-token prompt
    prefilled by sequential decode, 32 tokens): draw, prefill and decode
    seconds, tokens/s beside the bound of reading the weights once a
    step, resident and peak MB, a profiled decode step; mamba2-370m
    trained at full width cut to L = 6 of 48 (12 until phase 34; for
    the script's time) through `train_loop` (batch 8 × 128, lr 3e-4,
    20 steps in two calls, the second resuming from a step-10
    checkpoint restored bit for bit, the loss falling), the step timed
    over batches drawn beforehand; zamba2-7b
    cut to L = 12 (24 until phase 34; µ = 2, lr
    1e-4) for 5 steps, the loss falling, its peak MB; card-vs-CPU
    gradients on each model's 2-layer cut (each leaf within 1e-4 of its
    max |g|, a TF32 control above it).  None of the seven kernels
    launches in this phase.
26. the moe LM family's serving half — on a 2-layer cut of dbrx-132b's
    full widths (16 experts of d_ff 10,752, top 4; B 2, S 32), the
    routes of every (token, layer) read from a layer loop composed of
    the package's sub-layers, `moe.router` and `moe.moe_dense_ref` (and
    held equal to `lm.forward`): at float32 the card's routes equal the
    CPU's and its logits within 2e-4·rms (the smallest top-k gap
    printed; a TF32 control above the limit); the card's bfloat16
    forward routes first (the share of routes that agree, with a floor)
    and its logits then against the CPU's float32 forward on the card's
    routes (64u·rms / 8u·rms; the CPU's own routes the control);
    prefill's last-position logits against a float32-cache decode (a
    cache-zeroed control); reduced arctic-480b (top 2 of 4, the dense
    residual MLP) card vs CPU; then dbrx-132b served at full width cut
    to L = 1 (4.49·10⁹ float32 parameters) through
    `repro_torch.launch.serve.serve` (batch 4, prompt 64, 32 tokens):
    draw, prefill and decode seconds, tokens/s beside the bound of
    reading the weights of the routed experts, the attention and both
    embedding tables once a step, the distinct experts a layer a step
    (a replay of the served run), resident and peak MB, a profiled
    decode step.  None of the seven kernels launches in this phase.
27. the moe LM family's training half — at dbrx-132b's d and d_ff, a
    router and 4 experts, top 2 (random weights, 64 tokens) forward and
    backward at float32, card vs CPU (routes equal, the output and each
    gradient within 1e-4 of its own max, a TF32 control above it),
    and the whole `lm_loss` on "dbrx-132b:16x4" at L = 1 (routes, loss
    1e-5, gradients 1e-4 of each leaf's max with a TF32 control, an
    Adam update 1e-6); then dbrx-132b trained at full width cut to L = 1
    (4.49·10⁹ float32 parameters, its own µ = 4, bfloat16 moments,
    float32 gradients) through `repro_torch.launch.train.train_loop`
    for 10 steps at batch 8 × 128, the loss falling, 3 synchronised
    `make_train_step` steps (5 until phase 31) timed beside their
    bound, the distinct
    experts a microbatch, resident and peak MB (≤ 70,000), a profiled
    step, and the loop run again from the seed's draw with every loss
    and each leaf's bit sums equal; a bfloat16-moment checkpoint of
    reduced dbrx-132b at µ = 4 (step 5 of 10 under
    ``build/chip_smoke_moe_ckpt``, removed) restored bit for bit and
    resumed as the same state stepped in memory; reduced arctic-480b's
    train step card vs CPU.  None of the seven kernels launches.
28. the encdec and vlm LM families' serving half — on a 2-layer cut of
    seamless-m4t-large-v2's full widths (2 encoder + 2 decoder layers,
    B 2, 128 frame embeddings, 64 tokens) the forward's logits card vs
    CPU at float32 (2e-4·rms, a TF32 control above it) and in bfloat16
    against the CPU's float32 (32u·rms / 8u·rms, the cross-attention's
    ``wo`` zeroed the control), 64 teacher-forced `decode_encdec` steps
    on cross caches filled from the encoder's K/V card vs CPU, and
    decode = forward on the card in bfloat16 (16u·rms / 4u·rms; zero
    cross caches, what `serve` decodes on, the control); on a 2-layer
    cut of llava-next-mistral-7b's (B 2, a 64-patch prefix, 64 tokens)
    `prefill_dense` card vs CPU (logits, ``pos``, the K/V; the prefix
    dropped the bfloat16 control); then both served at full width and
    half their depth (seamless 12 + 12 layers; full depth until phase 30
    took the script's time), llava at 8 of 32 (16 until phase 31) through
    `repro_torch.launch.serve.serve` (batch 4, prompt
    64, 32 tokens; seamless prefilled by sequential decode on zero
    cross caches, as the reference serves it): draw, prefill and decode
    seconds, tokens/s beside the bound of reading the decoder side's
    float32 weights once a step, resident and peak MB, a profiled
    decode step; and llava behind `VLM_PATCHES` = 2,880 stub patches:
    prefill and decode on a T = 2,976 cache, the last step against the
    float32 forward on row 0 (the served bfloat16 decode within twice
    the bfloat16 forward's distance, a float32 step within half of it,
    each beside a control).  None of the seven kernels launches.
29. the encdec and vlm LM families' training half — on the same
    2-layer cuts at full width (B 2 × 16 tokens behind 16 frames or 16
    patches), float32, the card against the CPU: seamless's
    `value_and_grad` and llava's µ = 2 train step (its accumulated
    gradient, ``frontend_embeds`` split with the tokens) — the loss
    within 1e-5, each gradient leaf within 1e-4 of its own max with a
    TF32 control above it —, on the seamless cut an Adam update of the
    card's gradients over the tree without its embedding tables within
    1e-6 and remat on = off bit for bit; then seamless-m4t-large-v2
    trained at full width and depth (2.03·10⁹ float32 parameters)
    through `repro_torch.launch.train.train_loop` for 10 steps at batch
    8 × 128 behind 128 frames, the loss falling, 3 synchronised
    `make_train_step` steps timed beside their bound; a checkpoint of
    reduced seamless's nested tree (step 5 of 10 under
    ``build/chip_smoke_encdec_ckpt``, removed) restored bit for bit and
    resumed as the same state stepped in memory; llava-next-mistral-7b
    trained at full width cut to L = 14 of 32 (3.32·10⁹ parameters, its
    own µ = 2, 16 stub patches, lr 1e-4) for 10 steps, 3 timed steps
    beside their bound, the training's own peak ≤ 70,000 MB, a profiled
    step.  None of the seven kernels launches.
30. bfloat16 parameters — the card's 128-value table of bfloat16
    normal draws against the CPU's; llama3-405b at full width cut to L
    = 4 of 126 (1.69·10¹⁰ bfloat16 parameters, 33.9 GB) and arctic-480b
    at full width cut to L = 1 of 35 (1.41·10¹⁰, 28.1 GB) — L = 8 and L
    = 2, the depths one card holds beside serving (59.41 and 55.36 GB),
    until phase 31 took the script's time —,
    each drawn on the card by `lm.init_params` in its config's
    bfloat16, one full-width leaf of layer 0 bit-equal to the CPU's draw
    (llama's ``wk``; arctic's ``w1`` of expert 0 and its last 2²⁰
    draws, past index 2³²), served through
    `repro_torch.launch.serve.serve` (batch 4, prompt 64, 32 tokens):
    draw seconds and rate, prefill and decode seconds, tokens/s beside
    the bound of reading the bfloat16 weights once a step (arctic's
    from the experts a replay counts), resident and own peak MB (≤
    70,000), a profiled decode step's busy share and copy kernels; then
    layer 0 of each served tree as a 1-layer model at full width (B 2 ×
    S 8): the card's bfloat16 logits against the CPU's float32 forward
    (arctic's routes first, its values on the card's routes; phase 23's
    and 26's limits, layer 0's ``wo`` zeroed the control).  The CPU's
    halves run in a worker thread beside the card's draws; nothing is
    written to disk, and none of the seven kernels launches.
31. training with bfloat16 parameters, gradients and moments — (a) on
    one-layer cuts at float32 compute, µ = 2 (`bf16_train_cuts`:
    llama3-405b's d_model with 16 of its heads, d_ff 4,096 and a 4,096
    vocabulary; arctic-480b's d_model, 4 experts of its full d_ff, its
    dense residual MLP, 8 heads and a 4,096 vocabulary), the card
    against the CPU from the same state: arctic's routes first, the loss
    within 1e-5, each leaf of the bfloat16 gradient sum within 8u of
    its max (a dropped microbatch the control), and the CPU's Adam of
    the card's sum against the card's update, word for word; the CPU's
    halves in a worker thread beside (b)–(d); (b) llama3-405b at full
    width cut to L = 1 of 126 (7.39·10⁹ parameters, 59.12 GB of
    parameters, gradient sum and moments) and (c) arctic-480b at full
    width cut to L = 1 of 35 with 64 of its 128 experts (7.38·10⁹, 59.00
    GB), each in its own bfloat16 dtypes and µ = 8, through
    `repro_torch.launch.train.train_loop` (3 steps, batch 8 × 128), then
    3 synchronised `make_train_step` steps: init s, step s and tokens/s
    beside the bound, the loss falling, resident and own peak MB (≤
    75,000), a profiled step, arctic's distinct experts a microbatch; (d)
    a checkpoint of reduced arctic-480b in bfloat16 throughout (step 2
    of 4 under ``build/chip_smoke_bf16_ckpt``, removed) restored bit for
    bit and resumed as the same state stepped in memory.  None of the
    seven kernels launches.
32. the analytic roofline on meta tensors (`launch/specs.py`,
    `launch/roofline.py`), a few seconds, no kernel and nothing
    allocated on the card: (a) the ten configs' parameter trees at full
    depth on the meta device at ``model_shards`` 1 and 16, each timed;
    (b) every runnable config × `SHAPES` cell at one card's axes
    (``ndp = ntp = 1``): `model_flops`, `analytic_hbm_bytes` and the
    H100 roofline's compute, memory and step times and its bound; (c)
    every tree phases 23–31 drew (`lm.init_params`, logged with its
    phase, config cut and ``model_shards``): `param_counts` of that cut
    must equal the drawn tree's parameters exactly; (d) the six timed
    training cells (phases 24, 27, 29 × 2, 31 × 2): the roofline's step
    time at the phase's own cut and shape beside the phase's own bound
    and its measured step; (e) llama3-8b's full-width dense forward and
    logits counted by `FlopCounterMode` on meta tensors at B 1 × S 128
    and at the prefill_32k cell, beside `model_flops` and the count's
    derivation (`dense_forward_flops`).
33. (run between phases 30 and 31, on phase 30's arctic-480b tree) the
    LM mesh: arctic-480b at full width cut to L = 1 with all 128 experts
    served on a logical 2 × 4 ("data", "model") mesh of the card
    (`launch/mesh.py`, `REPRO_TORCH_LOGICAL_DEVICES=8`): `make_prefill`
    on `serve`'s request (the a2a dispatch, capacity 2.0), 32 greedy
    steps of `make_decode_step` (the replicated dispatch and its psum),
    one prefill with ``moe_ep2d``; the kept and dropped slots of each
    dispatch, prefill s and decode tokens/s beside the bound of reading
    the expert stack once a data row a step, a profiled decode step, own
    peak MB; `segment_add` counted on the served path (the combine's
    scatter-add, one launch a cell a dispatch).  First a one-layer cut
    (d_model kept, 8 heads, V 2,048, 16 experts of d_ff 1,024, capacity
    0.75, so slots drop) on the same mesh of the card and of the CPU,
    the CPU's runs in a worker thread beside the card's: for the a2a
    prefill, a decode step behind the card's prefill caches (the
    replicated dispatch) and the ep2d prefill routes, then kept-slot
    masks, then float32 logits 1e-4 of their max; a train step (loss
    1e-5, first moments 1e-4 of each leaf's max); TF32 controls above
    the prefill's and the step's limits; bfloat16 logits within 64u·rms
    / 8u·rms of the CPU's float32 on the card's routes, ``wo`` zeroed
    the control —, every card run twice, bit-equal.
34. the dry run (`launch/dryrun.py`, `perf.py`, `report.py`), no kernel:
    (a) ``python -m repro_torch.launch.dryrun --all --roofline`` in a
    subprocess started before phase 3 with one thread and no card,
    beside the card phases, collected here: 40 records on the 16 × 16
    meta mesh, 32 OK and 8 SKIP with the configs' reasons; every OK
    record's per-chip products > 0 and its `model_flops_global` /
    `hbm_bytes_per_chip` `==` `roofline.py`'s analytic functions; the
    moe cells' counted collective bytes `==` their formula (printed);
    llama3-8b prefill_32k's composed products `==` one count of the
    whole step at full depth; both `report.py` tables and the sweep's
    wall time.  (b) `perf.run("llama3-8b", "decode_32k", L=2,
    do_mem=True)`: the cut drawn and stepped once on the card, its
    measured peak beside its meta argument bytes (peak ≥ arguments,
    temporaries = the difference), in at most 30 s.

The second-last line is a JSON object listing the kernels; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA card the script
exits non-zero before printing any result.  ``--device cpu --n-items
20000 --fit-scale 0.01`` rehearses phases 3–34 on the CPU with the plain
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
# phase 17's stream: slices of the reference arm and of each killed arm,
# a ΔΩ on the first, and the (0-based) fault-site calls the arms die at
# (6 slices, a ΔΩ on each even one, kills at calls 3, 1 and 1 until
# phase 33 needed the script's time)
LOOP_SLICES = 3
LOOP_KILLS = (("loop.slice", 2), ("loop.ckpt", 0), ("loop.drift", 0))
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
# phase 18's GSM data: MOVIELENS_LIKE's M × N with 5·10⁵ of its 9,900,054
# ratings (10⁶ until phase 30 took the script's time; the host generator's
# oversampling grows faster than linearly: 2·10⁶ took 79 s on the card's
# host, 10⁶ 24.5–28.8 s; GSM's dense operands and products depend on M × N
# only)
GSM_NNZ = 500_000
# phase 28: llava-next's stub image prefix, anyres at 5 tiles of 576
# patches (the JAX package's `launch/specs.py` VLM_PATCHES)
VLM_PATCHES = 2880
# phase 25's depths at full width: both served at 6 layers, mamba2-370m
# trained at 6 for 20 loop steps (a checkpoint at step 10), zamba2-7b at
# 12 (served at 12 and 12, trained at 12 and 24, until phase 34 needed
# the script's time).  Not fewer steps: a resumed loop draws the seed's
# first batches again, so over 10 steps the loss after the resume need
# not fall (it read 5.632 at step 5, 5.679 at step 9)
SSM_SERVE_L, SSM_TRAIN_L, SSM_STEPS, ZAMBA_TRAIN_L = 6, 6, 20, 12
# phase 32 reads the timed training cells of phases 24, 27, 29 and 31
TIMED_CELLS: list = []
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


def sm_clock() -> float:
    """The card's maximum SM clock in MHz (`nvidia-smi`)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


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


def fit_data(args) -> tuple:
    """Phase 8's ratings: `synthetic.generate` at the fit's size, split
    90 / 10, all on the host (numpy) → (train, test, seconds).  `main`
    runs it in a worker thread beside the build and phases 3–4, which
    time nothing."""
    import dataclasses

    from repro_torch.data import synthetic
    from repro_torch.data.sparse import train_test_split

    t0 = time.perf_counter()
    spec = dataclasses.replace(
        synthetic.MOVIELENS_LIKE, M=max(1, int(FIT_M * args.fit_scale)),
        N=max(1, int(FIT_N * args.fit_scale)),
        nnz=int(FIT_NNZ * args.fit_scale))
    rows, cols, vals, _ = synthetic.generate(spec, seed=args.seed)
    tr, te = train_test_split(np.random.default_rng(args.seed), rows, cols,
                              vals)
    return tr, te, time.perf_counter() - t0


def fit_phases(args, data: tuple, dev, on_card: bool, power: str) -> list:
    """Phases 8–11: the offline CULSH-MF fit (`train.trainer.fit`) at the
    width of the repo's ~100M-parameter model, on ``data`` (`fit_data`'s);
    → (the two fused steps' entries of the kernels line, the state phases
    13–14 go on from)."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import prng
    from repro_torch.core import model, scatter, sgd, simlsh, topk
    from repro_torch.data.sparse import conflict_free_schedule, from_coo
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
    F, K = FIT_F, FIT_K
    # one shard: these phases' launch counts must not depend on how many
    # cards the machine has (phase 20 runs the shard tier)
    cfg = FitConfig(F=F, K=K, epochs=FIT_EPOCHS, method="simlsh",
                    lsh=simlsh.SimLSHConfig(G=8, p=1, q=10, band_cap=16),
                    seed=args.seed, use_kernels=True, shards=1)
    tr, te, secs["data (beside phases 2-4)"] = data
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
    # the plain steps for one epoch, held to the kernel fit's first: the
    # learning rate decays by the epoch's index, so epoch 0 of a longer
    # fit is the same epoch
    plain = fit(tr, te, (M, N), dataclasses.replace(cfg, use_kernels=False,
                                                     epochs=1),
                log=log("plain"), device=dev)
    rp = [h[2] for h in plain.history]
    print(f"[10 fit] rmse with kernels {rm}; plain steps {rp}; epoch 0 "
          f"difference {abs(rm[0] - rp[0]):.3g} (limit 1e-3)", flush=True)
    if not abs(rm[0] - rp[0]) <= 1e-3:
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

        prof_events = []    # each profile's device (name, µs)

        def profiled(run, *a):
            sync()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run(*a)
                sync()
                wall_us = (time.perf_counter() - t0) * 1e6
            prof_events.append([
                (e.name, e.time_range.end - e.time_range.start)
                for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA])
            return wall_us, device_activity(prof)

        def launches_of(spans_by_name, part):
            """(launches, µs) of the device kernels whose name holds
            ``part`` (case-insensitive)."""
            hits = [v for n, v in spans_by_name.items()
                    if part in n.lower()]
            return sum(k for k, _ in hits), sum(us for _, us in hits)

        for name, state, data_, mf_only in (
                ("culsh_sgd", model.pack_params(res.params), sd, False),
                ("mf_sgd", model.pack_params(mf.params), sd_mf, True)):
            seg0 = (scatter.LAUNCHES, scatter.GROUP_LAUNCHES, scatter.SORTS)
            wall_us, (spans, busy, by_name) = profiled(epoch, state, data_,
                                                       mf_only)
            mine = [us for n, us in by_name.items() if kernel_of[name] in n]
            in_loop[name] = sum(mine) / 1e3 / max(nb_cf, 1)
            print(f"[10 profile] one {name} epoch: host wall {wall_us:.0f} "
                  f"us, device busy {busy:.0f} us ({busy / wall_us:.3f} of "
                  f"the wall), {len(spans)} device activities, "
                  f"{in_loop[name]:.5f} ms per kernel launch", flush=True)
            counted = {}
            for e in prof_events[-1]:
                c, us = counted.get(e[0], (0, 0.0))
                counted[e[0]] = (c + 1, us + e[1])
            n_add, us_add = launches_of(counted, "segment_add_kernel")
            n_grp, us_grp = launches_of(counted, "segment_group_kernel")
            n_sort, us_sort = launches_of(counted, "sort")
            seg = [b - a for a, b in zip(seg0, (
                scatter.LAUNCHES, scatter.GROUP_LAUNCHES, scatter.SORTS))]
            print(f"[10 profile]   the leftover scatters: segment_add "
                  f"{n_add} launches, {us_add / max(n_add, 1):.2f} us a "
                  f"launch; segment_group {n_grp} launches (both ids of a "
                  f"batch in one), {us_grp / max(n_grp, 1):.2f} us a "
                  f"launch; torch.sort by the scatters {seg[2]} (counters: "
                  f"segment_add {seg[0]}, grouping {seg[1]}); sort kernels "
                  f"in the profiled epoch {n_sort} ({us_sort:.0f} us)",
                  flush=True)
            # the counters decide (the profiler may drop a few records);
            # a batch groups its row and column ids in one launch
            if (seg[2] or (on_card and not n_add)
                    or seg[0] != 2 * seg[1]):
                raise AssertionError(f"{name} epoch: the leftover scatters "
                                     f"sorted {seg[2]} times, or launched "
                                     f"segment_add {seg[0]} times for "
                                     f"{seg[1]} groupings (profiled "
                                     f"{n_add})")
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
        del spans, by_name, prof_events
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
    # phase 16 times the first leftover batch's col-plane scatter
    lo = None
    if len(sched.lo_starts):
        s0, w0 = int(sched.lo_starts[0]), int(sched.widths[0])
        lo = (sd.j[s0:s0 + w0].long(), pp.col)
    return entries, dict(res=res, sp=sp, tr=tr, te=te, shape=(M, N), cfg=cfg,
                         lo=lo)


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
        scatter.GROUP_LAUNCHES = scatter.RUN_LAUNCHES = scatter.SORTS = 0
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
        seg_launches, group_launches = (scatter.LAUNCHES,
                                        scatter.GROUP_LAUNCHES)
        seg_sorts = (scatter.RUN_LAUNCHES, scatter.SORTS)
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
              f"(torch.equal); segment_add launches {seg_launches}, its "
              f"grouping {group_launches} (run-table launches past "
              f"GROUP_MAX {seg_sorts[0]}, torch.sort {seg_sorts[1]})",
              flush=True)
        if not crashed or rec.seq != 3 or wal_bytes == [] or unequal:
            raise AssertionError(f"WAL recovery: crashed {crashed}, seq "
                                 f"{rec.seq}, unequal leaves {unequal}")
        if on_card and not (seg_launches and group_launches):
            raise AssertionError(f"segment_add launched {seg_launches} and "
                                 f"its grouping {group_launches} times on "
                                 f"the main path")

        # the kernels against their plain versions, timed at three shapes:
        # the online step's (4,096 ΔΩ columns into V), the fit's first
        # leftover col-plane scatter (phase 8's schedule, into pp.col),
        # and one hot id carrying 4,096 rows into V
        V = whole.state.params.V
        jv = torch.as_tensor(ds[0][0][1][:4096], device=dev).long()
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        shapes = [("online", V, jv)]
        if serve["lo"] is not None:
            shapes.append(("fit leftover", serve["lo"][1], serve["lo"][0]))
        shapes.append(("hot id", V, torch.full(
            (4096,), int(jv[0]), dtype=torch.long, device=dev)))
        sm_clock_mhz = sm_clock() if on_card else float("nan")
        seg_err, seg_rows = 0.0, {}
        for name, plane, ids in shapes:
            src = 1e-3 * torch.randn((ids.numel(), plane.shape[1]),
                                     generator=gen, device=dev)
            want = plane.to("cpu", copy=True).index_add_(0, ids.cpu(),
                                                         src.cpu())
            got = scatter.index_add_det_(plane.clone(), ids, src)
            plan = scatter.segment_plan(ids)
            ref = scatter.segment_plan_plain(ids.cpu())
            same_plan = not on_card or (
                torch.equal(plan.order.cpu(), ref.order)
                and all(torch.equal(a.cpu(), b)
                        for a, b in zip(plan.table(), ref.table())))
            if not torch.equal(got.cpu(), want) or not same_plan:
                raise AssertionError(f"segment_add at the {name} shape: "
                                     f"equal {torch.equal(got.cpu(), want)}"
                                     f", plan equal {same_plan}")
            seg_err = max(seg_err, float((got.cpu() - want).abs().max()))
            atomic_err = float((plane.clone().index_add_(0, ids, src)
                                - got).abs().max())
            Pk, Pp = plane.clone(), plane.clone()
            t = dict(
                grouped=graph_ms(lambda: scatter.index_add_det_(Pk, ids, src),
                                 dev),
                cold=median_ms(lambda: scatter.index_add_det_(Pk, ids, src),
                               dev),
                plan=graph_ms(lambda: scatter.index_add_det_(
                    Pk, ids, src, plan=plan), dev),
                group=graph_ms(lambda: scatter.segment_plan(ids), dev),
                lib=graph_ms(lambda: Pp.index_add_(0, ids, src), dev))
            _, _, lengths, longs = ref.table()
            n, w, uniq = ids.numel(), plane.shape[1], lengths.numel()
            L_max = int(lengths.max())
            # bytes: the ids and src read once, each touched dst row read
            # and written once; operations: one add per src element
            bnd, by = bound_ms(8 * n + 4 * n * w + 2 * 4 * uniq * w, n * w)
            # the chain: L_max dependent float32 adds of 4 cycles each
            floor = L_max * 4 / (sm_clock_mhz * 1e3)
            seg_rows[name] = dict(t, bound=bnd, by=by, floor=floor)
            print(f"[16 time] segment_add, {name}: n={n} ({uniq} distinct "
                  f"ids, L_max {L_max}, {longs.numel()} runs past "
                  f"{scatter.LONG_RUN} rows) width={w} into "
                  f"[{plane.shape[0]}, {plane.shape[1]}] at row stride "
                  f"{plane.stride(0)}: equal to the CPU's index_add_ bit "
                  f"for bit, the plan equal to the plain grouping's (the "
                  f"card's atomic index_add_ is off by up to "
                  f"{atomic_err:.3g}); with its grouping {t['grouped']:.5f} "
                  f"ms (CUDA graph of 50 calls, median of 20 replays), "
                  f"{t['cold']:.4f} ms cold L2; with a plan "
                  f"{t['plan']:.5f} ms; the grouping alone {t['group']:.5f}"
                  f" ms; index_add_ (the plain version and the library "
                  f"call) {t['lib']:.5f} ms; bound {bnd:.5f} ms ({by}); "
                  f"chain floor {floor:.5f} ms ({L_max} adds x 4 cycles at "
                  f"{sm_clock_mhz:.0f} MHz) (power limit {power})",
                  flush=True)
            del Pk, Pp, got, want, src
        # past GROUP_MAX: torch.sort, then the run-table kernel
        big = (torch.randint(0, 1 << 20, (1 << 17,), generator=gen,
                             device=dev) % V.shape[0]) \
            * (torch.rand(1 << 17, generator=gen, device=dev) > 0.3)
        src = torch.randn((big.numel(), V.shape[1]), generator=gen,
                          device=dev)
        want = V.to("cpu", copy=True).index_add_(0, big.cpu(), src.cpu())
        plan = scatter.segment_plan(big)
        got = scatter.index_add_det_(V.clone(), big, src, plan=plan)
        if on_card:
            ref = scatter.segment_plan_plain(big.cpu())
            if not (torch.equal(plan.order.cpu(), ref.order) and all(
                    torch.equal(a.cpu(), b)
                    for a, b in zip(plan.table(), ref.table()))):
                raise AssertionError("the run table past GROUP_MAX differs")
        if not torch.equal(got.cpu(), want):
            raise AssertionError("segment_add past GROUP_MAX differs")
        print(f"[16 check] segment_add past GROUP_MAX: {big.numel()} ids "
              f"(id 0 carrying {int((big == 0).sum())} rows) sorted by "
              f"torch.sort, the run table by its kernel equal to the plain "
              f"grouping's, the scatter equal to the CPU's index_add_",
              flush=True)
        online = seg_rows["online"]
        seg_ms, plain_ms = online["grouped"], online["lib"]
        # the kernels line's bound: the larger of the bytes (or peak-rate
        # operations) bound and the chain floor, whose L_max dependent
        # adds are operations too
        seg_bound, seg_by = max((online["bound"], online["by"]),
                                (online["floor"], "operations"))
        del plan, got, want, src, big
        del up, rec, whole, ta, tb, V
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
                library_ms=plain_ms, group_launches=group_launches)


def loop_phase(args, octx: dict, scfg, dev, on_card: bool,
               power: str) -> None:
    """Phase 17: the always-on `OnlineLoop` at full width, on phase 15's
    state.  A `LOOP_SLICES`-slice reference arm (its states' leaf hashes
    kept by seq), a drift trip forced on it, and three arms killed at
    the `LOOP_KILLS` fault-site calls, each recovered with
    `OnlineLoop.recover` and held to the reference's hashes at its
    seq."""
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

    # the stream, the same in every arm: a ΔΩ on its first slice (a
    # sixth of the remaining held-out ratings — one on each even slice of
    # 6 until phase 33 needed the script's time: each ΔΩ's micro schedule
    # is rebuilt on the host, in the slice and again in each WAL replay
    # —, plus new users rating 20 items and new items rated by 20 old
    # users: phase 16's recipe), and 2 × B users a slice, a quarter of
    # them new ids
    n_u = max(1, round(100 * args.fit_scale))
    n_i = max(1, round(50 * args.fit_scale))
    part = np.arange(rest[0].size // 6)
    M2, N2 = st0.M + n_u, st0.N + n_i
    r = np.concatenate([np.repeat(np.arange(st0.M, M2), 20),
                        rng.integers(0, st0.M, 20 * n_i)])
    c = np.concatenate([rng.integers(0, N2, 20 * n_u),
                        np.repeat(np.arange(st0.N, N2), 20)])
    key = np.unique(r.astype(np.int64) * N2 + c)
    r, c = key // N2, key % N2
    delta = ((np.concatenate([rest[0][part], r]).astype(np.int32),
              np.concatenate([rest[1][part], c]).astype(np.int32),
              np.concatenate([rest[2][part], rng.integers(1, 6, r.size)])
              .astype(np.float32)),
             M2, N2, prng.PRNGKey(args.seed + 170))
    traffic = [np.concatenate([
        rng.integers(0, st0.M, 2 * B - B // 2),
        rng.integers(st0.M, M2, B // 2)]).astype(np.int32)
        for _ in range(LOOP_SLICES)]

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
                if s % LOOP_SLICES == 0:
                    d, M_new, N_new, k_d = delta
                    loop.offer_delta(*d, k_d, M_new=M_new, N_new=N_new)
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
        for s in range(LOOP_SLICES):
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
              f"holdout {n_hold} ratings; {LOOP_SLICES} slices in "
              f"{wall:.2f} s to "
              f"M={loop.state.M} N={loop.state.N} "
              f"({loop.state.sp.nnz} ratings), seq {loop.updater.seq}; "
              f"a delta of {delta[0][0].size} ratings", flush=True)
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
        if (c("loop.slices_trained") != LOOP_SLICES
                or c("online.updates") != 1):
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
        t_drift = time.perf_counter()
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
              f"{svc._rebuilder.builds}, failures {svc._rebuilder.failures})"
              f" in {time.perf_counter() - t_drift:.1f} s", flush=True)
        if tripped != 1 or outcome == "pending":
            raise AssertionError(f"drift trips {tripped}, rebuild "
                                 f"{outcome}")
        del trip, loop, svc, served
        gc.collect()

        # ---- three arms killed at the loop's fault sites, recovered ----
        for site, call in LOOP_KILLS:
            root = os.path.join(base, site)
            arm = new_loop(root, obs.Registry(enabled=True))
            t_arm = time.perf_counter()
            if not drive(arm, range(LOOP_SLICES), kill=(site, call)):
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
            drive(rec, [nxt % LOOP_SLICES])
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
                  f"{int(rreg.counter('loop.slice_failures'))}; the arm "
                  f"{time.perf_counter() - t_arm:.1f} s", flush=True)
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
        # one epoch (two until phase 29 needed the script's time; the
        # fit below runs two through the mesh)
        for ep in range(1):
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
    print(f"[20 fit] one epoch through the mesh and through the replay: "
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
    printing the kernels' launch counters.  The seven run at once, one
    host thread each (each spends most of its wall starting up and on
    the host, and none writes where another does); their outputs are
    read in order."""
    from concurrent.futures import ThreadPoolExecutor

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
    # one host thread each: seven processes with a full pool of torch
    # threads apiece oversubscribe the host's cores (the CPU rehearsal
    # ran 10x slower)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    t_phase = time.perf_counter()
    import shutil
    shutil.rmtree(build, ignore_errors=True)
    os.makedirs(build)
    out = {}

    def run(name, extra):
        """→ (the finished process, its wall seconds)."""
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
        return done, time.perf_counter() - t0

    # the pool's exit waits for every process, also when one fails
    with ThreadPoolExecutor(max_workers=len(runs)) as pool:
        futures = [pool.submit(run, name, extra) for name, extra in runs]
        finished = [f.result() for f in futures]
    for (name, extra), (done, wall) in zip(runs, finished):
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
    llama3-8b's full width, L = 8; its KV cache (prefill's last-position logits
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

    # ---- (b) the served model at full width, cut to 8 of its 32 layers
    # since phase 31 took the script's time (16 since phase 30) ----
    served = dataclasses.replace(full, L=8) if on_card else full
    held = torch.cuda.memory_allocated() / 1e6 if on_card else 0.0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(served, prng.PRNGKey(0), model_shards=1,
                            device=dev)
    sync()
    t_init = time.perf_counter() - t0
    logs = []
    out, st = serve(served, batch=B, prompt_len=S, gen=32, seed=0,
                    log=logs.append, device=dev, params=params)
    nparam = sum(t.numel() for v in params.values() for t in (
        v.values() if isinstance(v, dict) else (v,)))
    bound_s = 4 * nparam / HBM_BYTES_PER_S       # float32 weights, one read
    print(f"[23 serve] {served.name} at L={served.L} ({nparam / 1e9:.3f}e9 "
          f"float32 params, "
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
        profile_decode(served, params, B, S, dev)
    print(f"[23 done] phase 23 in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return dict(st, nparam=nparam, bound_tok_s=B / bound_s, cache=(
        d_max, d_mean), cpu=(c_max, c_mean))


def profile_decode(cfg, params, B: int, S: int, dev, steps_n: int = 3,
                   tag: str = "23 profile") -> tuple[float, dict]:
    """``steps_n`` decode steps of the served model under `torch.profiler`
    (after a prefill — for the ssm and hybrid families an empty cache —
    and two warm steps): the device's busy share of the window and its
    time by kernel → (the busy share, {kernel: ms a step})."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import lm, steps

    # distinct rows: identical ones would route to the same experts
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)).to(dev)
    cache = steps.init_cache(cfg, B, S + 2 + steps_n, device=dev)
    if cfg.family in lm.KV_FAMILIES:
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
    print(f"[{tag}] {steps_n} decode steps in {1e3 * wall:.1f} ms "
          f"(profiled): {len(spans)} device activities, busy "
          f"{busy / 1e3:.1f} ms (share {busy / 1e6 / wall:.3f}); by kernel "
          f"ms: " + "; ".join(f"{n[:70]} {t / 1e3:.2f}" for n, t in top),
          flush=True)
    return busy / 1e6 / wall, {n: t / 1e3 / steps_n
                               for n, t in by_name.items()}


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
    # full width, 4 of the 28 layers (7 until phase 34): the depth is cut
    # for the script's time limit (PERF.md §4)
    full = dataclasses.replace(CB.get("qwen3-0.6b"), L=4)
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

    def card_vs_cpu(cfg, batch, tag):
        """One `value_and_grad` on the card and on the CPU → (loss rel,
        worst leaf, the card's gradients); raises past the bounds."""
        lc, g_dev = steps.value_and_grad(cfg, p, on_dev(batch))
        l0, g0 = steps.value_and_grad(cfg, hp, batch)
        worst, path = worst_leaf(g_dev, g0)
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
        tf_worst, tf_path = worst_leaf(tf32_grads(cut, p, on_dev(b)), g0)
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
    timed_cell("24", full, B, S, b_typed, step_s)
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
    scatter.GROUP_LAUNCHES = scatter.SORTS = 0
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
          f"launches {seg}, its grouping {scatter.GROUP_LAUNCHES}, "
          f"torch.sort {scatter.SORTS}", flush=True)
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


def worst_leaf(got, want, denoms=(1.0, 1.0)) -> tuple[float, str]:
    """(the largest card-vs-CPU max abs over the leaf's own max |g|, that
    leaf's path) of two gradient trees, ``want`` the CPU's (on the CPU,
    or moved to the card to compare there), in float32, each tree
    divided by its ``denoms`` entry (a bfloat16 sum by its Σw)."""
    from repro_torch import tree as T

    out = []
    for (path, w), a in zip(T.leaves_with_paths(want), T.leaves(got)):
        w32 = w.float() / denoms[1]
        scale = float(w32.abs().max())
        err = float((a.to(w.device).float() / denoms[0] - w32).abs().max())
        out.append((err / scale if scale > 0 else float("inf"), path))
    return max(out)


def tf32(fn):
    """``fn()`` with TF32 products on the card: the lower-precision
    control of a card-vs-CPU check."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def tf32_grads(cfg, p, batch):
    """`value_and_grad`'s gradients on the card with TF32 products."""
    from repro_torch.models import steps

    return tf32(lambda: steps.value_and_grad(cfg, p, batch)[1])


def gc_collect(on_card: bool) -> None:
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()


def profile_train_step(cfg, params, opt, batch, tag: str = "24 profile",
                       n_top: int = 3, card: str = "") -> float:
    """One full-width train step under `torch.profiler` (after the loop's
    warm steps): the device's busy share of the window (returned) and its
    ``n_top`` largest costs by kernel (``card``, if given, printed
    beside them)."""
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n_top]
    print(f"[{tag}] one train step in {1e3 * wall:.1f} ms (profiled): "
          f"{len(spans)} device activities, busy {busy / 1e3:.1f} ms (share "
          f"{busy / 1e6 / wall:.3f}); largest device costs ms: "
          + "; ".join(f"{n[:70]} {t / 1e3:.2f}" for n, t in top)
          + (f" ({card})" if card else ""), flush=True)
    return busy / 1e6 / wall


def ssm_step_flops(cfg, B: int, S: int) -> tuple[float, float]:
    """(bf16, float32) multiply-add FLOPs of one ssm or hybrid train step
    from the shapes: the Mamba2 projections, the one-hot embedding
    product and the hybrid's shared block in bfloat16; the SSD's products
    (chunks of min(256, S)), the shared block's attention scores and the
    logits in float32.  Forward once, the Mamba2 layers again under
    remat, backward twice each product (the one-hot product once); the
    shared block is not rematerialised."""
    from repro_torch.models import ssm as SSM

    D, di, N = cfg.d_model, SSM.d_inner(cfg), cfg.ssm_state
    H, P = SSM.n_heads(cfg), cfg.ssm_headdim
    V, n, Q = cfg.vocab_padded(1), B * S, min(256, S)
    proj = 2 * n * D * (2 * di + 2 * N + H) + 2 * n * di * D   # per layer
    ssd = 2 * n * Q * (N + H * P) + 4 * n * H * P * N          # per layer
    emb = logits = 2 * n * V * D
    bf16 = cfg.L * proj * 4 + emb * 2
    f32 = cfg.L * ssd * 4 + logits * 3
    if cfg.family == "hybrid":
        uses = -(-cfg.L // cfg.attn_every)
        Hq, Hk, hd, ff = cfg.n_heads_padded, cfg.n_kv, cfg.hd, cfg.d_ff
        bf16 += uses * 3 * 2 * n * D * (2 * Hq * hd + 2 * Hk * hd + 3 * ff)
        f32 += uses * 3 * 2 * 2 * B * Hq * S * S * hd
    return float(bf16), float(f32)


def ssm_phase(args, dev, on_card: bool, power: str) -> None:
    """Phase 25: the ssm and hybrid families (mamba2-370m, zamba2-7b) —
    checks on 2-layer cuts of their full widths, serving at full width
    cut to `SSM_SERVE_L` layers through `repro_torch.launch.serve.serve`,
    and training: mamba2-370m at full width cut to `SSM_TRAIN_L` through
    `train_loop`, zamba2-7b at `ZAMBA_TRAIN_L`.
    Launches none of the seven kernels (no `pallas_call` on this path,
    and ``lsh_softmax`` is off in both configs)."""
    import dataclasses
    import shutil

    from repro_torch import prng
    from repro_torch import tree as T
    from repro_torch.configs import base as CB
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import train as ltrain
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm, steps
    from repro_torch.models import ssm as SSM
    from repro_torch.train import checkpoint as ckpt

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t_phase = time.perf_counter()
    counts0 = launch_counts()
    fulls = [CB.get("mamba2-370m"), CB.get("zamba2-7b")]
    if not on_card:
        fulls = [CB.reduced(c) for c in fulls]   # rehearsal size
    u = 2.0 ** -8                                # bfloat16's unit roundoff
    B, S, GEN = 4, 64, 32
    host = lambda tree: T.tree_map(lambda t: t.to("cpu", copy=True), tree)
    on_dev = lambda b: {k: v.to(dev) for k, v in b.items()}
    nparams = lambda tree: sum(t.numel() for t in T.leaves(tree))
    rng = np.random.default_rng(args.seed + 25)
    # each gradient leaf within 1e-4 of its own max |g| (phase 24's limit:
    # float32 reads ~1e-6 there, TF32 products ~1e-3)
    GRAD_REL = 1e-4

    def decode_all(cfg, p, toks, drop_conv=False):
        """Token-by-token decode of ``toks`` → logits [B, S, V]; with
        ``drop_conv`` the conv states are zeroed before every step (the
        control: a decode that loses the causal conv's history)."""
        dec = steps.make_decode_step(cfg)
        cache = steps.init_cache(cfg, toks.shape[0], toks.shape[1],
                                 device=dev)
        out = []
        for t in range(toks.shape[1]):
            if drop_conv:
                for n in ("conv_x", "conv_b", "conv_c"):
                    cache[n].zero_()
            lg, cache = dec(p, cache, toks[:, t:t + 1])
            out.append(lg[:, 0])
        return torch.stack(out, dim=1)

    def err(a, b):
        e = (a.float().cpu() - b.float().cpu()).abs()
        return float(e.max()), float(e.mean())

    def grads_vs_cpu(cut, tag):
        """One float32 `value_and_grad` of the cut on the card and on the
        CPU (B 2, S 32) and the card's again with TF32 products (the
        control) → (loss rel, worst leaf, its path, TF32 worst, its
        path)."""
        cut = dataclasses.replace(cut, dtype="float32", microbatches=1)
        p = lm.init_params(cut, prng.PRNGKey(0), model_shards=1, device=dev)
        hp = host(p)
        b = {k: torch.from_numpy(rng.integers(0, cut.vocab, (2, 32)).astype(
            np.int32)) for k in ("tokens", "labels")}
        lc, g_dev = steps.value_and_grad(cut, p, on_dev(b))
        l0, g0 = steps.value_and_grad(cut, hp, b)

        w_err, w_path = worst_leaf(g_dev, g0)
        tf_err, tf_path = float("nan"), "-"
        if on_card:
            tf_err, tf_path = worst_leaf(tf32_grads(cut, p, on_dev(b)), g0)
        rel = abs(float(lc) - float(l0)) / abs(float(l0))
        print(f"[25 grads] {tag} cut to L={cut.L} (d={cut.d_model}, "
              f"V={cut.vocab_padded(1)}, {nparams(p) / 1e6:.1f}e6 params), "
              f"float32, B=2 S=32: loss card {float(lc):.6f} vs CPU "
              f"{float(l0):.6f} (rel {rel:.3g}, limit 1e-5); worst gradient "
              f"leaf {w_err:.3g} of its max |g| ({w_path}; limit {GRAD_REL});"
              f" control, TF32 products on the card: worst leaf {tf_err:.3g} "
              f"({tf_path}) (power limit {power})", flush=True)
        if not (rel <= 1e-5 and w_err <= GRAD_REL):
            raise AssertionError(f"{tag}: the card's gradients disagree with "
                                 f"the CPU's")
        if on_card and not tf_err > GRAD_REL:
            raise AssertionError("the gradient bound passes TF32 products: "
                                 "it does not hold the card to float32")
        del p, hp, g_dev, g0
        gc_collect(on_card)

    # ---- (a) 2-layer cuts of the full widths: cache, CPU, chunking ----
    for full in fulls:
        cut = dataclasses.replace(full, L=2)
        p = lm.init_params(cut, prng.PRNGKey(0), model_shards=1, device=dev)
        toks = torch.from_numpy(rng.integers(0, cut.vocab, (B, S)).astype(
            np.int32)).to(dev)
        with torch.no_grad():
            fwd = steps.logits_of(cut, p, lm.forward(cut, p, {
                "tokens": toks}))                           # [B, S, V]
        pre, pc = steps.make_prefill(cut)(p, {"tokens": toks})
        dec = decode_all(cut, p, toks)
        ctl = decode_all(cut, p, toks, drop_conv=True)
        sync()
        rms = float(fwd.pow(2).mean().sqrt())
        a_max, a_mean = err(dec, fwd)
        l_max, _ = err(dec[:, -1], pre)
        c_max, c_mean = err(ctl, fwd)
        # phase 23's limits: the card read max 1.9u·rms (mamba2) and
        # 8.3u·rms (zamba2), mean ≤ 1.03u·rms (PERF.md §6)
        lim = (16 * u * rms, 4 * u * rms)
        print(f"[25 cache] {cut.name} cut to L=2 (d={cut.d_model}, "
              f"V={cut.vocab_padded(1)}), bfloat16: a {S}-step decode vs "
              f"the forward at every position max abs {a_max:.4g}, mean "
              f"{a_mean:.4g}; its last step vs prefill's last-position "
              f"logits max abs {l_max:.4g} (prefill's cache {sorted(pc)}; "
              f"logit rms {rms:.4g}; limits 16u·rms {lim[0]:.4g}, 4u·rms "
              f"{lim[1]:.4g}, u = 2^-8); control, the conv state dropped "
              f"each step: max {c_max:.4g}, mean {c_mean:.4g}", flush=True)
        if not (a_max <= lim[0] and a_mean <= lim[1] and l_max <= lim[0]):
            raise AssertionError("the decode's SSM and conv states disagree "
                                 "with the forward")
        if not (c_max > lim[0] and c_mean > lim[1]):
            raise AssertionError("the cache check passes a decode without "
                                 "its conv state")
        # the card's bfloat16 forward against the CPU's float32 one
        hp = host(p)
        t0 = time.perf_counter()
        c32 = dataclasses.replace(cut, dtype="float32")
        with torch.no_grad():
            ref = steps.logits_of(c32, hp, lm.forward(c32, hp, {
                "tokens": toks.cpu()}))
        t_cpu = time.perf_counter() - t0
        rms32 = float(ref.pow(2).mean().sqrt())
        b_max, b_mean = err(fwd, ref)
        k_max, k_mean = err(ctl, ref)
        # the card read max 15u·rms (mamba2) and 25u·rms (zamba2: bf16
        # attention and MLP beside the SSM), mean 2-4u·rms (PERF.md §6); the
        # conv-dropped control reads ~1.1 rms
        lim32 = (48 * u * rms32, 8 * u * rms32)
        print(f"[25 cpu] the same forward on the CPU in float32 "
              f"({t_cpu:.1f} s): card (bfloat16) within max abs {b_max:.4g},"
              f" mean {b_mean:.4g} (logit rms {rms32:.4g}; limits 48u·rms "
              f"{lim32[0]:.4g}, 8u·rms {lim32[1]:.4g}); control, the "
              f"conv-dropped decode: max {k_max:.4g}, mean {k_mean:.4g}; "
              f"greedy tokens equal at "
              f"{float((fwd.cpu().argmax(-1) == ref.argmax(-1)).float().mean()):.3f}"
              f" of the positions", flush=True)
        if not (b_max <= lim32[0] and b_mean <= lim32[1]):
            raise AssertionError("the card's forward disagrees with the CPU's")
        if not (k_max > lim32[0] and k_mean > lim32[1]):
            raise AssertionError("the card-vs-CPU check passes a decode "
                                 "without its conv state")
        del p, hp, fwd, pre, dec, ctl, ref
        gc_collect(on_card)
        # SSD chunk invariance at the block's widths, float32 on the card
        H, Pd, N = SSM.n_heads(cut), cut.ssm_headdim, cut.ssm_state
        f = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
        Sx = 256
        xs, dt = f(rng.normal(size=(2, Sx, H, Pd))), f(rng.uniform(
            0.01, 0.2, (2, Sx, H)))
        A, D = -f(rng.uniform(0.1, 1.0, (H,))), f(rng.normal(size=(H,)))
        Bm, Cm = f(rng.normal(size=(2, Sx, N))), f(rng.normal(size=(2, Sx, N)))
        y256 = SSM.ssd_chunked(xs, dt, A, Bm, Cm, D, chunk=256)
        y64 = SSM.ssd_chunked(xs, dt, A, Bm, Cm, D, chunk=64)
        # the control: each 64-chunk alone, its carried state dropped
        alone = torch.cat([SSM.ssd_chunked(
            xs[:, i:i + 64], dt[:, i:i + 64], A, Bm[:, i:i + 64],
            Cm[:, i:i + 64], D, chunk=64) for i in range(0, Sx, 64)], dim=1)
        ratio = lambda a: float(((a - y256).abs() / (
            1e-4 + 1e-4 * y256.abs())).max())
        r, rc = ratio(y64), ratio(alone)
        print(f"[25 chunk] ssd_chunked at H={H} P={Pd} N={N}, B=2 S={Sx}, "
              f"float32: chunk 64 vs 256 max abs "
              f"{float((y64 - y256).abs().max()):.3g} (|y| max "
              f"{float(y256.abs().max()):.3g}), {r:.3g} of the JAX test's "
              f"rtol = atol = 1e-4 (limit 1); control, each 64-chunk alone "
              f"(the carried state dropped): {rc:.3g}", flush=True)
        if not r <= 1.0:
            raise AssertionError("ssd_chunked depends on the chunk size")
        if not rc > 1.0:
            raise AssertionError("the chunk check passes a dropped state")
        del xs, dt, Bm, Cm, y256, y64, alone
        gc_collect(on_card)

    # ---- (b) serving at full width, both cut to `SSM_SERVE_L` layers ----
    t_a = time.perf_counter() - t_phase
    for full in fulls:
        if on_card:
            full = dataclasses.replace(full, L=SSM_SERVE_L)
        held = torch.cuda.memory_allocated() / 1e6 if on_card else 0.0
        t0 = time.perf_counter()
        params = lm.init_params(full, prng.PRNGKey(0), model_shards=1,
                                device=dev)
        sync()
        t_init = time.perf_counter() - t0
        logs = []
        out, st = serve(full, batch=B, prompt_len=S, gen=GEN, seed=0,
                        log=logs.append, device=dev, params=params)
        nparam = nparams(params)
        bound_s = 4 * nparam / HBM_BYTES_PER_S   # float32 weights, one read
        o = out.cpu().numpy()
        print(f"[25 serve] {full.name} (L={full.L}, {nparam / 1e9:.4f}e9 "
              f"float32 params, {4 * nparam / 1e9:.2f} GB) batch {B}, prompt "
              f"{S} (prefilled by {S} sequential decode steps), gen {GEN}: "
              f"params drawn in {t_init:.2f} s, prefill "
              f"{st['prefill_s']:.3f} s, decode {st['decode_s']:.3f} s, "
              f"{st['tok_per_s']:.1f} tokens/s (bound {B / bound_s:.0f} "
              f"tokens/s: the float32 weights read once a step, "
              f"{1e3 * bound_s:.2f} ms) "
              + (f"resident {st['resident_mb']:.0f} MB, peak "
                 f"{st['peak_mb']:.0f} MB (phases before it held {held:.0f} "
                 f"MB) " if on_card else "")
              + f"(power limit {power})", flush=True)
        if o.shape != (B, GEN + 1) or not ((o >= 0) & (o < full.vocab)).all():
            raise AssertionError(f"served tokens {o.shape} out of range")
        if on_card:
            profile_decode(full, params, B, S, dev, tag="25 profile")
        del params, out
        gc_collect(on_card)

    # ---- (c) training ----
    t_b = time.perf_counter() - t_phase - t_a
    # mamba2-370m at full width: card vs CPU on the cut, then train_loop
    mamba, zamba = fulls
    grads_vs_cpu(dataclasses.replace(mamba, L=2), mamba.name)
    # trained cut to `SSM_TRAIN_L` of its 48 layers (the whole script's
    # time: phases 28-34 came after it)
    mamba = dataclasses.replace(mamba, L=SSM_TRAIN_L) if on_card else mamba
    Bt, St, N_STEPS, N_TIMED = 8, 128, SSM_STEPS, 6
    held = torch.cuda.memory_allocated() / 1e6 if on_card else 0.0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    d = os.path.join(ROOT, "build", "chip_smoke_ssm_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    logs = []
    t0 = time.perf_counter()
    params, opt, losses = ltrain.train_loop(
        mamba, steps_n=N_STEPS // 2, batch=Bt, seq=St, ckpt_dir=d, lr=3e-4,
        log=logs.append, device=dev, seed=args.seed)
    wall1 = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e6 if on_card else 0.0
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
        mamba, steps_n=N_STEPS, batch=Bt, seq=St, ckpt_dir=d, lr=3e-4,
        log=logs.append, device=dev, seed=args.seed)
    wall2 = time.perf_counter() - t0
    shutil.rmtree(d, ignore_errors=True)
    losses += more
    step_fn = steps.make_train_step(mamba, lr=3e-4)
    trng = np.random.default_rng(args.seed + 1)
    marks = []
    for tb in [ltrain.synth_batch(trng, mamba, Bt, St, device=dev)
               for _ in range(N_TIMED)]:
        t = time.perf_counter()
        params, opt, _ = step_fn(params, opt, tb)
        sync()
        marks.append(time.perf_counter() - t)
    step_s = float(np.median(marks[3:]))
    nparam = nparams(params)
    bf, f32 = ssm_step_flops(mamba, Bt, St)
    adam_bytes = 28 * nparam
    bnd = (bf / BF16_OPS_PER_S + f32 / F32_OPS_PER_S
           + adam_bytes / HBM_BYTES_PER_S)
    print(f"[25 train] {mamba.name} (L={mamba.L}, {nparam / 1e6:.2f}e6 "
          f"float32 params) batch {Bt} seq {St}, lr 3e-4, {N_STEPS} steps in "
          f"two train_loop calls (a checkpoint at step {N_STEPS // 2}, the "
          f"second "
          f"resumes from it): loop wall {wall1:.1f} + {wall2:.1f} s; then "
          f"{N_TIMED} steps of make_train_step, step s median of steps "
          f"3-{N_TIMED - 1} {step_s:.4f} (min {min(marks[3:]):.4f}, max "
          f"{max(marks[3:]):.4f}), {Bt * St / step_s:.0f} tokens/s; bound "
          f"{1e3 * bnd:.2f} ms ({bf / 1e12:.3f} TFLOP bf16 at "
          f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s, {f32 / 1e12:.3f} TFLOP "
          f"float32 at {F32_OPS_PER_S / 1e12:.0f}, Adam "
          f"{adam_bytes / 1e9:.2f} GB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s);"
          f" loss step 0 {losses[0]:.4f}, step {N_STEPS // 2} "
          f"{losses[N_STEPS // 2]:.4f}, step {N_STEPS - 1} "
          f"{losses[N_STEPS - 1]:.4f}; "
          + (f"peak over the first {N_STEPS // 2} steps {peak:.0f} MB "
             f"(phases before "
             f"it held {held:.0f} MB) " if on_card else "")
          + f"(power limit {power})", flush=True)
    print(f"[25 ckpt] step {step} restored in {t_restore:.1f} s: every leaf "
          f"equal to the state saved at step {N_STEPS // 2}: {same}",
          flush=True)
    if not (same and step == N_STEPS // 2
            and f"resumed from step {N_STEPS // 2}" in logs):
        raise AssertionError(f"the step-{N_STEPS // 2} checkpoint did not "
                             f"restore bit for bit")
    if not (np.isfinite(losses).all() and losses[N_STEPS - 1]
            < losses[N_STEPS // 2] < losses[0]):
        raise AssertionError(f"the mamba2 loss did not fall: {losses}")
    del params, opt
    gc_collect(on_card)

    # zamba2-7b: card vs CPU on its L = 2 cut, then L = 12 with µ = 2 at
    # lr 1e-4, mamba2's 3e-4 scaled by the widths' ratio 1,024 / 3,584:
    # Adam's first steps move every weight by ~lr, so a logit moves by
    # ~lr·d, and at 3e-4 the loss rose from step 2 on (PERF.md §6)
    grads_vs_cpu(dataclasses.replace(zamba, L=2), zamba.name)
    z_lr = 1e-4
    z24 = dataclasses.replace(zamba, L=ZAMBA_TRAIN_L) if on_card else \
        dataclasses.replace(zamba, microbatches=2)
    held = torch.cuda.memory_allocated() / 1e6 if on_card else 0.0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt, zl = ltrain.train_loop(z24, steps_n=5, batch=Bt, seq=St,
                                        lr=z_lr, log=logs.append,
                                        device=dev, seed=args.seed)
    wall = time.perf_counter() - t0
    step_fn = steps.make_train_step(z24, lr=z_lr)
    marks = []
    for tb in [ltrain.synth_batch(trng, z24, Bt, St, device=dev)
               for _ in range(3)]:
        t = time.perf_counter()
        params, opt, _ = step_fn(params, opt, tb)
        sync()
        marks.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated() / 1e6 if on_card else 0.0
    nparam = nparams(params)
    bf, f32 = ssm_step_flops(z24, Bt, St)
    bnd = (bf / BF16_OPS_PER_S + f32 / F32_OPS_PER_S
           + 28 * nparam / HBM_BYTES_PER_S)
    print(f"[25 train] {z24.name} cut to L={z24.L} ({nparam / 1e9:.4f}e9 "
          f"float32 params, {len(lm._hybrid_groups(z24))} uses of the shared "
          f"block), microbatches {z24.microbatches}, batch {Bt} seq {St}, "
          f"lr {z_lr:g}: "
          f"5 steps of train_loop in {wall:.1f} s (the draw included), loss "
          f"{' '.join(f'{x:.4f}' for x in zl)}; 3 more make_train_step "
          f"steps, step s median {float(np.median(marks)):.3f} "
          f"({Bt * St / float(np.median(marks)):.0f} tokens/s; bound "
          f"{1e3 * bnd:.2f} ms); "
          + (f"peak {peak:.0f} MB (phases before it held {held:.0f} MB) "
             if on_card else "")
          + f"(power limit {power})", flush=True)
    if not (np.isfinite(zl).all() and zl[-1] < zl[0]):
        raise AssertionError(f"the zamba2 loss did not fall: {zl}")
    del params, opt
    gc_collect(on_card)

    launched = {k: v - counts0[k] for k, v in launch_counts().items()}
    print(f"[25 kernels] launches in phase 25: {launched} (the SSD and the "
          f"projections are plain torch products, as the JAX package's are "
          f"plain XLA; lsh_softmax is off in both configs, so no "
          f"segment_add)", flush=True)
    if any(launched.values()):
        raise AssertionError("phase 25 launched a kernel it should not")
    t_all = time.perf_counter() - t_phase
    print(f"[25 done] phase 25 in {t_all:.1f} s: (a) {t_a:.1f}, (b) "
          f"{t_b:.1f}, (c) {t_all - t_a - t_b:.1f} s (power limit {power})",
          flush=True)


def moe_routes(cfg, p, toks, force=None):
    """`lm.forward` composed layer by layer from `lm.layer`, the attention
    sub-layer, `moe.router` and `moe.moe_dense_ref`, with each layer's
    routes read → (logits [B, S, V] float32, expert ids [L, B, S, k] and
    the gap between the k-th and (k+1)-th router logit [L, B, S] (inf
    when k = E), both on the CPU).  ``force`` (ids [L, B, S, k]) replaces
    each layer's routes, the gates then the softmax of this run's router
    logits at those experts."""
    from repro_torch.models import layers as L
    from repro_torch.models import lm, steps
    from repro_torch.models import moe as MOE

    x = lm.embed_tokens(p, cfg, toks)
    eids, gaps = [], []
    k = cfg.moe_top_k
    for i in range(cfg.L):
        pl = lm.layer(p["layers"], i)
        x, _ = lm._attn_sublayer(pl, x, cfg, causal=True)
        xn = L.rms_norm(x, pl["ln2"], cfg.norm_eps)
        eid, gate = MOE.router(pl, xn, cfg)
        logits = torch.einsum("bsd,de->bse", xn.float(), pl["router"].float())
        if force is not None:
            eid = force[i].to(x.device)
            gate = torch.softmax(logits.gather(-1, eid.long()), dim=-1)
        y = MOE.moe_dense_ref(pl, xn, eid, gate, cfg)
        if cfg.moe_dense_ff:
            y = y + L.mlp(dict(w1=pl["w1d"], w3=pl["w3d"], w2=pl["w2d"]), xn)
        x = x + y
        eids.append(eid.cpu())
        lg = torch.sort(logits, dim=-1, descending=True).values
        gaps.append((lg[..., k - 1] - lg[..., k]).cpu() if k < cfg.n_experts
                    else torch.full(lg.shape[:-1], float("inf")))
    h = L.rms_norm(x, p["final_norm"], cfg.norm_eps)
    return steps.logits_of(cfg, p, h), torch.stack(eids), torch.stack(gaps)


def replay_experts(cfg, params, out, B: int, S: int, dev):
    """A served moe run replayed — the same prompts (`serve`'s seed-0
    draw), then the served tokens ``out`` [B, GEN + 1] — with
    `moe_dense_ref` wrapped to count each call's distinct experts (one
    call, so one host sync, a layer) → (distinct experts [GEN, L] of each
    decode step and layer, the prefill's per layer)."""
    from repro_torch.models import moe as MOE
    from repro_torch.models import steps

    GEN = out.shape[1] - 1
    counts = []
    orig = MOE.moe_dense_ref

    def counted(pl, x, eid, gate, cfg):
        counts.append(int(torch.unique(eid).numel()))
        return orig(pl, x, eid, gate, cfg)

    MOE.moe_dense_ref = counted
    try:
        prompts = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab, (B, S)).astype(np.int32)).to(dev)
        _, pc = steps.make_prefill(cfg)(params, {"tokens": prompts})
        n_pre = len(counts)
        cache = steps.init_cache(cfg, B, S + GEN, device=dev)
        cache["k"][:, :, :S], cache["v"][:, :, :S] = pc["k"], pc["v"]
        cache["pos"] = S
        dec = steps.make_decode_step(cfg)
        replay = []
        for i in range(GEN):
            lg, cache = dec(params, cache, out[:, i:i + 1])
            replay.append(torch.argmax(lg[:, -1], -1).to(torch.int32))
    finally:
        MOE.moe_dense_ref = orig
    if not torch.equal(torch.stack(replay, 1).cpu(), out[:, 1:].cpu()):
        raise AssertionError("the replay's tokens differ from the served run")
    per_step = np.array(counts[n_pre:], dtype=np.float64).reshape(GEN, cfg.L)
    return per_step, counts[:n_pre]


def moe_step_bytes(cfg, params, per_step) -> float:
    """The bytes a moe decode step must read, in the weights' own dtype:
    every layer's attention, norms, router (and arctic's dense residual
    MLP), the experts it routed to (``per_step`` [GEN, L], their mean
    over the steps), both embedding tables (the embedding is a one-hot
    product) and the final norm."""
    lay = params["layers"]
    size = lambda t: t.numel() * t.element_size()
    expert = sum(size(lay[n][0, 0]) for n in ("w1", "w3", "w2"))
    dense = sum(size(v[0]) for n, v in lay.items()
                if n not in ("w1", "w3", "w2"))
    tables = sum(size(params[n]) for n in ("embed", "out_embed",
                                           "final_norm"))
    return cfg.L * dense + expert * per_step.sum(1).mean() + tables


def moe_phase(args, dev, on_card: bool, power: str) -> None:
    """Phase 26: the moe family's serving path (`models/moe.py`'s router
    and `moe_dense_ref` under `lm.py`, `steps.py` and `launch/serve.py`)
    — checks on a 2-layer cut of dbrx-132b's full widths and on reduced
    arctic-480b, each comparing the routes first and the values second;
    then dbrx-132b served at full width, L = 2, through
    `repro_torch.launch.serve.serve`.  Launches none of the seven
    kernels (no `pallas_call` on this path)."""
    import dataclasses

    from repro_torch import prng
    from repro_torch import tree as T
    from repro_torch.configs import base as CB
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm, steps

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t_phase = time.perf_counter()
    counts0 = launch_counts()
    full = CB.get("dbrx-132b")
    if not on_card:
        full = CB.reduced(full)                  # rehearsal size
    u = 2.0 ** -8                                # bfloat16's unit roundoff
    host = lambda tree: T.tree_map(lambda t: t.to("cpu", copy=True), tree)
    nparams = lambda tree: sum(t.numel() for t in T.leaves(tree))
    rng = np.random.default_rng(args.seed + 26)

    def err(a, b):
        e = (a.float().cpu() - b.float().cpu()).abs()
        return float(e.max()), float(e.mean())

    # ---- (a) a 2-layer cut of the full widths ----
    cut = dataclasses.replace(full, L=2)
    c32 = dataclasses.replace(cut, dtype="float32")
    B2, S2 = 2, 32
    p = lm.init_params(cut, prng.PRNGKey(0), model_shards=1, device=dev)
    toks = torch.from_numpy(rng.integers(0, cut.vocab, (B2, S2)).astype(
        np.int32)).to(dev)
    with torch.no_grad():
        lg32, e32, _ = moe_routes(c32, p, toks)
        fwd = steps.logits_of(c32, p, lm.forward(c32, p, {"tokens": toks}))
        lgbf, ebf, _ = moe_routes(cut, p, toks)
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            lgtf, etf, _ = moe_routes(c32, p, toks)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    sync()
    if not torch.equal(fwd, lg32):
        raise AssertionError("the composed layer loop differs from "
                             "lm.forward")
    hp = host(p)
    t0 = time.perf_counter()
    with torch.no_grad():
        ref, e0, gap0 = moe_routes(c32, hp, toks.cpu())
        forced, _, _ = moe_routes(c32, hp, toks.cpu(), force=ebf)
    t_cpu = time.perf_counter() - t0
    rms = float(ref.pow(2).mean().sqrt())
    same = bool(torch.equal(e32, e0))
    f_max, f_mean = err(lg32, ref)
    t_max, _ = err(lgtf, ref)
    t_flip = float((etf != e0).any(-1).float().mean())
    # the H100 read 3.5e-5·rms (PERF.md §6); TF32 products 1.8e-2·rms
    lim = 2e-4 * rms
    print(f"[26 cpu32] {cut.name} cut to L=2 (d={cut.d_model}, "
          f"{cut.n_experts} experts of ff={cut.d_ff}, top {cut.moe_top_k}, "
          f"V={cut.vocab_padded(1)}, {nparams(p) / 1e9:.4f}e9 params), B={B2}"
          f" S={S2}, float32, card vs CPU (CPU {t_cpu:.1f} s for two "
          f"forwards): routes equal on every (token, layer): {same} "
          f"(smallest gap between the k-th and (k+1)-th router logit "
          f"{float(gap0.min()):.4g}); logits max abs {f_max:.4g}, mean "
          f"{f_mean:.4g} (logit rms {rms:.4g}; limit 2e-4·rms {lim:.4g}); "
          f"control, TF32 products on the card: max abs {t_max:.4g}, routes "
          f"differing on {t_flip:.4f} of the (token, layer) pairs (power "
          f"limit {power})", flush=True)
    if not same:
        raise AssertionError("the card's float32 routes differ from the "
                             "CPU's")
    if not f_max <= lim:
        raise AssertionError("the card's float32 logits disagree with the "
                             "CPU's")
    if on_card and not t_max > lim:
        raise AssertionError("the logit limit passes TF32 products: it does "
                             "not hold the card to float32")
    # the card's bfloat16 forward against the CPU's float32 one, routes
    # first: a route flips where the set of k experts differs (an order
    # that differs only reorders the slot sum).  A flip moves its row by
    # O(1), and attention carries that on to the later positions, so the
    # values are held against the CPU's float32 forward run on the card's
    # routes; the rows whose own routes agree in every layer are shown
    # beside it, and the forward on the CPU's own routes is the control
    flip = (ebf.sort(-1).values != e0.sort(-1).values).any(-1)   # [L, B, S]
    agree = float(1 - flip.float().mean())
    rows = ~flip.any(0)                                  # [B, S]
    b_max, b_mean = err(lgbf, forced)
    r_max, r_mean = err(lgbf.cpu()[rows], ref[rows])
    k_max, _ = err(lgbf, ref)
    # the card read max 41u·rms and mean 4.5u·rms over the 64 positions
    # (phase 23 holds 4 positions: 24u·rms) and agreed on 0.9375 of the
    # routes (PERF.md §6)
    lim_b = (64 * u * rms, 8 * u * rms)
    floor = 0.85
    print(f"[26 cpu] the card's bfloat16 forward vs the CPU's float32: "
          f"routes agree on {agree:.4f} of the (token, layer) pairs "
          f"({int(flip.sum())} of {flip.numel()} flipped; floor {floor}); "
          f"logits against the CPU's float32 forward on the card's routes "
          f"max abs {b_max:.4g}, mean {b_mean:.4g} (limits 64u·rms "
          f"{lim_b[0]:.4g}, 8u·rms {lim_b[1]:.4g}, u = 2^-8); on the "
          f"{float(rows.float().mean()):.4f} of the rows whose own routes "
          f"agree in every layer, against the CPU's own routes: max abs "
          f"{r_max:.4g}, mean {r_mean:.4g}; control, every row against the "
          f"CPU's own routes: max abs {k_max:.4g} (power limit {power})",
          flush=True)
    if not agree >= floor:
        raise AssertionError("too many of the bfloat16 routes flipped")
    if not (b_max <= lim_b[0] and b_mean <= lim_b[1]):
        raise AssertionError("the card's bfloat16 logits disagree with the "
                             "CPU's")
    if bool(flip.any()) and not k_max > lim_b[0]:
        raise AssertionError("the bfloat16 limit passes flipped routes")
    del hp, ref, forced, lgbf, lgtf, fwd
    gc_collect(on_card)
    # the KV cache at float32: prefill's last-position logits against a
    # token-by-token decode (a float32 cache), and a decode whose cache is
    # zeroed before each step (the control)
    pre, _ = steps.make_prefill(c32)(p, {"tokens": toks})
    dec = steps.make_decode_step(c32)
    outs = []
    for drop in (False, True):
        cache = steps.init_cache(c32, B2, S2, dtype=torch.float32, device=dev)
        for t in range(S2):
            if drop:
                cache["k"].zero_()
                cache["v"].zero_()
            lg, cache = dec(p, cache, toks[:, t:t + 1])
        outs.append(lg[:, 0])
    sync()
    rms_p = float(pre.pow(2).mean().sqrt())
    d_max, d_mean = err(outs[0], pre)
    k_max, k_mean = err(outs[1], pre)
    lim_d = (16 * u * rms_p, 4 * u * rms_p)
    print(f"[26 cache] float32, a {S2}-step decode (float32 cache) vs "
          f"prefill's last-position logits: max abs {d_max:.4g}, mean "
          f"{d_mean:.4g} (logit rms {rms_p:.4g}; limits 16u·rms "
          f"{lim_d[0]:.4g}, 4u·rms {lim_d[1]:.4g}); control, the cache zeroed"
          f" before each step: max {k_max:.4g}, mean {k_mean:.4g} (power "
          f"limit {power})", flush=True)
    if not (d_max <= lim_d[0] and d_mean <= lim_d[1]):
        raise AssertionError("the decode's KV cache disagrees with prefill")
    if not (k_max > lim_d[0] and k_mean > lim_d[1]):
        raise AssertionError("the cache check passes a decode without its "
                             "cache")
    del p, pre, outs, cache
    gc_collect(on_card)
    # reduced arctic-480b: top 2 of 4 and the dense residual MLP
    arc = dataclasses.replace(CB.reduced(CB.get("arctic-480b")),
                              dtype="float32")
    pa = lm.init_params(arc, prng.PRNGKey(0), model_shards=1, device=dev)
    ta = torch.from_numpy(rng.integers(0, arc.vocab, (B2, S2)).astype(
        np.int32)).to(dev)
    with torch.no_grad():
        lga, ea, _ = moe_routes(arc, pa, ta)
        lga0, ea0, gapa = moe_routes(arc, host(pa), ta.cpu())
    a_max, _ = err(lga, lga0)
    print(f"[26 arctic] {arc.name} reduced (top {arc.moe_top_k} of "
          f"{arc.n_experts}, dense residual ff {arc.moe_dense_ff}), float32, "
          f"card vs CPU: routes equal {bool(torch.equal(ea, ea0))} (smallest "
          f"gap {float(gapa.min()):.4g}); logits max abs {a_max:.4g} (limit "
          f"1e-4) (power limit {power})", flush=True)
    if not (torch.equal(ea, ea0) and a_max <= 1e-4):
        raise AssertionError("reduced arctic-480b: the card disagrees with "
                             "the CPU")
    del pa, lga, lga0
    gc_collect(on_card)

    # ---- (b) dbrx-132b served at full width, L = 1 (L = 4 until phase
    # 29 and L = 2 until phase 30 needed the script's time) ----
    t_a = time.perf_counter() - t_phase
    served = dataclasses.replace(full, L=1)
    B, S, GEN = 4, 64, 32
    held = torch.cuda.memory_allocated() / 1e6 if on_card else 0.0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(served, prng.PRNGKey(0), model_shards=1,
                            device=dev)
    sync()
    t_init = time.perf_counter() - t0
    draw_peak = torch.cuda.max_memory_allocated() / 1e6 if on_card else 0.0
    logs = []
    out, st = serve(served, batch=B, prompt_len=S, gen=GEN, seed=0,
                    log=logs.append, device=dev, params=params)
    o = out.cpu().numpy()
    if o.shape != (B, GEN + 1) or not ((o >= 0) & (o < served.vocab)).all():
        raise AssertionError(f"served tokens {o.shape} out of range")
    per_step, pre_counts = replay_experts(served, params, out, B, S, dev)
    step_bytes = moe_step_bytes(served, params, per_step)
    bound_s = step_bytes / HBM_BYTES_PER_S
    nparam = nparams(params)
    print(f"[26 serve] {served.name} cut to L={served.L} of {full.L} (full "
          f"widths: {nparam / 1e10:.4f}e10 float32 params, "
          f"{4 * nparam / 1e9:.2f} GB) batch {B}, prompt {S} (one prefill "
          f"forward), gen {GEN}: params drawn in {t_init:.2f} s, prefill "
          f"{st['prefill_s']:.3f} s, decode {st['decode_s']:.3f} s, "
          f"{st['tok_per_s']:.1f} tokens/s (bound {B / bound_s:.0f} "
          f"tokens/s: {step_bytes / 1e9:.2f} GB of float32 weights a step, "
          f"{1e3 * bound_s:.2f} ms); distinct experts a layer a decode step "
          f"mean {per_step.mean():.2f} (min {per_step.min():.0f}, max "
          f"{per_step.max():.0f}) of {served.n_experts}, prefill "
          f"{pre_counts}; host syncs a step {served.L} (one a layer) "
          + (f"resident {st['resident_mb']:.0f} MB, serve's peak "
             f"{st['peak_mb']:.0f} MB, the draw's peak {draw_peak:.0f} MB "
             f"(phases before it held {held:.0f} MB) " if on_card else "")
          + f"(power limit {power})", flush=True)
    if on_card:
        profile_decode(served, params, B, S, dev, tag="26 profile")
    del params, out
    gc_collect(on_card)

    launched = {k: v - counts0[k] for k, v in launch_counts().items()}
    print(f"[26 kernels] launches in phase 26: {launched} (the router and "
          f"the experts are plain torch products, as the JAX package's are "
          f"plain XLA; no segment_add)", flush=True)
    if any(launched.values()):
        raise AssertionError("phase 26 launched a kernel it should not")
    t_all = time.perf_counter() - t_phase
    print(f"[26 done] phase 26 in {t_all:.1f} s: (a) {t_a:.1f}, (b) "
          f"{t_all - t_a:.1f} s (power limit {power})", flush=True)


def moe_step_flops(cfg, B: int, S: int) -> tuple[float, float]:
    """(bf16, float32) multiply-add FLOPs of one moe train step from the
    shapes: the attention projections, each token's k experts' three
    products, arctic's dense residual MLP and the one-hot embedding
    product in bfloat16; the router, the attention scores and the logits
    in float32.  Forward once, the layers again under remat, backward
    twice each product (the one-hot product once)."""
    D, Hq, Hk, hd = cfg.d_model, cfg.n_heads_padded, cfg.n_kv, cfg.hd
    V, n, k = cfg.vocab_padded(1), B * S, cfg.moe_top_k
    proj = 2 * n * D * (2 * Hq * hd + 2 * Hk * hd)              # per layer
    experts = 2 * n * k * 3 * D * cfg.d_ff + 2 * n * 3 * D * cfg.moe_dense_ff
    router = 2 * n * D * cfg.n_experts
    attn = 2 * 2 * B * Hq * S * S * hd
    emb = logits = 2 * n * V * D
    bf16 = cfg.L * (proj + experts) * 4 + emb * 2
    f32 = cfg.L * (attn + router) * 4 + logits * 3
    return float(bf16), float(f32)


def bit_sums(tree) -> list:
    """Two checksums of each leaf's raw bits, Σ wᵢ·mᵢ mod p (p = 2³¹ − 1)
    for two fixed multiplier streams mᵢ (never 0 mod p), summed exactly in
    int64 on the leaf's device: one word that differs always changes
    them unless its difference is a multiple of p.  Two states whose sums
    differ are not bit-equal."""
    from repro_torch import tree as T

    P, CH = 2 ** 31 - 1, 1 << 26
    out = []
    for t in T.leaves(tree):
        w = t.detach().reshape(-1)
        w = w.view(torch.int16 if w.element_size() == 2 else torch.int32)
        sums = [0, 0]
        for lo in range(0, w.numel(), CH):
            x = w[lo:lo + CH].to(torch.int64)
            i = torch.arange(lo, lo + x.numel(), dtype=torch.int64,
                             device=x.device)
            for j, a in enumerate((48271, 69621)):
                m = (i * a) % (P - 1) + 1
                sums[j] += int(((x * m) % P).sum())
        out.append((sums[0] % P, sums[1] % P))
    return out


def moe_train_phase(args, dev, on_card: bool, power: str) -> None:
    """Phase 27: the moe family's training (`models/moe.py`'s
    differentiable `moe_dense_ref` under `lm_loss`, `make_train_step`'s
    in-place microbatch sum, `adam_update` in slices, `launch/train.py::
    train_loop`, bfloat16 moments through `train/checkpoint.py`) —
    dbrx-132b at full width cut to L = 1 of 40, the one depth whose Adam
    state one card holds: (a) the card against the CPU at float32, routes
    first — a router and 4 experts at the full d and d_ff forward and
    backward, then the whole loss, its gradients and an Adam update on
    "dbrx-132b:16x4"; (b) `train_loop` with the config's own µ = 4 and
    bfloat16 moments, the step's time, peak memory and profile, the loop
    run twice bit-equal; (c) a bfloat16-moment checkpoint and resume on
    reduced dbrx-132b; reduced arctic-480b's train step card vs CPU.
    Launches none of the seven kernels."""
    import dataclasses
    import shutil

    from repro_torch import prng
    from repro_torch import tree as T
    from repro_torch.configs import base as CB
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import train as ltrain
    from repro_torch.models import lm, steps
    from repro_torch.models import moe as MOE
    from repro_torch.train import checkpoint as ckpt

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t_phase = time.perf_counter()
    counts0 = launch_counts()
    base = CB.get("dbrx-132b")
    own = dict(microbatches=base.microbatches, moment_dtype=base.moment_dtype,
               grad_dtype=base.grad_dtype)
    reduced = dataclasses.replace(CB.reduced(base), **own)
    # full width, L = 1 of 40 (PERF.md §4); the CPU rehearses reduced
    full = dataclasses.replace(base if on_card else reduced, L=1)
    host = lambda tree: T.tree_map(lambda t: t.to("cpu", copy=True), tree)
    on_dev = lambda b: {k: v.to(dev) for k, v in b.items()}
    nparams = lambda tree: sum(t.numel() for t in T.leaves(tree))
    rng = np.random.default_rng(args.seed + 27)
    mb = lambda: torch.cuda.memory_allocated() / 1e6 if on_card else 0.0

    def tokens(cfg, B, S):
        return {k: torch.from_numpy(rng.integers(0, cfg.vocab, (
            B, S)).astype(np.int32)) for k in ("tokens", "labels")}

    # ---- (a) the card against the CPU, float32, µ = 1, B 2 x S 32 ----
    # each gradient leaf within 1e-4 of its own max |g| (phase 24's limit;
    # a TF32 control must read above it)
    GRAD_REL = 1e-4
    t0 = time.perf_counter()
    # (a') a router and experts at the full d and d_ff, forward and
    # backward, card vs CPU, against a fixed cotangent: 4 experts, top 2
    # (all 16 took 44.3–50.3 s, most of it 12.7 GB through the host and
    # the CPU's backward)
    e32 = dataclasses.replace(full, dtype="float32", n_experts=4,
                              moe_top_k=2)
    D, E, ff = e32.d_model, e32.n_experts, e32.d_ff
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    draw = lambda *shape: torch.randn(shape, generator=gen,
                                      device=dev).mul_(0.02)
    w = dict(router=draw(D, E), w1=draw(E, D, ff), w3=draw(E, D, ff),
             w2=draw(E, ff, D))
    x, R = draw(2, 32, D).mul_(50.0), draw(2, 32, D)

    def expert_grads(w, x, R):
        wt = {n: t.detach().requires_grad_(True) for n, t in w.items()}
        xt = x.detach().requires_grad_(True)
        eid, gate = MOE.router(wt, xt, e32)
        y = MOE.moe_dense_ref(wt, xt, eid, gate, e32)
        (y * R).sum().backward()
        return eid, dict(y=y.detach(), x=xt.grad,
                         **{n: wt[n].grad for n in w})

    e_dev, got = expert_grads(w, x, R)
    e_cpu, want = expert_grads(host(w), x.cpu(), R.cpu())
    ff_worst, ff_path = worst_leaf(got, want)
    tf_ff = float("nan")
    if on_card:
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf_ff = worst_leaf(expert_grads(w, x, R)[1], want)[0]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    same_ff = bool(torch.equal(e_dev.cpu(), e_cpu))
    del w, got, want
    gc_collect(on_card)
    print(f"[27 cpu] moe.router + moe_dense_ref at {full.name}'s d and "
          f"d_ff ({E} experts of {D} x {ff}, top {e32.moe_top_k}; "
          f"random weights), float32, 64 tokens: routes card = CPU "
          f"{same_ff}; the output and each gradient (x, router, w1, w3, "
          f"w2) within {ff_worst:.3g} of its own max ({ff_path}; limit "
          f"{GRAD_REL}); control, TF32 products: {tf_ff:.3g}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if not (same_ff and ff_worst <= GRAD_REL):
        raise AssertionError("the full-width experts' backward: the card "
                             "disagrees with the CPU")
    if on_card and not tf_ff > GRAD_REL:
        raise AssertionError("the experts' limit passes TF32 products")
    # the whole loss on "dbrx-132b:16x4" (16 experts, top 4, the reduced
    # widths): at full widths the CPU's half of this check took 215.4 s on
    # the card's host (PERF.md §4), a fifth of the script's time
    cut = dataclasses.replace(reduced, n_experts=16, moe_top_k=4, L=1,
                              dtype="float32", microbatches=1)
    p = lm.init_params(cut, prng.PRNGKey(0), model_shards=1, device=dev)
    hp = host(p)
    b = tokens(cut, 2, 32)
    with torch.no_grad():
        _, e_dev, _ = moe_routes(cut, p, b["tokens"].to(dev))
        _, e_cpu, gap = moe_routes(cut, hp, b["tokens"])
    same = bool(torch.equal(e_dev, e_cpu))
    print(f"[27 cpu] the reduced 'dbrx-132b:16x4' config at L = 1 "
          f"(d={cut.d_model}, {cut.n_experts} experts of "
          f"ff={cut.d_ff}, top {cut.moe_top_k}, V={cut.vocab_padded(1)}; "
          f"{nparams(p) / 1e6:.3f}e6 params), float32 B=2 S=32, "
          f"lm_loss: routes card = CPU on all "
          f"{e_cpu.numel()} (token, slot) pairs: {same} (smallest gap "
          f"between the k-th and (k+1)-th router logit "
          f"{float(gap.min()):.4g})", flush=True)
    if not same:
        raise AssertionError("the card's routes differ from the CPU's")
    lc, g_dev = steps.value_and_grad(cut, p, on_dev(b))
    l0, g0 = steps.value_and_grad(cut, hp, b)
    worst, path = worst_leaf(g_dev, g0)
    rel = abs(float(lc) - float(l0)) / abs(float(l0))
    tf_worst, tf_path = float("nan"), "-"
    if on_card:
        tf_worst, tf_path = worst_leaf(tf32_grads(cut, p, on_dev(b)), g0)
    del g0
    gc_collect(on_card)
    upd_cpu = steps.adam_update(cut, hp, host(g_dev), steps.init_opt(cut, hp))
    upd_dev = steps.adam_update(cut, p, g_dev, steps.init_opt(cut, p))
    adam_err = max(float((a.cpu().float() - w.float()).abs().max())
                   for a, w in zip(T.leaves(upd_dev[:2]),
                                   T.leaves(upd_cpu[:2])))
    print(f"[27 cpu] loss card {float(lc):.6f} vs CPU {float(l0):.6f} (rel "
          f"{rel:.3g}, limit 1e-5); worst gradient leaf {worst:.3g} of its "
          f"max |g| ({path}; limit {GRAD_REL}); control, TF32 products on "
          f"the card: worst leaf {tf_worst:.3g} ({tf_path}); Adam update of "
          f"the card's gradients ({cut.moment_dtype} moments) card vs CPU "
          f"max abs {adam_err:.3g} (limit 1e-6) (power limit {power})",
          flush=True)
    if not (rel <= 1e-5 and worst <= GRAD_REL):
        raise AssertionError("the card's loss or gradients disagree with "
                             "the CPU's")
    if on_card and not tf_worst > GRAD_REL:
        raise AssertionError("the gradient bound passes TF32 products: it "
                             "does not hold the card to float32")
    if not adam_err <= 1e-6:
        raise AssertionError("the card's Adam update disagrees with the "
                             "CPU's")
    del p, hp, g_dev, upd_cpu, upd_dev
    gc_collect(on_card)
    t_a = time.perf_counter() - t_phase

    # ---- (b) dbrx-132b at full width, L = 1, its own training settings ----
    # 3 timed steps (5 until phase 31 took the script's time); 10 loop
    # steps: after 4 the loss had not fallen (12.65 -> 15.11 -> 12.96)
    B, S, N_STEPS, N_TIMED = 8, 128, 10, 3
    held = mb()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    per_call, orig = [], MOE.moe_dense_ref

    def counted(pl, x, eid, gate, cfg):
        per_call.append(int(torch.unique(eid).numel()))
        return orig(pl, x, eid, gate, cfg)

    loop = lambda: ltrain.train_loop(full, steps_n=N_STEPS, batch=B, seq=S,
                                     log=lambda *_: None, device=dev,
                                     seed=args.seed)
    MOE.moe_dense_ref = counted        # the loop's routes, one sync a call
    try:
        t0 = time.perf_counter()
        params, opt, losses = loop()
        wall = time.perf_counter() - t0
    finally:
        MOE.moe_dense_ref = orig
    loop_peak = torch.cuda.max_memory_allocated() / 1e6 if on_card else 0.0
    sums = bit_sums((params, opt))      # for the run again below
    nparam, resident = nparams(params), mb()
    # the step's own time: the loop's step function over batches drawn
    # beforehand, each step synchronised (median of steps 1 on)
    step_fn = steps.make_train_step(full)
    trng = np.random.default_rng(args.seed + 1)
    batches = [ltrain.synth_batch(trng, full, B, S, device=dev)
               for _ in range(N_TIMED)]
    marks = []
    for tb in batches:
        t = time.perf_counter()
        params, opt, aux = step_fn(params, opt, tb)
        sync()
        marks.append(time.perf_counter() - t)
    step_s = float(np.median(marks[1:]))
    peak = torch.cuda.max_memory_allocated() / 1e6 if on_card else 0.0
    per_call = np.asarray(per_call, dtype=np.float64)
    # the bound: Adam reads p, g, m, v and writes p, m, v once (4 + 4 + 2
    # + 2 + 4 + 2 + 2 B a parameter at bfloat16 moments); each microbatch's
    # forward and backward read the float32 experts once each
    md = torch.empty((), dtype=getattr(torch, full.moment_dtype))
    adam_bytes = nparam * (3 * 4 + 4 * md.element_size())
    expert_bytes = 4 * sum(params["layers"][n].numel()
                           for n in ("w1", "w3", "w2"))
    b_bytes = adam_bytes + full.microbatches * 2 * expert_bytes
    bf, f32 = moe_step_flops(full, B, S)
    t_bytes = b_bytes / HBM_BYTES_PER_S
    t_ops = bf / BF16_OPS_PER_S + f32 / F32_OPS_PER_S
    timed_cell("27", full, B, S, max(t_bytes, t_ops), step_s)
    print(f"[27 train] {full.name} at L={full.L} of {base.L}, full widths "
          f"({nparam / 1e9:.4f}e9 float32 params, µ={full.microbatches}, "
          f"{full.moment_dtype} moments, {full.grad_dtype} gradients, "
          f"{full.dtype} compute) batch {B} seq {S}: {N_STEPS} train_loop "
          f"steps in {wall:.1f} s (the draw included), loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; then {N_TIMED} "
          f"synchronised make_train_step steps, median of steps 1-"
          f"{N_TIMED - 1} {step_s:.4f} s (min {min(marks[1:]):.4f}, max "
          f"{max(marks[1:]):.4f}), {B * S / step_s:.0f} tokens/s; distinct "
          f"experts a layer a microbatch (each of {len(per_call)} calls: "
          f"µ x 2 a step under remat) mean {per_call.mean():.2f} (min "
          f"{per_call.min():.0f}, max {per_call.max():.0f}) of "
          f"{full.n_experts}; "
          + (f"resident {resident:.0f} MB; the card's peak {peak:.0f} MB "
             f"(the loop's {loop_peak:.0f} MB), of which phases before it "
             f"held {held:.0f} MB: the training's own peak "
             f"{peak - held:.0f} MB (limit 70000 MB) " if on_card else "")
          + f"(power limit {power})", flush=True)
    print(f"[27 bound] bytes: Adam {adam_bytes / 1e9:.2f} GB + {full.microbatches}"
          f" x 2 reads of the {expert_bytes / 1e9:.2f} GB of float32 experts "
          f"= {b_bytes / 1e9:.2f} GB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s "
          f"{1e3 * t_bytes:.2f} ms; operations: {bf / 1e12:.3f} TFLOP in "
          f"bf16 products at {BF16_OPS_PER_S / 1e12:.0f} TFLOP/s + "
          f"{f32 / 1e12:.3f} TFLOP in float32 products at "
          f"{F32_OPS_PER_S / 1e12:.0f} TFLOP/s {1e3 * t_ops:.2f} ms; bound "
          f"{1e3 * max(t_bytes, t_ops):.2f} ms (by "
          f"{'bytes' if t_bytes >= t_ops else 'operations'}); the step took "
          f"{1e3 * step_s:.2f} ms", flush=True)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"the full-width loss did not fall: {losses}")
    # the limit holds what the training itself allocates: the earlier
    # phases' state (the serving catalog, ~2.6 GB) is not the step's
    if on_card and not peak - held <= 70000:
        raise AssertionError(f"the training's own peak {peak - held:.0f} MB "
                             f"passed 70000 MB")
    if on_card:
        profile_train_step(full, params, opt, batches[0], tag="27 profile",
                           n_top=6)
    # the loop again from the seed's draw (two states do not fit on the
    # card beside a step): every loss equal and each parameter and moment
    # leaf's bit sums (`bit_sums`) equal after its steps
    t0 = time.perf_counter()
    del params, opt, batches
    gc_collect(on_card)
    params, opt, again = loop()
    equal = again == losses and bit_sums((params, opt)) == sums
    print(f"[27 repro] train_loop run twice from the seed's draw: the "
          f"{N_STEPS} losses equal {again == losses}, the {len(sums)} "
          f"parameter and moment leaves' bit sums after step {N_STEPS} "
          f"equal {equal} ({time.perf_counter() - t0:.1f} s)", flush=True)
    if not equal:
        raise AssertionError("two train_loop runs from one state differ")
    del params, opt
    gc_collect(on_card)
    t_b = time.perf_counter() - t_phase - t_a

    # ---- (c) a bfloat16-moment checkpoint on the card, reduced dbrx ----
    d = os.path.join(ROOT, "build", "chip_smoke_moe_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    kw = dict(batch=B, seq=S, device=dev, seed=args.seed)
    p5, o5, first = ltrain.train_loop(reduced, steps_n=5, ckpt_dir=d,
                                      ckpt_every=5, log=lambda *_: None, **kw)
    got, step = ckpt.restore(d, (p5, o5))
    bits = lambda t: t.reshape(-1).view(torch.uint8)
    same = step == 5 and all(
        a.dtype == w.dtype and a.device == w.device
        and torch.equal(bits(a), bits(w))
        for a, w in zip(T.leaves(got), T.leaves((p5, o5))))
    del got
    # the loop resumed from the checkpoint against the same state stepped
    # on in memory (both draw the seed's first batches again)
    logs = []
    _, o10, resumed = ltrain.train_loop(reduced, steps_n=10, ckpt_dir=d,
                                        log=logs.append, **kw)
    step_fn = steps.make_train_step(reduced)
    brng, in_mem = np.random.default_rng(args.seed), []
    for _ in range(5):
        p5, o5, aux = step_fn(p5, o5, ltrain.synth_batch(
            brng, reduced, B, S, device=dev))
        in_mem.append(float(aux["loss"]))
    mdt = T.leaves(o10["m"])[0].dtype
    print(f"[27 ckpt] reduced {reduced.name} (µ={reduced.microbatches}, "
          f"{mdt} moments): the step-5 checkpoint restored every leaf bit "
          f"for bit: {same}; resumed {logs[:1]}: losses {resumed} vs the "
          f"state in memory {in_mem}: equal {resumed == in_mem} (first five "
          f"{first[0]:.4f} -> {first[-1]:.4f})", flush=True)
    shutil.rmtree(d, ignore_errors=True)
    if not (same and mdt == torch.bfloat16 and resumed == in_mem
            and logs[:1] == ["resumed from step 5"]):
        raise AssertionError("the bfloat16-moment checkpoint did not resume "
                             "bit for bit")
    # reduced arctic-480b: top 2 of 4 and the dense residual MLP
    arc = dataclasses.replace(CB.reduced(CB.get("arctic-480b")),
                              dtype="float32")
    pa = lm.init_params(arc, prng.PRNGKey(0), model_shards=1, device=dev)
    hpa = host(pa)
    ba = tokens(arc, 2, 32)
    with torch.no_grad():
        _, ea, _ = moe_routes(arc, pa, ba["tokens"].to(dev))
        _, ea0, gapa = moe_routes(arc, hpa, ba["tokens"])
    step_a = steps.make_train_step(arc)
    _, oa, auxa = step_a(pa, steps.init_opt(arc, pa), on_dev(ba))
    _, oa0, auxa0 = step_a(hpa, steps.init_opt(arc, hpa), ba)
    a_rel = abs(float(auxa["loss"]) - float(auxa0["loss"])) / abs(
        float(auxa0["loss"]))
    a_worst, a_path = worst_leaf(oa["m"], oa0["m"])
    print(f"[27 arctic] {arc.name} reduced (top {arc.moe_top_k} of "
          f"{arc.n_experts}, dense residual ff {arc.moe_dense_ff}), float32, "
          f"one train step card vs CPU: routes equal "
          f"{bool(torch.equal(ea, ea0))} (smallest gap {float(gapa.min()):.4g})"
          f"; loss rel {a_rel:.3g} (limit 1e-5); the first moment's worst "
          f"leaf {a_worst:.3g} of its max ({a_path}; limit {GRAD_REL}) "
          f"(power limit {power})", flush=True)
    if not (torch.equal(ea, ea0) and a_rel <= 1e-5 and a_worst <= GRAD_REL):
        raise AssertionError("reduced arctic-480b's train step: the card "
                             "disagrees with the CPU")
    del pa, hpa, oa, oa0, p5, o5, o10
    gc_collect(on_card)

    launched = {k: v - counts0[k] for k, v in launch_counts().items()}
    print(f"[27 kernels] launches in phase 27: {launched} (the experts, their"
          f" backward and Adam are plain torch products and elementwise "
          f"ops, as the JAX package's are plain XLA; no segment_add: the "
          f"pairs move by permutations)", flush=True)
    if any(launched.values()):
        raise AssertionError("phase 27 launched a kernel it should not")
    t_all = time.perf_counter() - t_phase
    print(f"[27 done] phase 27 in {t_all:.1f} s: (a) {t_a:.1f}, (b) "
          f"{t_b:.1f}, (c) {t_all - t_a - t_b:.1f} s (power limit {power})",
          flush=True)


def encdec_cross_fill(cfg, p, frontend_embeds, cache) -> None:
    """Fill an encdec ``cache``'s ``cross_k`` / ``cross_v`` from the
    encoder's output, each decoder layer's K/V projected as the
    reference's `_forward_encdec` projects them (``wk`` / ``wv`` alone).
    The package's `serve` leaves them zero, as the reference's does: no
    entry point fills them."""
    from repro_torch.models import lm

    with torch.no_grad():
        xe = lm._encode(cfg, p, frontend_embeds)
        for n, w in (("cross_k", "wk"), ("cross_v", "wv")):
            for i in range(cfg.L):
                cache[n][i] = torch.einsum(
                    "bsd,dhk->bshk", xe,
                    p["dec_cross"][w][i].to(xe.dtype)).to(cache[n].dtype)


def decode_all(cfg, p, toks, cache) -> torch.Tensor:
    """``toks`` [B, S] decoded one by one (teacher-forced) from ``cache``
    → each step's logits [B, S, V]."""
    from repro_torch.models import steps

    dec = steps.make_decode_step(cfg)
    outs = []
    for t in range(toks.shape[1]):
        lg, cache = dec(p, cache, toks[:, t:t + 1])
        outs.append(lg[:, 0])
    return torch.stack(outs, 1)


def encdec_vlm_phase(args, dev, on_card: bool, power: str) -> None:
    """Phase 28: the encdec and vlm families' serving half (`lm.py`'s
    `_forward_encdec` and vlm branch, `steps.py`'s `decode_encdec`, the
    cross caches and the prefix in `prefill_dense`) — card-vs-CPU checks
    on 2-layer cuts of seamless-m4t-large-v2's and llava-next-mistral-
    7b's full widths, decode = forward for encdec on the card, both
    served at full width and half their depth through
    `repro_torch.launch.serve.serve`, and llava behind a 2,880-patch
    image prefix.  Launches none
    of the seven kernels (no `pallas_call` on this path)."""
    import dataclasses

    from repro_torch import prng
    from repro_torch import tree as T
    from repro_torch.configs import base as CB
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm, steps

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t_phase = time.perf_counter()
    counts0 = launch_counts()
    sea, lla = CB.get("seamless-m4t-large-v2"), CB.get(
        "llava-next-mistral-7b")
    n_patch = VLM_PATCHES
    if not on_card:                              # rehearsal size
        sea, lla, n_patch = CB.reduced(sea), CB.reduced(lla), 16
    u = 2.0 ** -8                                # bfloat16's unit roundoff
    host = lambda tree: T.tree_map(lambda t: t.to("cpu", copy=True), tree)
    nparams = lambda tree: sum(t.numel() for t in T.leaves(tree))
    rng = np.random.default_rng(args.seed + 28)
    rms = lambda x: float(x.float().pow(2).mean().sqrt())

    def err(a, b):
        e = (a.float().cpu() - b.float().cpu()).abs()
        return float(e.max()), float(e.mean())

    def normal(*shape):
        return torch.from_numpy(rng.normal(0, 0.02, shape).astype(
            np.float32)).to(dev)

    def tokens(cfg, B, S):
        return torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(
            np.int32)).to(dev)

    # ---- (a) seamless-m4t-large-v2, 2 + 2 layers at full width ----
    cut = dataclasses.replace(sea, L=2, enc_layers=2)
    c32 = dataclasses.replace(cut, dtype="float32")
    B2, F2, S2 = 2, 128, 64
    p = lm.init_params(cut, prng.PRNGKey(0), model_shards=1, device=dev)
    b = {"tokens": tokens(cut, B2, S2),
         "frontend_embeds": normal(B2, F2, cut.d_model)}
    hp, hb = host(p), host(b)

    def cache_of(cfg, q, batch, dt):
        c = steps.init_cache(cfg, B2, F2, dtype=dt,
                             device=batch["tokens"].device)
        encdec_cross_fill(cfg, q, batch["frontend_embeds"], c)
        return c

    t0 = time.perf_counter()
    with torch.no_grad():
        ref = steps.logits_of(c32, hp, lm.forward(c32, hp, hb))
        ref_dec = decode_all(c32, hp, hb["tokens"],
                             cache_of(c32, hp, hb, torch.float32))
    t_cpu = time.perf_counter() - t0
    with torch.no_grad():
        fwd = lambda cfg, q: steps.logits_of(cfg, q, lm.forward(cfg, q, b))
        lg32 = fwd(c32, p)
        lgtf = tf32(lambda: fwd(c32, p))
        lgbf = fwd(cut, p)
        # control: the cross-attention's output projection zeroed
        nox = dict(p, dec_cross=dict(p["dec_cross"], wo=torch.zeros_like(
            p["dec_cross"]["wo"])))
        lgnx = fwd(cut, nox)
        del nox
    dec32 = decode_all(c32, p, b["tokens"], cache_of(c32, p, b,
                                                     torch.float32))
    decbf = decode_all(cut, p, b["tokens"], cache_of(cut, p, b,
                                                     torch.bfloat16))
    decz = decode_all(cut, p, b["tokens"], steps.init_cache(
        cut, B2, F2, device=dev))                # zero cross caches (serve's)
    sync()
    r32, rbf = rms(ref), rms(lgbf)
    f_max, f_mean = err(lg32, ref)
    t_max, _ = err(lgtf, ref)
    b_max, b_mean = err(lgbf, ref)
    x_max, _ = err(lgnx, ref)
    d_max, _ = err(dec32, ref_dec)
    e_max, e_mean = err(decbf, lgbf)
    z_max, z_mean = err(decz, lgbf)
    lim32, limbf, limd = 2e-4 * r32, (32 * u * r32, 8 * u * r32), (
        16 * u * rbf, 4 * u * rbf)
    print(f"[28 encdec] {cut.name} cut to {cut.enc_layers} encoder + "
          f"{cut.L} decoder layers (d={cut.d_model}, {cut.n_heads}/"
          f"{cut.n_kv} heads of {cut.hd}, ff={cut.d_ff}, "
          f"V={cut.vocab_padded(1)}, {nparams(p) / 1e9:.4f}e9 params), B="
          f"{B2}, {F2} frames, {S2} tokens; CPU float32 forward and "
          f"{S2}-step decode {t_cpu:.1f} s. float32 card vs CPU: logits max "
          f"abs {f_max:.4g}, mean {f_mean:.4g} (logit rms {r32:.4g}; limit "
          f"2e-4·rms {lim32:.4g}); control, TF32 products: max {t_max:.4g}; "
          f"decode_encdec on encoder-filled cross caches, {S2} teacher-"
          f"forced steps, card vs CPU: max abs {d_max:.4g} (limit "
          f"{lim32:.4g}) (power limit {power})", flush=True)
    print(f"[28 encdec] bfloat16 card vs the CPU's float32: max abs "
          f"{b_max:.4g}, mean {b_mean:.4g} (limits 32u·rms {limbf[0]:.4g}, "
          f"8u·rms {limbf[1]:.4g}, u = 2^-8); control, the cross-attention's "
          f"wo zeroed: max {x_max:.4g}. decode = forward on the card "
          f"(bfloat16, encoder-filled cross caches, T = {F2}): max abs "
          f"{e_max:.4g}, mean {e_mean:.4g} (logit rms {rbf:.4g}; limits "
          f"16u·rms {limd[0]:.4g}, 4u·rms {limd[1]:.4g}); control, zero "
          f"cross caches (what serve decodes on): max {z_max:.4g}, mean "
          f"{z_mean:.4g} (power limit {power})", flush=True)
    if not (f_max <= lim32 and d_max <= lim32):
        raise AssertionError("encdec: the card's float32 logits disagree "
                             "with the CPU's")
    if on_card and not t_max > lim32:
        raise AssertionError("encdec: the float32 limit passes TF32 "
                             "products")
    if not (b_max <= limbf[0] and b_mean <= limbf[1]):
        raise AssertionError("encdec: the card's bfloat16 logits disagree "
                             "with the CPU's")
    if not x_max > limbf[0]:
        raise AssertionError("encdec: the bfloat16 limit passes a decoder "
                             "without cross-attention")
    if not (e_max <= limd[0] and e_mean <= limd[1]):
        raise AssertionError("encdec: decode disagrees with the forward")
    if not (z_max > limd[0] and z_mean > limd[1]):
        raise AssertionError("encdec: decode = forward passes zero cross "
                             "caches")
    del p, hp, b, hb, ref, ref_dec, lg32, lgtf, lgbf, lgnx, dec32, decbf, decz
    gc_collect(on_card)

    # ---- (a) llava-next-mistral-7b, 2 layers at full width ----
    cut = dataclasses.replace(lla, L=2)
    c32 = dataclasses.replace(cut, dtype="float32")
    P2 = 64
    p = lm.init_params(cut, prng.PRNGKey(0), model_shards=1, device=dev)
    b = {"tokens": tokens(cut, B2, S2),
         "frontend_embeds": normal(B2, P2, cut.d_model)}
    hp, hb = host(p), host(b)
    t0 = time.perf_counter()
    ref, rc = steps.make_prefill(c32)(hp, hb)
    t_cpu = time.perf_counter() - t0
    lg32, cc = steps.make_prefill(c32)(p, b)
    lgtf = tf32(lambda: steps.make_prefill(c32)(p, b)[0])
    lgbf, cbf = steps.make_prefill(cut)(p, b)
    lgnp, _ = steps.make_prefill(cut)(p, {"tokens": b["tokens"]})
    sync()
    r32 = rms(ref)
    f_max, f_mean = err(lg32, ref)
    t_max, _ = err(lgtf, ref)
    b_max, b_mean = err(lgbf, ref)
    n_max, _ = err(lgnp, ref)
    kv = max(err(cc[k], rc[k])[0] / float(rc[k].float().abs().max())
             for k in ("k", "v"))
    lim32, limbf = 2e-4 * r32, (32 * u * r32, 8 * u * r32)
    print(f"[28 vlm] {cut.name} cut to L={cut.L} (d={cut.d_model}, "
          f"{cut.n_heads}/{cut.n_kv} heads of {cut.hd}, ff={cut.d_ff}, "
          f"V={cut.vocab_padded(1)}, {nparams(p) / 1e9:.4f}e9 params), "
          f"prefill of B={B2} × ({P2} patches + {S2} tokens), CPU float32 "
          f"{t_cpu:.1f} s: pos {cc['pos']} (CPU {rc['pos']}), cache "
          f"{tuple(cc['k'].shape)} {cc['k'].dtype}; float32 card vs CPU: "
          f"last logits max abs {f_max:.4g}, mean {f_mean:.4g} (logit rms "
          f"{r32:.4g}; limit 2e-4·rms {lim32:.4g}); control, TF32 "
          f"products: max {t_max:.4g}; cache K/V max abs over the leaf's "
          f"max {kv:.4g} (limit 2u); bfloat16 card vs the CPU's float32: "
          f"max abs {b_max:.4g}, mean {b_mean:.4g} (limits 32u·rms "
          f"{limbf[0]:.4g}, 8u·rms {limbf[1]:.4g}); control, the prefix "
          f"dropped: max {n_max:.4g} (power limit {power})", flush=True)
    if not (cc["pos"] == rc["pos"] == P2 + S2
            and tuple(cc["k"].shape) == (cut.L, B2, P2 + S2, cut.n_kv,
                                         cut.hd)):
        raise AssertionError("vlm: the prefill cache's shape or pos")
    if not (f_max <= lim32 and kv <= 2 * u):
        raise AssertionError("vlm: the card's float32 prefill disagrees "
                             "with the CPU's")
    if on_card and not t_max > lim32:
        raise AssertionError("vlm: the float32 limit passes TF32 products")
    if not (b_max <= limbf[0] and b_mean <= limbf[1]):
        raise AssertionError("vlm: the card's bfloat16 logits disagree with "
                             "the CPU's")
    if not n_max > limbf[0]:
        raise AssertionError("vlm: the bfloat16 limit passes a prefill "
                             "without its prefix")
    del p, hp, b, hb, ref, rc, lg32, cc, lgtf, lgbf, cbf, lgnp
    gc_collect(on_card)
    t_a = time.perf_counter() - t_phase

    # ---- (c) both served at full width, cut to half their depth since
    # phase 30 took the script's time (llava to a quarter since phase
    # 31); (d) llava's prefix ----
    B, S, GEN = 4, 64, 32
    served = {}
    for full in (sea, lla):
        if on_card:
            full = dataclasses.replace(
                full, L=full.L // (2 if full.family == "encdec" else 4),
                enc_layers=full.enc_layers // 2)
        held = torch.cuda.memory_allocated() / 1e6 if on_card else 0.0
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = lm.init_params(full, prng.PRNGKey(0), model_shards=1,
                                device=dev)
        sync()
        t_init = time.perf_counter() - t0
        out, st = serve(full, batch=B, prompt_len=S, gen=GEN, seed=0,
                        log=lambda *_: None, device=dev, params=params)
        o = out.cpu().numpy()
        if o.shape != (B, GEN + 1) or not ((o >= 0) & (o < full.vocab)).all():
            raise AssertionError(f"{full.name}: served tokens {o.shape} out "
                                 f"of range")
        nparam = nparams(params)
        # the float32 weights a decode step reads: the decoder side (the
        # encoder does not run in serve), both embedding tables
        step = 4 * (nparam - (nparams(params["enc"]) + params[
            "enc_norm"].numel() if full.family == "encdec" else 0))
        bound_s = step / HBM_BYTES_PER_S
        how = ("64 sequential decode steps on zero cross caches"
               if full.family == "encdec" else "one forward")
        print(f"[28 serve] {full.name} at L={full.L}"
              + (f" + {full.enc_layers} encoder layers"
                 if full.family == "encdec" else "")
              + f" ({nparam / 1e9:.4f}e9 float32 params,"
              f" {4 * nparam / 1e9:.2f} GB) batch {B}, prompt {S} ({how}), "
              f"gen {GEN}: params drawn in {t_init:.2f} s, prefill "
              f"{st['prefill_s']:.3f} s, decode {st['decode_s']:.3f} s, "
              f"{st['tok_per_s']:.1f} tokens/s (bound {B / bound_s:.0f} "
              f"tokens/s: {step / 1e9:.2f} GB of float32 weights a step, "
              f"{1e3 * bound_s:.2f} ms) "
              + (f"resident {st['resident_mb']:.0f} MB, peak "
                 f"{st['peak_mb']:.0f} MB (phases before it held {held:.0f}"
                 f" MB) " if on_card else "")
              + f"(power limit {power})", flush=True)
        served[full.name] = st["tok_per_s"]
        if on_card:
            profile_decode(full, params, B, S, dev, tag="28 profile")
        if full.family == "vlm":
            vlm_prefix(full, params, B, S, GEN, n_patch, rng, dev, on_card,
                       power)
        del params, out
        gc_collect(on_card)

    launched = {k: v - counts0[k] for k, v in launch_counts().items()}
    print(f"[28 kernels] launches in phase 28: {launched} (plain torch, as "
          f"the JAX package's encdec and vlm paths are plain XLA)",
          flush=True)
    if any(launched.values()):
        raise AssertionError("phase 28 launched a kernel it should not")
    t_all = time.perf_counter() - t_phase
    print(f"[28 done] phase 28 in {t_all:.1f} s: (a, b) {t_a:.1f}, (c, d) "
          f"{t_all - t_a:.1f} s (power limit {power})", flush=True)


def vlm_prefix(cfg, params, B, S, GEN, n_patch, rng, dev, on_card, power):
    """Phase 28 (d): ``cfg`` (vlm) behind a stub image prefix of
    ``n_patch`` patch embeddings: `make_prefill` over prefix + ``S``
    tokens, ``GEN`` greedy decode steps on a cache of T = n_patch + S +
    GEN, then the last step against a forward over the whole sequence.
    At full depth and length two bfloat16 computations of one function
    differ by their rounding (the card's GEMMs round a 4-row decode and
    a 11,904-row forward differently), and 32 layers carry it.  So both
    checks are held against the float32 forward on row 0, in units of
    the bfloat16 forward's own distance from it: the served bfloat16
    decode within twice that; the cache logic in float32 — a prefill of
    the first T − 1 positions, its K/V rounded to bfloat16 as the
    reference stores them, and one decode step — within half of it (the
    stored K/V's rounding alone), the prefix's cache slots zeroed the
    control."""
    import dataclasses

    from repro_torch.models import lm, steps

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    u = 2.0 ** -8
    c32 = dataclasses.replace(cfg, dtype="float32")
    fe = torch.from_numpy(rng.normal(0, 0.02, (B, n_patch, cfg.d_model))
                          .astype(np.float32)).to(dev)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(
        np.int32)).to(dev)
    T = n_patch + S + GEN
    sync()
    t0 = time.perf_counter()
    logits, pc = steps.make_prefill(cfg)(params, {"tokens": toks,
                                                  "frontend_embeds": fe})
    sync()
    t_pre = time.perf_counter() - t0
    cache = steps.init_cache(cfg, B, T, device=dev)
    for n in ("k", "v"):
        cache[n][:, :, :pc["pos"]] = pc[n]
    cache["pos"] = pc["pos"]
    del pc
    dec = steps.make_decode_step(cfg)
    fed = [torch.argmax(logits, -1).to(torch.int32)[:, None]]
    sync()
    t0 = time.perf_counter()
    for _ in range(GEN):
        lg, cache = dec(params, cache, fed[-1])
        fed.append(torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None])
    sync()
    t_dec = time.perf_counter() - t0
    kv_gb = 2 * cache["k"].numel() * cache["k"].element_size() / 1e9
    del cache
    lg = lg[:, 0]
    seq = torch.cat([toks, *fed[:-1]], dim=1)            # [B, S + GEN]
    last = lambda c, b: steps.logits_of(c, params, lm.forward(
        c, params, b)[:, -1])
    row = {"tokens": seq[:1], "frontend_embeds": fe[:1]}
    with torch.no_grad():
        fwd = last(cfg, {"tokens": seq, "frontend_embeds": fe})
        ctl = last(cfg, {"tokens": seq})
        w32 = last(c32, row)[0]
    # float32 on row 0: prefill of the first T − 1 positions, one step
    _, pc = steps.make_prefill(c32)(params, {"tokens": seq[:1, :-1],
                                             "frontend_embeds": fe[:1]})
    d32 = []
    for drop in (False, True):
        c1 = steps.init_cache(c32, 1, T, dtype=torch.float32, device=dev)
        for n in ("k", "v"):
            c1[n][:, :, :T - 1] = pc[n]
            if drop:                             # the prefix's slots zeroed
                c1[n][:, :, :n_patch] = 0
        c1["pos"] = pc["pos"]
        d32.append(steps.make_decode_step(c32)(params, c1,
                                               seq[:1, -1:])[0][0, 0])
    del pc, c1
    sync()
    r = float(w32.pow(2).mean().sqrt())
    e = lambda a, b: (float((a - b).abs().max()), float((a - b).abs().mean()))
    f_max, f_mean = e(d32[0], w32)
    z_max, _ = e(d32[1], w32)
    b_max, b_mean = e(fwd[0], w32)               # bfloat16's own distance
    g_max, g_mean = e(lg[0], w32)
    dd_max, dd_mean = e(lg, fwd)
    c_max, _ = e(ctl[0], w32)
    limbf = (2 * b_max, 2 * b_mean)
    lim32 = (b_max / 2, b_mean / 2)
    step_bytes = 4 * sum(t.numel() for v in params.values() for t in (
        v.values() if isinstance(v, dict) else (v,))) + kv_gb * 1e9
    print(f"[28 prefix] {cfg.name} behind {n_patch} stub patches, batch {B}"
          f": prefill of {n_patch + S} positions {t_pre:.3f} s; {GEN} decode"
          f" steps on a T = {T} cache ({kv_gb:.2f} GB of bfloat16 K/V) "
          f"{t_dec:.3f} s, {B * GEN / t_dec:.1f} tokens/s (bound "
          f"{B * HBM_BYTES_PER_S / step_bytes:.0f}: weights and cache read "
          f"once a step) (power limit {power})", flush=True)
    print(f"[28 prefix] position {T - 1}, row 0, against the float32 "
          f"forward over the {T} positions (logit rms {r:.4g}): float32 "
          f"prefill of {T - 1} + one decode step max abs {f_max:.4g}, mean "
          f"{f_mean:.4g} (limits half the bfloat16 forward's, "
          f"{lim32[0]:.4g} and {lim32[1]:.4g}; u·rms = {u * r:.4g}); "
          f"control, the prefix's cache slots zeroed: max {z_max:.4g}. "
          f"bfloat16: the forward max {b_max:.4g}, mean {b_mean:.4g}; the "
          f"served decode's last step max {g_max:.4g}, "
          f"mean {g_mean:.4g} (limits twice the forward's, {limbf[0]:.4g} "
          f"and {limbf[1]:.4g}); control, the forward without the prefix: "
          f"max {c_max:.4g}; the served decode against the bfloat16 forward"
          f", all {B} rows: max {dd_max:.4g}, mean {dd_mean:.4g} (power "
          f"limit {power})", flush=True)
    if not (f_max <= lim32[0] and f_mean <= lim32[1]):
        raise AssertionError("vlm: float32 decode behind the prefix "
                             "disagrees with the forward")
    if not z_max > lim32[0]:
        raise AssertionError("vlm: the float32 check passes a cache "
                             "without the prefix")
    if not (g_max <= limbf[0] and g_mean <= limbf[1]):
        raise AssertionError("vlm: the bfloat16 decode behind the prefix "
                             "is further from float32 than its forward")
    if not c_max > limbf[0]:
        raise AssertionError("vlm: the bfloat16 limit passes a forward "
                             "without the prefix")

def frontend_step_flops(cfg, B: int, S: int, P: int) -> tuple[float, float]:
    """(bf16, float32) multiply-add FLOPs of one encdec or vlm train step
    from the shapes, as `lm_step_flops` counts a dense one: the layers'
    projections and the one-hot embedding product in bfloat16, the
    attention scores and the logits (over the S text positions) in
    float32; forward once, the layers again under remat, backward twice
    each product (the one-hot product once).  vlm's layers run over
    P + S positions; encdec's encoder over its P frames, and each
    decoder layer adds the cross-attention's q / o projections over S
    tokens, its K / V projections over the P frames and its S × P
    scores."""
    D, Hq, Hk, hd, ff = (cfg.d_model, cfg.n_heads_padded, cfg.n_kv, cfg.hd,
                         cfg.d_ff)
    V = cfg.vocab_padded(1)
    dense = lambda n: 2 * n * D * (2 * Hq * hd + 2 * Hk * hd + 3 * ff)
    scores = lambda q, k: 2 * 2 * B * Hq * q * k * hd
    emb = logits = 2 * B * S * V * D
    if cfg.family == "encdec":
        nE, nD = B * P, B * S
        cross = 2 * nD * D * 2 * Hq * hd + 2 * nE * D * 2 * Hk * hd
        bf16 = (cfg.enc_layers * dense(nE) + cfg.L * (dense(nD) + cross))
        f32 = (cfg.enc_layers * scores(P, P)
               + cfg.L * (scores(S, S) + scores(S, P)))
    else:
        bf16, f32 = cfg.L * dense(B * (P + S)), cfg.L * scores(P + S, P + S)
    return float(4 * bf16 + 2 * emb), float(4 * f32 + 3 * logits)


def frontend_train_phase(args, dev, on_card: bool, power: str) -> None:
    """Phase 29: the encdec and vlm families' training half (`steps.
    lm_loss` behind vlm's patch prefix, autograd through `_encode` and
    `_forward_encdec` — the encoder's output read by every decoder
    layer's cross K/V under remat —, the µ = 2 split of ``frontend_
    embeds``, `launch/train.py::synth_batch`'s frontend draws and
    `train_loop`, the nested ``enc`` / ``dec`` / ``dec_cross`` trees
    through `train/checkpoint.py`): (a) the card against the CPU at
    float32 on 2-layer cuts at full width — seamless-m4t-large-v2 (2 + 2
    layers) by `value_and_grad`, llava-next-mistral-7b (2 layers) by a
    µ = 2 train step's accumulated gradient —, each with a TF32 control,
    seamless's with an Adam update; (d) remat on = off bit for bit on
    the seamless cut; (b) seamless at full width and depth through `train_loop`, and
    a checkpoint resumed on reduced seamless; (c) llava at full width
    cut to L = 14 of 32 with its own µ = 2, peak memory, a profiled
    step.  Launches none of the seven kernels (no `pallas_call` on this
    path)."""
    import dataclasses
    import shutil

    from repro_torch import prng
    from repro_torch import tree as T
    from repro_torch.configs import base as CB
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import train as ltrain
    from repro_torch.models import lm, steps
    from repro_torch.train import checkpoint as ckpt

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    gc_collect(on_card)                  # phase 28's weights are gone
    t_phase = time.perf_counter()
    counts0 = launch_counts()
    base_sea, base_lla = CB.get("seamless-m4t-large-v2"), CB.get(
        "llava-next-mistral-7b")
    sea, lla = base_sea, base_lla
    if not on_card:                              # rehearsal size
        sea = CB.reduced(sea)
        lla = dataclasses.replace(CB.reduced(lla),
                                  microbatches=lla.microbatches)
    host = lambda tree: T.tree_map(lambda t: t.to("cpu", copy=True), tree)
    to_dev = lambda tree: T.tree_map(lambda t: t.to(dev), tree)
    nparams = lambda tree: sum(t.numel() for t in T.leaves(tree))
    mb = lambda: torch.cuda.memory_allocated() / 1e6 if on_card else 0.0
    rng = np.random.default_rng(args.seed + 29)
    # the tree without its embedding tables (the Adam check's: the
    # tables are 81 % of seamless's cut, and the card machine's CPU runs
    # Adam at ~5·10⁷ parameters a second)
    stacks = lambda tree: {k: v for k, v in tree.items()
                           if k not in ("embed", "out_embed")}

    def batch(cfg, B, S, P):
        out = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(
            np.int32)) for k in ("tokens", "labels")}
        out["frontend_embeds"] = torch.from_numpy(rng.normal(
            0, 0.02, (B, P, cfg.d_model)).astype(np.float32))
        return out

    def accumulated(cfg, params, b):
        """A `make_train_step` step's loss and the gradient it hands to
        Adam (µ microbatches summed in place, over Σ mb_mask); Adam is
        not run."""
        seen = {}

        def capture(cfg_, params_, grads, opt, **kw):
            seen["g"] = grads
            return params_, opt, None

        adam = steps.adam_update
        steps.adam_update = capture
        try:
            _, _, aux = steps.make_train_step(cfg)(params, None, b)
        finally:
            steps.adam_update = adam
        return aux["loss"], seen["g"]

    # ---- (a) the card against the CPU, float32, 2-layer cuts ----
    # each gradient leaf within 1e-4 of its own max |g| (phase 24's
    # limit; a TF32 control must read above it)
    GRAD_REL = 1e-4
    B2, S2, P2 = 2, 16, 16
    for full in (sea, lla):
        t0 = time.perf_counter()
        cut = dataclasses.replace(full, L=2, dtype="float32")
        if cut.family == "encdec":
            cut = dataclasses.replace(cut, enc_layers=2)
        # vlm at its own µ = 2: frontend_embeds [2·B2, P, D] is split
        # with the tokens and the labels
        mu = max(1, cut.microbatches)
        p = lm.init_params(cut, prng.PRNGKey(0), model_shards=1, device=dev)
        hp = host(p)
        b = batch(cut, mu * B2, S2, P2)
        bd = to_dev(b)
        if mu == 1:
            grads = lambda q, x: steps.value_and_grad(cut, q, x)
        else:
            grads = lambda q, x: accumulated(cut, q, x)
        t1 = time.perf_counter()
        l0, g0 = grads(hp, b)
        t_cpu = time.perf_counter() - t1
        g0 = to_dev(g0)                  # compared on the card
        lc, g_dev = grads(p, bd)
        rel = abs(float(lc) - float(l0)) / abs(float(l0))
        worst, path = worst_leaf(g_dev, g0)
        tf_worst, tf_path = float("nan"), "-"
        if on_card:
            tf_worst, tf_path = worst_leaf(tf32(lambda: grads(p, bd))[1], g0)
        del g0
        remat = ""
        if cut.family == "encdec":
            # (d) remat on = off: the encoder output, captured by each
            # rematerialised decoder layer, gets the same gradient sum
            l_off, g_off = steps.value_and_grad(
                dataclasses.replace(cut, remat=False), p, bd)
            same = bool(torch.equal(l_off, lc)) and all(
                torch.equal(a, w) for a, w in zip(T.leaves(g_off),
                                                  T.leaves(g_dev)))
            del g_off
            remat = (f"; (d) remat on = off on the card, the loss and all "
                     f"{len(T.leaves(g_dev))} gradient leaves bit for bit: "
                     f"{same}")
            if not same:
                raise AssertionError("encdec: remat changes a gradient on "
                                     "the card")
        gc_collect(on_card)
        adam = ""
        if cut.family == "encdec":
            # Adam on the nested enc / dec / dec_cross tree (llava's is
            # phase 24's dense tree; its 4.4·10⁸ parameters outside the
            # tables would take the CPU ~10 s)
            sp, shp, sg = stacks(p), stacks(hp), stacks(g_dev)
            upd_cpu = steps.adam_update(cut, shp, host(sg),
                                        steps.init_opt(cut, shp))
            upd_dev = steps.adam_update(cut, sp, sg, steps.init_opt(cut, sp))
            adam_err = max(float((a.cpu() - w).abs().max()) for a, w in zip(
                T.leaves(upd_dev[:2]), T.leaves(upd_cpu[:2])))
            adam = (f"; Adam update of the card's gradients on the "
                    f"{nparams(sp) / 1e9:.4f}e9 parameters outside the "
                    f"embedding tables card vs CPU max abs {adam_err:.3g} "
                    f"(limit 1e-6)")
            del sp, shp, sg, upd_cpu, upd_dev
            if not adam_err <= 1e-6:
                raise AssertionError("encdec: the card's Adam update "
                                     "disagrees with the CPU's")
        frames = "frames" if cut.family == "encdec" else "patches"
        how = ("value_and_grad" if mu == 1 else
               f"a µ={mu} train step's accumulated gradient")
        print(f"[29 cpu] {cut.name} cut to L={cut.L}"
              + (f" + {cut.enc_layers} encoder layers"
                 if cut.family == "encdec" else "")
              + f" at full width (d={cut.d_model}, ff={cut.d_ff}, "
              f"V={cut.vocab_padded(1)}; {nparams(p) / 1e9:.4f}e9 params), "
              f"float32 B={mu * B2} S={S2} with {P2} {frames}, {how} (CPU "
              f"{t_cpu:.1f} s): loss card {float(lc):.6f} vs CPU "
              f"{float(l0):.6f} (rel {rel:.3g}, limit 1e-5); worst gradient "
              f"leaf {worst:.3g} of its max |g| ({path}; limit {GRAD_REL}); "
              f"control, TF32 products on the card: worst leaf "
              f"{tf_worst:.3g} ({tf_path}){adam}{remat}; "
              f"{time.perf_counter() - t0:.1f} s (power limit {power})",
              flush=True)
        if not (rel <= 1e-5 and worst <= GRAD_REL):
            raise AssertionError(f"{cut.family}: the card's loss or "
                                 f"gradients disagree with the CPU's")
        if on_card and not tf_worst > GRAD_REL:
            raise AssertionError(f"{cut.family}: the gradient bound passes "
                                 f"TF32 products")
        del p, hp, b, bd, g_dev
        gc_collect(on_card)
    t_a = time.perf_counter() - t_phase

    # ---- (b) seamless-m4t-large-v2 at full width and depth ----
    B, S, N_STEPS, N_TIMED = 8, 128, 10, 3

    def timed_steps(cfg, params, opt):
        """N_TIMED synchronised `make_train_step` steps over batches drawn
        beforehand → (params, opt, median s, the first batch)."""
        step_fn = steps.make_train_step(cfg)
        trng = np.random.default_rng(args.seed + 1)
        bs = [ltrain.synth_batch(trng, cfg, B, S, device=dev)
              for _ in range(N_TIMED)]
        marks = []
        for tb in bs:
            t = time.perf_counter()
            params, opt, _ = step_fn(params, opt, tb)
            sync()
            marks.append(time.perf_counter() - t)
        return params, opt, float(np.median(marks)), bs[0]

    def bound_line(cfg, nparam, P, step_s):
        """The step's bound: Adam reads p, g, m, v and writes p, m, v
        (28 B a float32 parameter), each microbatch's forward reads the
        float32 weights once; the operations of `frontend_step_flops`."""
        bf, f32 = frontend_step_flops(cfg, B, S, P)
        nbytes = nparam * (28 + 4 * max(1, cfg.microbatches))
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = bf / BF16_OPS_PER_S + f32 / F32_OPS_PER_S
        # the positions a sequence: encdec's S frames and S tokens are the
        # reference's train cell of S; vlm's prefix comes before the text
        timed_cell("29", cfg, B, S if cfg.family == "encdec" else P + S,
                   max(t_bytes, t_ops), step_s)
        print(f"[29 bound] {cfg.name}: bytes, Adam and the weights' reads "
              f"{nbytes / 1e9:.2f} GB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s "
              f"{1e3 * t_bytes:.2f} ms; operations: {bf / 1e12:.3f} TFLOP "
              f"in bf16 products at {BF16_OPS_PER_S / 1e12:.0f} TFLOP/s + "
              f"{f32 / 1e12:.3f} TFLOP in float32 products at "
              f"{F32_OPS_PER_S / 1e12:.0f} TFLOP/s {1e3 * t_ops:.2f} ms; "
              f"bound {1e3 * max(t_bytes, t_ops):.2f} ms (by "
              f"{'bytes' if t_bytes >= t_ops else 'operations'}); the step "
              f"took {1e3 * step_s:.2f} ms", flush=True)

    held = mb()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt, losses = ltrain.train_loop(sea, steps_n=N_STEPS, batch=B,
                                            seq=S, lr=3e-4,
                                            log=lambda *_: None, device=dev,
                                            seed=args.seed)
    wall = time.perf_counter() - t0
    loop_peak = torch.cuda.max_memory_allocated() / 1e6 if on_card else 0.0
    nparam = nparams(params)
    params, opt, step_s, _ = timed_steps(sea, params, opt)
    print(f"[29 encdec] {sea.name} at full width and depth ({sea.enc_layers}"
          f" + {sea.L} layers, {nparam / 1e9:.4f}e9 float32 params, "
          f"{16 * nparam / 1e9:.2f} GB with the gradients and two moments) "
          f"batch {B} x {S} tokens behind {S} frames, lr 3e-4: {N_STEPS} "
          f"train_loop steps in {wall:.1f} s (the draw included), loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; {N_TIMED} synchronised "
          f"make_train_step steps, median {step_s:.4f} s, "
          f"{B * S / step_s:.0f} tokens/s; "
          + (f"the loop's peak {loop_peak:.0f} MB (phases before it held "
             f"{held:.0f} MB) " if on_card else "")
          + f"(power limit {power})", flush=True)
    bound_line(sea, nparam, S, step_s)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"encdec: the full-depth loss did not fall: "
                             f"{losses}")
    del params, opt
    gc_collect(on_card)
    # the nested (params, opt) tree through a checkpoint on the card, on
    # reduced seamless: at full width one save is 24.4 GB (16.3 of it
    # the moments), and the loop saves again when it ends (PERF.md §4)
    t0 = time.perf_counter()
    red = CB.reduced(base_sea)
    d = os.path.join(ROOT, "build", "chip_smoke_encdec_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    kw = dict(batch=B, seq=S, device=dev, seed=args.seed)
    p5, o5, first = ltrain.train_loop(red, steps_n=5, ckpt_dir=d,
                                      log=lambda *_: None, **kw)
    got, step = ckpt.restore(d, (p5, o5))
    bits = lambda t: t.reshape(-1).view(torch.uint8)
    same = step == 5 and all(
        a.dtype == w.dtype and a.device == w.device
        and torch.equal(bits(a), bits(w))
        for a, w in zip(T.leaves(got), T.leaves((p5, o5))))
    del got
    logs = []
    _, _, resumed = ltrain.train_loop(red, steps_n=10, ckpt_dir=d,
                                      log=logs.append, **kw)
    step_fn = steps.make_train_step(red)
    brng, in_mem = np.random.default_rng(args.seed), []
    for _ in range(5):
        p5, o5, aux = step_fn(p5, o5, ltrain.synth_batch(brng, red, B, S,
                                                         device=dev))
        in_mem.append(float(aux["loss"]))
    shutil.rmtree(d, ignore_errors=True)
    print(f"[29 ckpt] reduced {red.name} ({red.enc_layers} + {red.L} layers,"
          f" d={red.d_model}): the step-5 checkpoint of the nested "
          f"enc / dec / dec_cross tree and its moments restored every leaf "
          f"bit for bit: {same}; resumed {logs[:1]}: losses {resumed} vs "
          f"the state in memory {in_mem}: equal {resumed == in_mem} (first "
          f"five {first[0]:.4f} -> {first[-1]:.4f}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if not (same and resumed == in_mem
            and logs[:1] == ["resumed from step 5"]):
        raise AssertionError("encdec: the checkpoint did not resume bit for "
                             "bit")
    del p5, o5
    gc_collect(on_card)
    t_b = time.perf_counter() - t_phase - t_a

    # ---- (c) llava-next-mistral-7b at full width, L = 14 of 32, µ = 2 ----
    # its 32 layers' Adam state is 116 GB, 14 of them 53.06 GB; at L = 16
    # (60.03 GB) the backward's per-layer gradients, held until each
    # stack's gradient is assembled, took the peak to 75,108 MB (PERF.md
    # §4); lr 1e-4, as phase 25 trains zamba2-7b (3e-4 diverged)
    full = dataclasses.replace(lla, L=14 if on_card else lla.L)
    held = mb()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt, losses = ltrain.train_loop(full, steps_n=N_STEPS, batch=B,
                                            seq=S, lr=1e-4,
                                            log=lambda *_: None, device=dev,
                                            seed=args.seed)
    wall = time.perf_counter() - t0
    nparam, resident = nparams(params), mb()
    params, opt, step_s, first_b = timed_steps(full, params, opt)
    peak = torch.cuda.max_memory_allocated() / 1e6 if on_card else 0.0
    print(f"[29 vlm] {full.name} at L={full.L} of {base_lla.L}, full widths "
          f"({nparam / 1e9:.4f}e9 float32 params, {16 * nparam / 1e9:.2f} GB "
          f"with the gradients and two moments; µ={full.microbatches}) "
          f"batch {B} x ({ltrain.FRONTEND_PATCHES} stub patches + {S} "
          f"tokens), lr 1e-4: {N_STEPS} train_loop steps in {wall:.1f} s "
          f"(the draw included), loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"{N_TIMED} synchronised make_train_step steps, median "
          f"{step_s:.4f} s, {B * S / step_s:.0f} tokens/s; "
          + (f"resident {resident:.0f} MB; the card's peak {peak:.0f} MB, of "
             f"which phases before it held {held:.0f} MB: the training's own"
             f" peak {peak - held:.0f} MB (limit 70000 MB) " if on_card
             else "")
          + f"(power limit {power})", flush=True)
    bound_line(full, nparam, ltrain.FRONTEND_PATCHES, step_s)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"vlm: the loss did not fall: {losses}")
    if on_card and not peak - held <= 70000:
        raise AssertionError(f"vlm: the training's own peak {peak - held:.0f}"
                             f" MB passed 70000 MB")
    if on_card:
        profile_train_step(full, params, opt, first_b, tag="29 profile",
                           n_top=6)
    del params, opt, first_b
    gc_collect(on_card)

    launched = {k: v - counts0[k] for k, v in launch_counts().items()}
    print(f"[29 kernels] launches in phase 29: {launched} (plain torch, as "
          f"the JAX package's encdec and vlm training is plain XLA)",
          flush=True)
    if any(launched.values()):
        raise AssertionError("phase 29 launched a kernel it should not")
    t_all = time.perf_counter() - t_phase
    print(f"[29 done] phase 29 in {t_all:.1f} s: (a, d) {t_a:.1f}, (b) "
          f"{t_b:.1f}, (c) {t_all - t_a - t_b:.1f} s (power limit {power})",
          flush=True)


# phase 30: the bfloat16-parameter configurations, each at its full
# widths cut in depth: L = 8 and L = 2, the depths one 80 GB card holds
# beside serving (59.41 GB and 55.36 GB of bfloat16 weights), until phase
# 31 took the script's time (each layer's draw is ~1.9 and ~6.9 s)
BF16_SERVED = (("llama3-405b", 4), ("arctic-480b", 1))


def bf16_draw_refs(cfg) -> tuple[list, float]:
    """Phase 30 (a), the CPU's half: one full-width leaf of layer 0 drawn
    on the CPU as `init_params` draws it — llama3-405b's ``wk``; arctic's
    ``w1`` of expert 0 (the leaf's first d·d_ff draws) and the leaf's
    last 2²⁰ (past index 2³², where the cipher's counter has a high
    word) → ([(what, leaf, flat start, values)], CPU seconds)."""
    from repro_torch import prng
    from repro_torch.models import lm

    t0 = time.perf_counter()
    key = prng.split(prng.split(prng.PRNGKey(0), 6)[2], cfg.L)[0]
    specs = lm._dense_layer_init(cfg, key)
    bf = torch.bfloat16
    if cfg.family == "moe":
        spec = specs["w1"]
        E, D, ff = spec.shape
        n, m = E * D * ff, min(1 << 20, E * D * ff)
        k1, k2 = spec.key.tolist()
        tail = prng._bf16_table("cpu", normal=True)[prng._low7_i32(
            k1, k2, n - m, m, "cpu")].mul_(torch.tensor(0.02, dtype=bf))
        refs = [("w1 expert 0", "w1", 0, lm._draw(
                    spec._replace(shape=(D * ff,)), 0.02, bf, "cpu")),
                (f"w1 draws {n - m}..{n - 1}", "w1", n - m, tail)]
    else:
        refs = [("wk", "wk", 0, lm._draw(specs["wk"], 0.02, bf, "cpu"))]
    return refs, time.perf_counter() - t0


def bf16_draw_check(cfg, params, refs, t_cpu: float, card: str) -> None:
    """Phase 30 (a): the card's leaves of `bf16_draw_refs`, bit for bit."""
    bits = lambda t: t.detach().cpu().reshape(-1).view(torch.int16)
    for what, name, start, want in refs:
        got = params["layers"][name][0].reshape(-1)[start:start
                                                    + want.numel()]
        diff = int((bits(got) != bits(want)).sum())
        print(f"[30 draw] {cfg.name} layer 0 {what} ({got.numel()} bfloat16 "
              f"values): card vs CPU draw, {diff} differing bit patterns "
              f"(must be 0; the CPU drew them in {t_cpu:.1f} s beside the "
              f"card's draw) ({card})", flush=True)
        if diff:
            raise AssertionError(f"{cfg.name} {what}: the card's bfloat16 "
                                 f"draw differs from the CPU's")


def bf16_cut_card(cfg, params, dev, on_card: bool):
    """Phase 30 (d), the card's half: layer 0 of the served tree (views)
    as a 1-layer model at full width, B 2 × S 8 → a job for the CPU's
    half (`bf16_cut_cpu`'s arguments): the card's bfloat16 logits at
    every position (and moe routes), a control's (layer 0's ``wo``
    zeroed), and the cut's weights copied to the host — for moe only the
    experts the card's or the CPU's routes use, read from a router pass
    on the host first (the stacks' other experts are never read)."""
    import dataclasses

    from repro_torch import tree as T
    from repro_torch.models import layers as L
    from repro_torch.models import lm, steps
    from repro_torch.models import moe as MOE

    moe = cfg.family == "moe"
    cut = dataclasses.replace(cfg, L=1)
    c32 = dataclasses.replace(cut, dtype="float32")
    p1 = {k: v for k, v in params.items() if k != "layers"}
    p1["layers"] = {k: v[:1] for k, v in params["layers"].items()}
    ctrl = dict(p1, layers=dict(p1["layers"], wo=torch.zeros_like(
        p1["layers"]["wo"])))
    toks = torch.from_numpy(np.random.default_rng(30).integers(
        0, cfg.vocab, (2, 8)).astype(np.int32)).to(dev)
    with torch.no_grad():
        if moe:
            lg, e, _ = moe_routes(cut, p1, toks)
            lgc = moe_routes(cut, ctrl, toks)[0]
        else:
            lg, e = steps.logits_of(cut, p1, lm.forward(
                cut, p1, {"tokens": toks})), None
            lgc = steps.logits_of(cut, ctrl, lm.forward(
                cut, ctrl, {"tokens": toks}))
        lg, lgc = lg.cpu(), lgc.cpu()
        del ctrl
        t0 = time.perf_counter()
        experts = ("w1", "w3", "w2") if moe else ()
        hp = {k: v.cpu() for k, v in p1.items() if k != "layers"}
        hp["layers"] = {k: v.cpu() for k, v in p1["layers"].items()
                        if k not in experts}
        n_bytes = sum(t.numel() * t.element_size() for t in T.leaves(hp))
        used = []
        if moe:
            pl = lm.layer(hp["layers"], 0)
            x, _ = lm._attn_sublayer(pl, lm.embed_tokens(hp, c32,
                                                         toks.cpu()),
                                     c32, causal=True)
            e_cpu = MOE.router(pl, L.rms_norm(x, pl["ln2"], cfg.norm_eps),
                               c32)[0]
            used = torch.unique(torch.cat([e.cpu().reshape(-1),
                                           e_cpu.reshape(-1)])).tolist()
            for n in experts:
                v = p1["layers"][n]
                hp["layers"][n] = h = torch.empty(v.shape, dtype=v.dtype)
                for i in used:
                    h[0, i].copy_(v[0, i])
                n_bytes += len(used) * v[0, 0].numel() * v.element_size()
        t_copy = time.perf_counter() - t0
    return cfg, hp, toks.cpu(), lg, None if e is None else e.cpu(), lgc, (
        t_copy, n_bytes, len(used))


def bf16_cut_cpu(cfg, hp, toks, lg, e, lgc, copied, card: str) -> None:
    """Phase 30 (d), the CPU's half: the same cut's float32 forward on the
    host — moe on its own routes, then on the card's — against the
    card's bfloat16 logits: moe routes first (the share that agree, a
    floor), then the values within phase 23's 32u·rms / 8u·rms (dense)
    or phase 26's 64u·rms / 8u·rms (moe, on the card's routes); the
    control must read above the max limit."""
    import dataclasses

    from repro_torch.models import lm, steps

    u = 2.0 ** -8
    moe = cfg.family == "moe"
    c32 = dataclasses.replace(cfg, L=1, dtype="float32")
    t0 = time.perf_counter()
    with torch.no_grad():
        if moe:
            ref, e0, _ = moe_routes(c32, hp, toks)
            # on the card's routes: the same run where they are the CPU's
            forced = ref if torch.equal(e, e0) else moe_routes(
                c32, hp, toks, force=e)[0]
        else:
            ref = forced = steps.logits_of(c32, hp, lm.forward(
                c32, hp, {"tokens": toks}))
    t_cpu = time.perf_counter() - t0
    err = lambda a, b: ((a.float() - b.float()).abs().max().item(),
                        (a.float() - b.float()).abs().mean().item())
    rms = float(ref.pow(2).mean().sqrt())
    lim = ((64 if moe else 32) * u * rms, 8 * u * rms)
    c_max, c_mean = err(lg, forced)
    k_max, _ = err(lgc, ref)
    routes, agree, floor = "", 1.0, 0.85
    if moe:
        flip = (e.sort(-1).values != e0.sort(-1).values).any(-1)
        agree = float(1 - flip.float().mean())
        routes = (f"routes agree on {agree:.4f} of the {flip.numel()} (token,"
                  f" layer) pairs (floor {floor}); values on the card's "
                  f"routes: ")
    t_copy, n_bytes, n_used = copied
    print(f"[30 cpu] {cfg.name} cut to L=1 at full width (layer 0 of the "
          f"served tree; {n_bytes / 1e9:.2f} GB of bfloat16 weights copied "
          f"to the host in {t_copy:.1f} s"
          + (f", the {n_used} experts either side routes to" if moe else "")
          + f"; the CPU's float32 forward{'s' if moe else ''} {t_cpu:.1f} s,"
          f" in a worker thread), B 2 x S 8, the card's bfloat16 "
          f"logits vs the CPU's float32: {routes}max abs {c_max:.4g}, mean "
          f"{c_mean:.4g} (logit rms {rms:.4g}; limits {lim[0] / u / rms:.0f}"
          f"u·rms {lim[0]:.4g} and 8u·rms {lim[1]:.4g}, u = 2^-8); control,"
          f" layer 0's wo zeroed on the card: max abs {k_max:.4g} ({card})",
          flush=True)
    if not agree >= floor:
        raise AssertionError(f"{cfg.name}: too many bfloat16 routes flipped")
    if not (c_max <= lim[0] and c_mean <= lim[1]):
        raise AssertionError(f"{cfg.name}: the card's bfloat16 logits "
                             f"disagree with the CPU's")
    if not k_max > lim[0]:
        raise AssertionError(f"{cfg.name}: the logit limit passes a layer "
                             f"without its attention output")


def bf16_phase(args, dev, on_card: bool, power: str):
    """Phase 30: bfloat16 parameters — the card's 128-value normal table
    against the CPU's; llama3-405b at full width cut to L = 4 and
    arctic-480b at full width cut to L = 1 (`BF16_SERVED`), each drawn on
    the card in
    bfloat16 (`lm.init_params`), a full-width leaf checked bit for bit
    against the CPU's draw, served through `repro_torch.launch.serve.
    serve` (batch 4, prompt 64, 32 tokens) beside the bound of reading
    its bfloat16 weights once a step (arctic: the routed experts'),
    resident and own peak MB (≤ 70,000), a profiled decode step; and a
    1-layer cut of each card vs CPU.  The CPU's reference work runs in a
    worker thread beside the card's draws, never beside serving or the
    profiler.  Writes nothing to disk and launches none of the seven
    kernels.  → (arctic-480b's served config, its tree), which phase 33
    serves on a mesh."""
    import dataclasses
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch import prng
    from repro_torch import tree as T
    from repro_torch.configs import base as CB
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t_phase = time.perf_counter()
    counts0 = launch_counts()
    card = (f"{torch.cuda.get_device_name(0)}, power limit {power}"
            if on_card else power)
    B, S, GEN = 4, 64, 32
    # (a) the table every bfloat16 normal draw picks from
    tab = prng._bf16_table(dev, normal=True).cpu().view(torch.int16)
    tab0 = prng._bf16_table("cpu", normal=True).view(torch.int16)
    print(f"[30 table] the 128 bfloat16 normal values built on the card "
          f"equal the CPU's bit for bit: {torch.equal(tab, tab0)} ({card})",
          flush=True)
    if not torch.equal(tab, tab0):
        raise AssertionError("the card's bfloat16 normal table differs")
    configs = []
    for name, depth in BF16_SERVED:
        full = CB.get(name)
        if not on_card:                          # rehearsal size
            full = dataclasses.replace(CB.reduced(full),
                                       param_dtype="bfloat16")
        configs.append((full, dataclasses.replace(full, L=min(depth,
                                                              full.L))))
    parts, pending, kept = [], None, None
    with ThreadPoolExecutor(max_workers=1) as pool:
        refs = [pool.submit(bf16_draw_refs, served) for _, served in configs]
        for (full, served), ref in zip(configs, refs):
            t_sub = time.perf_counter()
            gc_collect(on_card)
            held = torch.cuda.memory_allocated() / 1e6 if on_card else 0.0
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            params = lm.init_params(served, prng.PRNGKey(0), model_shards=1,
                                    device=dev)
            sync()
            t_init = time.perf_counter() - t0
            draw_peak = (torch.cuda.max_memory_allocated() / 1e6 if on_card
                         else 0.0)
            # the CPU's work of the last model ends before serving starts
            if pending is not None:
                pending.result()
            bf16_draw_check(served, params, *ref.result(), card)
            leaves = T.leaves(params)
            if any(t.dtype != torch.bfloat16 for t in leaves):
                raise AssertionError(f"{served.name}: a leaf is not "
                                     f"bfloat16")
            nparam = sum(t.numel() for t in leaves)
            out, st = serve(served, batch=B, prompt_len=S, gen=GEN, seed=0,
                            log=lambda *_: None, device=dev, params=params)
            o = out.cpu().numpy()
            if o.shape != (B, GEN + 1) or not (
                    (o >= 0) & (o < served.vocab)).all():
                raise AssertionError(f"served tokens {o.shape} out of range")
            experts = ""
            if served.family == "moe":
                per_step, pre = replay_experts(served, params, out, B, S,
                                               dev)
                step_bytes = moe_step_bytes(served, params, per_step)
                experts = (f"; distinct experts a layer a decode step mean "
                           f"{per_step.mean():.2f} (min {per_step.min():.0f}"
                           f", max {per_step.max():.0f}) of "
                           f"{served.n_experts}, prefill {pre}")
            else:                # every weight, both tables (one-hot embed)
                step_bytes = sum(t.numel() * t.element_size()
                                 for t in leaves)
            bound_s = step_bytes / HBM_BYTES_PER_S
            own = st["peak_mb"] - held if on_card else 0.0
            print(f"[30 serve] {served.name} cut to L={served.L} of "
                  f"{full.L} (full widths: {nparam / 1e10:.4f}e10 bfloat16 "
                  f"params, {2 * nparam / 1e9:.2f} GB) batch {B}, prompt {S}"
                  f" (one prefill forward), gen {GEN}: params drawn in "
                  f"{t_init:.2f} s ({nparam / max(t_init, 1e-9) / 1e9:.2f}e9"
                  f" draws/s), prefill {st['prefill_s']:.3f} s, decode "
                  f"{st['decode_s']:.3f} s, {st['tok_per_s']:.1f} tokens/s "
                  f"(bound {B / bound_s:.1f} tokens/s: "
                  f"{step_bytes / 1e9:.2f} GB of bfloat16 weights a step, "
                  f"{1e3 * bound_s:.2f} ms){experts}"
                  + (f"; resident {st['resident_mb']:.0f} MB, own peak "
                     f"{own:.0f} MB (limit 70000; serve's peak "
                     f"{st['peak_mb']:.0f} MB, the draw's {draw_peak:.0f} "
                     f"MB, phases before it held {held:.0f} MB)"
                     if on_card else "")
                  + f" ({card})", flush=True)
            if own > 70_000:
                raise AssertionError(f"{served.name}: own peak {own:.0f} MB"
                                     f" > 70000")
            if on_card:
                busy, by_name = profile_decode(served, params, B, S, dev,
                                               tag="30 profile")
                copy = {n: ms for n, ms in by_name.items()
                        if "copy" in n.lower()}
                print(f"[30 profile] {served.name}: busy share {busy:.3f}; "
                      f"copy kernels {sum(copy.values()):.2f} ms a decode "
                      f"step over {len(copy)} kernel names (the float32 "
                      f"blocks of the output table among them; no weight "
                      f"cast: bfloat16 weights at bfloat16 compute are used "
                      f"as they are) ({card})", flush=True)
            job = bf16_cut_card(served, params, dev, on_card)
            if served.family == "moe":          # phase 33 serves it
                kept = (served, params)
            del params, leaves, out
            gc_collect(on_card)
            pending = pool.submit(bf16_cut_cpu, *job, card)
            del job
            parts.append(f"{served.name} {time.perf_counter() - t_sub:.1f}")
        t0 = time.perf_counter()
        pending.result()
        parts.append(f"the last CPU check {time.perf_counter() - t0:.1f}")
    launched = {k: v - counts0[k] for k, v in launch_counts().items()}
    print(f"[30 kernels] launches in phase 30: {launched} (plain torch "
          f"products and draws, as the JAX package's are plain XLA)",
          flush=True)
    if any(launched.values()):
        raise AssertionError("phase 30 launched a kernel it should not")
    print(f"[30 done] phase 30 in {time.perf_counter() - t_phase:.1f} s: "
          f"{', '.join(parts)} s ({card})", flush=True)
    return kept


# phase 33: arctic-480b served at full width with all 128 experts on a
# logical 2 × 4 ("data", "model") mesh of the one card: 32 local experts a
# cell (64 a cell on ep2d's data axis), 56 heads / 4, batch 4 / 2, prompt
# 64 / 4
MESH_SHAPE = (2, 4)
MESH_GEN = 32
# its card = CPU cut: one layer at arctic's d_model with 8 heads, V 2,048
# and 16 experts (top 2) of d_ff 1,024, the dense residual MLP's too, at
# capacity 0.75, where the dispatch drops slots
MESH_CUT = dict(L=1, n_heads=8, vocab=2048, n_experts=16, d_ff=1024,
                moe_dense_ff=1024, moe_capacity=0.75, microbatches=1,
                param_dtype="float32", moment_dtype="float32",
                grad_dtype="float32", dtype="float32")


class ForceRoutes:
    """`moe.router` patched while entered: its expert ids replaced by
    ``force``'s (ids [L, B, S, k], one call a layer), the gates then the
    softmax of this run's router logits at those experts (as
    `moe_routes` forces them).  It patches the module, so no other
    thread runs a forward meanwhile."""

    def __init__(self, force):
        self.force, self.calls = force, 0

    def __enter__(self):
        from repro_torch.models import moe as MOE
        self._orig = MOE.router

        def forced(p, x, cfg):
            eid = self.force[self.calls].to(x.device)
            self.calls += 1
            logits = torch.einsum("bsd,de->bse", x.float(),
                                  p["router"].float())
            return eid, torch.softmax(logits.gather(-1, eid.long()), dim=-1)

        MOE.router = forced
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as MOE
        MOE.router = self._orig


def logged(log) -> tuple:
    """A dispatch log's routes [L, B, S, k] and kept-slot masks, on the
    CPU."""
    return (torch.stack([d["eid"] for d in log]).cpu(),
            torch.stack([d["mask"] for d in log]).cpu())


def mesh_prefill(cfg, p, toks, mesh, force=None):
    """`make_prefill` on ``mesh`` → (logits on the CPU, routes [L, B, S,
    k] and each dispatch's kept-slot mask, both on the CPU)."""
    import contextlib

    from repro_torch.models import moe as MOE
    from repro_torch.models import sharding as SH
    from repro_torch.models import steps

    with MOE.record_dispatches() as log, (
            ForceRoutes(force) if force is not None
            else contextlib.nullcontext()):
        lg, _ = steps.make_prefill(cfg, mesh, SH.mesh_axes(mesh))(
            p, {"tokens": toks})
    return (lg.cpu(), *logged(log))


def mesh_decode(cfg, p, toks, nxt, mesh, kv=None):
    """One `make_decode_step` on ``mesh`` of the tokens ``nxt`` [B, 1]
    (the replicated dispatch) behind the K/V caches ``kv`` of the
    prompt ``toks`` [B, S], by default those `make_prefill` of ``toks``
    on ``mesh`` gives → (the step's logits, routes [L, B, 1, k] and
    kept-slot masks, on the CPU; the caches it read).  The prefill's
    caches are bfloat16 at float32 compute too, so a card-vs-CPU check
    gives both sides the same caches: one rounding flipped by a
    float32 difference in the last bit moves the step's logits by ~1e-4
    of their max."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    from repro_torch.models import sharding as SH
    from repro_torch.models import steps

    B, S = toks.shape
    axes = SH.mesh_axes(mesh)
    if kv is None:
        _, pc = steps.make_prefill(cfg, mesh, axes)(p, {"tokens": toks})
        kv = (pc["k"], pc["v"])
    cache = steps.init_cache(cfg, B, S + 1, L.torch_dtype(cfg.dtype),
                             device=toks.device)
    cache["k"][:, :, :S], cache["v"][:, :, :S] = (t.to(toks.device)
                                                  for t in kv)
    cache["pos"] = S
    with MOE.record_dispatches() as log:
        lg, _ = steps.make_decode_step(cfg, mesh, axes)(p, cache, nxt)
    return (lg.cpu(), *logged(log), kv)


def mesh_train(cfg, p, toks, mesh):
    """One `make_train_step` on ``mesh`` of a copy of ``p`` → (loss,
    gnorm, the first moments = 0.1·scale·g)."""
    from repro_torch import tree as T
    from repro_torch.models import sharding as SH
    from repro_torch.models import steps

    q = T.tree_map(torch.clone, p)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    _, opt, aux = steps.make_train_step(cfg, mesh, SH.mesh_axes(mesh))(
        q, steps.init_opt(cfg, q), batch)
    return float(aux["loss"]), float(aux["gnorm"]), opt["m"]


def mesh_cut_runs(cut, p, toks, nxt, mesh, kv=None) -> dict:
    """The cut's float32 runs on ``mesh``: the a2a prefill, a decode step
    after it (the replicated dispatch; behind ``kv``, by default its own
    prefill's caches), the ep2d prefill (each (logits, routes, kept-slot
    masks)) and a train step (loss, gnorm, first moments)."""
    import dataclasses

    return dict(
        a2a=mesh_prefill(cut, p, toks, mesh),
        rep=mesh_decode(cut, p, toks, nxt, mesh, kv),
        ep2d=mesh_prefill(dataclasses.replace(cut, moe_ep2d=True), p, toks,
                          mesh),
        train=mesh_train(cut, p, toks, mesh))


def mesh_cut_check(full, dev, on_card: bool, card: str) -> None:
    """Phase 33 (a): the one-layer cut (`MESH_CUT`) on the logical 2 × 4
    mesh of the card and of the CPU, the CPU's runs in a worker thread
    beside the card's.  For each dispatch — the a2a prefill, a decode
    step behind the card's prefill caches (the replicated dispatch; the
    caches are bfloat16), the ep2d prefill — routes
    first, then the kept-slot masks, then the logits within 1e-4 of
    their max at float32; a train step's loss within 1e-5, its first
    moments within 1e-4 of each leaf's max; TF32 controls above the
    prefill's and the train step's limits; at bfloat16 compute the
    card's a2a prefill logits against the CPU's float32 ones on the
    card's routes within phase 30's 64u·rms / 8u·rms, beside a control
    with ``wo`` zeroed; every card run twice, bit-equal."""
    import dataclasses
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch import prng
    from repro_torch import tree as T
    from repro_torch.launch import mesh as M
    from repro_torch.models import lm

    cut = dataclasses.replace(full, **MESH_CUT)
    m_card = M.compat_mesh(MESH_SHAPE, ("data", "model"), device=dev)
    m_cpu = M.compat_mesh(MESH_SHAPE, ("data", "model"), device="cpu")
    p = lm.init_params(cut, prng.PRNGKey(33), model_shards=1, device=dev)
    hp = T.tree_map(lambda t: t.cpu(), p)
    cb = dataclasses.replace(cut, dtype="bfloat16", param_dtype="bfloat16")
    c32 = dataclasses.replace(cb, dtype="float32")
    p16 = T.tree_map(lambda t: t.to(torch.bfloat16), p)
    hp16 = T.tree_map(lambda t: t.cpu(), p16)
    rng = np.random.default_rng(33)
    toks = torch.from_numpy(rng.integers(0, cut.vocab, (4, 64)).astype(
        np.int32))
    nxt = torch.from_numpy(rng.integers(0, cut.vocab, (4, 1)).astype(
        np.int32))
    tc, nc = toks.to(dev), nxt.to(dev)
    t0 = time.perf_counter()

    def on_cpu(kv):
        return (mesh_cut_runs(cut, hp, toks, nxt, m_cpu, kv),
                mesh_prefill(c32, hp16, toks, m_cpu))

    with ThreadPoolExecutor(max_workers=1) as pool:
        got = mesh_cut_runs(cut, p, tc, nc, m_card)
        # the CPU's decode step behind the card's prefill caches
        cpu_job = pool.submit(on_cpu, tuple(t.cpu() for t in got["rep"][3]))
        again = mesh_cut_runs(cut, p, tc, nc, m_card)
        ctrl = (tf32(lambda: mesh_prefill(cut, p, tc, m_card)[0])
                if on_card else None)
        t_ctrl = (tf32(lambda: mesh_train(cut, p, tc, m_card)[2])
                  if on_card else None)
        lgb, eb, mkb = mesh_prefill(cb, p16, tc, m_card)
        lgb2, eb2, mkb2 = mesh_prefill(cb, p16, tc, m_card)
        ctl = dict(p16, layers=dict(p16["layers"], wo=torch.zeros_like(
            p16["layers"]["wo"])))
        lgc = mesh_prefill(cb, ctl, tc, m_card)[0]
        t_card = time.perf_counter() - t0
        want, (ref, e0, mk0) = cpu_job.result()
    t_cpu = time.perf_counter() - t0
    bit_equal = all(
        torch.equal(a, b) for k in ("a2a", "rep", "ep2d")
        for a, b in zip(got[k][:3], again[k][:3])) and (
        got["train"][0] == again["train"][0] and all(
            torch.equal(a, b) for a, b in zip(T.leaves(got["train"][2]),
                                              T.leaves(again["train"][2]))))
    fails = []
    for k in ("a2a", "rep", "ep2d"):
        (lg, e, mk), (h_lg, h_e, h_mk) = got[k][:3], want[k][:3]
        same_routes, same_masks = torch.equal(e, h_e), torch.equal(mk, h_mk)
        kept, routed = int(mk.sum()), mk.numel()
        scale = float(h_lg.abs().max())
        err = float((lg - h_lg).abs().max())
        extra = ""
        if k == "a2a" and on_card:
            c_err = float((ctrl - h_lg).abs().max())
            extra = f", TF32 control {c_err:.4g}"
            if not c_err > 1e-4 * scale:
                fails.append("the a2a limit passes TF32 products")
        what = ("a decode step behind the card's prefill caches"
                if k == "rep" else "prefill")
        print(f"[33 cut] {cut_name(cut)} on the logical {MESH_SHAPE[0]}x"
              f"{MESH_SHAPE[1]} mesh, float32, {k} dispatch ({what}, B "
              f"{toks.shape[0]} x S {toks.shape[1]}): card vs CPU routes "
              f"equal {same_routes}, kept-slot masks equal {same_masks} "
              f"({kept} of {routed} slots kept, {routed - kept} dropped); "
              f"logits max abs {err:.4g} (limit 1e-4 x {scale:.4g}){extra}"
              f" ({card})", flush=True)
        if not (same_routes and same_masks):
            fails.append(f"{k}: the card's routes or kept slots differ from "
                         f"the CPU's")
        elif not err <= 1e-4 * scale:
            fails.append(f"{k}: the card's float32 logits differ")
        if k == "a2a" and kept == routed:
            fails.append("a2a: no slot was dropped")
    loss, gn, m = got["train"]
    h_loss, h_gn, h_m = want["train"]
    worst, where = worst_leaf(m, h_m)
    t_worst = worst_leaf(t_ctrl, h_m)[0] if on_card else float("nan")
    print(f"[33 cut] train step on the mesh, float32: loss {loss:.7g} vs "
          f"{h_loss:.7g} (limit 1e-5 relative), gnorm {gn:.7g} vs "
          f"{h_gn:.7g}, first moments worst {worst:.3g} of the leaf's max "
          f"({where}; limit 1e-4), TF32 control {t_worst:.3g}; every card "
          f"run twice bit-equal {bit_equal}; the card's runs {t_card:.1f} s,"
          f" the CPU's beside them done at {t_cpu:.1f} s ({card})",
          flush=True)
    if not (abs(loss - h_loss) <= 1e-5 * abs(h_loss)
            and abs(gn - h_gn) <= 1e-5 * abs(h_gn) and worst <= 1e-4):
        fails.append("the card's float32 train step differs from the CPU's")
    if on_card and not t_worst > 1e-4:
        fails.append("the train step's limit passes TF32 products")
    if not bit_equal:
        fails.append("two float32 card runs differ")
    if fails:
        raise AssertionError("mesh cut: " + "; ".join(fails))
    # bfloat16 compute on bfloat16 weights; the CPU's float32 forward on
    # the same weights, on the card's routes (forced after the worker
    # ended: the patch is the module's)
    u = 2.0 ** -8
    if torch.equal(eb, e0):
        forced, mkf = ref, mk0
    else:
        forced, _, mkf = mesh_prefill(c32, hp16, toks, m_cpu, force=eb)
    agree = float((eb.sort(-1).values == e0.sort(-1).values).all(-1)
                  .float().mean())
    rms = float(forced.pow(2).mean().sqrt())
    d = (lgb.float() - forced).abs()
    b_max, b_mean = float(d.max()), float(d.mean())
    k_max = float((lgc.float() - forced).abs().max())
    lim = (64 * u * rms, 8 * u * rms)
    print(f"[33 cut] bfloat16 compute: routes agree with the CPU's float32 "
          f"ones on {agree:.4f} of the (token, layer) pairs (floor 0.85); "
          f"on the card's routes kept-slot masks equal "
          f"{torch.equal(mkb, mkf)} ({int(mkb.sum())} of {mkb.numel()} "
          f"kept), logits max abs {b_max:.4g}, mean {b_mean:.4g} (limits "
          f"64u·rms {lim[0]:.4g}, 8u·rms {lim[1]:.4g}, u = 2^-8); control,"
          f" wo zeroed: max abs {k_max:.4g}; two card runs bit-equal "
          f"{torch.equal(lgb, lgb2) and torch.equal(mkb, mkb2)} ({card})",
          flush=True)
    if not agree >= 0.85 or not torch.equal(mkb, mkf):
        raise AssertionError("mesh cut: bfloat16 routes or kept slots")
    if not (b_max <= lim[0] and b_mean <= lim[1]):
        raise AssertionError("mesh cut: the card's bfloat16 logits differ")
    if on_card and not k_max > lim[0]:
        raise AssertionError("mesh cut: the bfloat16 limit passes a layer "
                             "without its attention output")
    if not (torch.equal(lgb, lgb2) and torch.equal(mkb, mkb2)
            and torch.equal(eb, eb2)):
        raise AssertionError("mesh cut: two bfloat16 card runs differ")


def mesh_phase(args, cfg, params, dev, on_card: bool, power: str) -> int:
    """Phase 33: arctic-480b at full width cut to L = 1 with all 128
    experts, phase 30's drawn tree (``cfg``, ``params``), served on the logical
    2 × 4 mesh (`MESH_SHAPE`): `make_prefill` on `serve`'s request (batch
    4, prompt 64; the a2a dispatch at capacity 2.0), `MESH_GEN` greedy
    steps of `make_decode_step` (the replicated dispatch and its psum)
    and one prefill with ``moe_ep2d`` (experts over the data axis); the
    kept and dropped slots of each dispatch, prefill seconds and decode
    tokens/s beside the bound of reading the expert stack once a data
    row a step, a profiled decode step, own peak MB; (a) the card = CPU
    cut first.  → `segment_add`'s launches on the served path (the
    combine's scatter-add)."""
    import dataclasses

    from repro_torch import tree as T
    from repro_torch.core import scatter
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import mesh as M
    from repro_torch.models import moe as MOE
    from repro_torch.models import sharding as SH
    from repro_torch.models import steps

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t_phase = time.perf_counter()
    card = (f"{torch.cuda.get_device_name(0)}, power limit {power}"
            if on_card else power)
    prev = os.environ.get(M.LOGICAL_DEVICES)
    os.environ[M.LOGICAL_DEVICES] = str(MESH_SHAPE[0] * MESH_SHAPE[1])
    try:
        counts0 = launch_counts()
        mesh_cut_check(cfg, dev, on_card, card)
        t_cut = time.perf_counter() - t_phase
        gc_collect(on_card)
        mesh = M.compat_mesh(MESH_SHAPE, ("data", "model"), device=dev)
        axes = SH.mesh_axes(mesh)
        B, S = 4, 64
        toks = torch.from_numpy(np.random.default_rng(args.seed).integers(
            0, cfg.vocab, (B, S)).astype(np.int32)).to(dev)
        held = torch.cuda.memory_allocated() / 1e6 if on_card else 0.0
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        # ---- the main path: counters zeroed just before ----
        seg_cut = scatter.LAUNCHES - counts0["segment_add"]
        scatter.LAUNCHES = 0
        scatter.GROUP_LAUNCHES = scatter.SORTS = 0
        with MOE.record_dispatches() as log:
            sync()
            t0 = time.perf_counter()
            logits, pc = steps.make_prefill(cfg, mesh, axes)(
                params, {"tokens": toks})
            sync()
            t_pre = time.perf_counter() - t0
            cache = steps.init_cache(cfg, B, S + MESH_GEN, device=dev)
            cache["k"][:, :, :S], cache["v"][:, :, :S] = pc["k"], pc["v"]
            cache["pos"] = S
            dec = steps.make_decode_step(cfg, mesh, axes)
            out = [torch.argmax(logits, -1).to(torch.int32)[:, None]]
            sync()
            t0 = time.perf_counter()
            for _ in range(MESH_GEN):
                lg, cache = dec(params, cache, out[-1])
                out.append(torch.argmax(lg[:, -1], -1).to(torch.int32)[
                    :, None])
            sync()
            t_dec = time.perf_counter() - t0
            c2d = dataclasses.replace(cfg, moe_ep2d=True)
            t0 = time.perf_counter()
            lg2d, _ = steps.make_prefill(c2d, mesh, axes)(
                params, {"tokens": toks})
            sync()
            t_2d = time.perf_counter() - t0
        seg = scatter.LAUNCHES
        seg_group = (scatter.GROUP_LAUNCHES, scatter.SORTS)
        own = (torch.cuda.max_memory_allocated() / 1e6 - held if on_card
               else 0.0)
        o = torch.cat(out, 1).cpu().numpy()
        if o.shape != (B, MESH_GEN + 1) or not ((o >= 0)
                                               & (o < cfg.vocab)).all():
            raise AssertionError(f"mesh serve: tokens {o.shape} out of "
                                 f"range")
        if not (torch.isfinite(logits).all() and torch.isfinite(lg2d).all()
                and torch.isfinite(lg).all()):
            raise AssertionError("mesh serve: logits not finite")
        by = {}
        for d in log:
            n = by.setdefault(d["path"], [0, 0, 0, 0])
            n[0] += 1
            n[1] += d["routed"]
            n[2] += int(d["sent"])
            n[3] += int(d["kept"])
        if sorted(by) != ["a2a", "ep2d", "rep"] or by["rep"][0] != MESH_GEN:
            raise AssertionError(f"mesh serve: dispatches {by}")
        disp = "; ".join(
            f"{p} ({n} dispatch{'es' if n > 1 else ''}): {r} slots routed, "
            f"{s} past the send capacity, {k} kept, {r - k} dropped"
            for p, (n, r, s, k) in sorted(by.items()))
        # the unsharded prefill on the same tree: nothing dropped there
        plain, _ = steps.make_prefill(cfg)(params, {"tokens": toks})
        gap = lambda a: float((a.float() - plain.float()).abs().max())
        stack = sum(params["layers"][n].numel()
                    * params["layers"][n].element_size()
                    for n in ("w1", "w3", "w2"))
        rest = sum(t.numel() * t.element_size() for t in T.leaves(params)
                   ) - stack
        step_bytes = axes["ndp"] * stack + rest
        bound_s = step_bytes / HBM_BYTES_PER_S
        print(f"[33 serve] arctic-480b cut to L=1 of 35, all "
              f"{cfg.n_experts} experts, on the logical {MESH_SHAPE[0]}x"
              f"{MESH_SHAPE[1]} ('data', 'model') mesh of one card, batch "
              f"{B}, prompt {S}: prefill (a2a) {t_pre:.3f} s, decode "
              f"{MESH_GEN} steps {t_dec:.3f} s = {B * MESH_GEN / t_dec:.1f}"
              f" tokens/s ({1e3 * t_dec / MESH_GEN:.2f} ms a step; bound "
              f"{1e3 * bound_s:.2f} ms a step = {B / bound_s:.1f} tokens/s: "
              f"the {stack / 1e9:.2f} GB expert stack read once for each of "
              f"the {axes['ndp']} data rows and the other "
              f"{rest / 1e9:.2f} GB once), ep2d prefill {t_2d:.3f} s; "
              f"{disp}; prefill logits vs the unsharded prefill (nothing "
              f"dropped): a2a max abs {gap(logits):.4g}, ep2d "
              f"{gap(lg2d):.4g} (logit max {float(plain.abs().max()):.4g})"
              + (f"; own peak {own:.0f} MB (phases before held {held:.0f} "
                 f"MB)" if on_card else "") + f" ({card})", flush=True)
        if on_card:
            from torch.profiler import ProfilerActivity, profile
            sync()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                dec(params, cache, out[-1])
                sync()
                wall = time.perf_counter() - t0
            spans, busy, by_name = device_activity(prof)
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
            print(f"[33 profile] one decode step on the mesh in "
                  f"{1e3 * wall:.1f} ms (profiled): {len(spans)} device "
                  f"activities, busy {busy / 1e3:.1f} ms (share "
                  f"{busy / 1e6 / wall:.3f}); by kernel ms: " + "; ".join(
                      f"{n[:60]} {t / 1e3:.2f}" for n, t in top)
                  + f" ({card})", flush=True)
        others = {k: v - counts0[k] for k, v in launch_counts().items()
                  if k != "segment_add"}
        print(f"[33 kernels] segment_add launches on the served path: {seg}"
              f" (the combine's scatter-add, one a cell a dispatch: "
              f"{len(log)} dispatches x {mesh.size} cells; its grouping "
              f"{seg_group[0]}, torch.sort {seg_group[1]}), in the cut's "
              f"checks {seg_cut}; the other kernels' {others}", flush=True)
        if on_card and seg != len(log) * mesh.size:
            raise AssertionError(f"segment_add launched {seg} times in "
                                 f"{len(log)} dispatches")
        if any(others.values()):
            raise AssertionError("phase 33 launched a kernel it should not")
    finally:
        if prev is None:
            os.environ.pop(M.LOGICAL_DEVICES, None)
        else:
            os.environ[M.LOGICAL_DEVICES] = prev
    print(f"[33 done] phase 33 in {time.perf_counter() - t_phase:.1f} s "
          f"(the cut {t_cut:.1f} s) ({card})", flush=True)
    return seg


# phase 31: llama3-405b and arctic-480b trained in their own bfloat16
# parameters, gradients and moments and their own µ = 8, at full width cut
# to the one layer whose state (8 bytes a parameter) one 80 GB card holds:
# llama3-405b's layer and untied tables, 59.12 GB; arctic-480b's layer
# with 64 of its 128 experts, 59.00 GB (all 128 are 112.6 GB)
BF16_TRAINED = (("llama3-405b", {}), ("arctic-480b", {"n_experts": 64}))
BF16_OWN_PEAK_MB = 75_000
# their learning rate: at 3e-4 (the reference CLI's) llama3-405b's loss
# rose from 15.11 to 38.17 in one step (PERF.md §4): a first Adam
# step of about lr·sign(g) moves each of its logits by ~lr·Σ|h| ≈ 4 at
# d = 16,384.  At 3e-5 both losses fall step after step.
BF16_LR = 3e-5
BF16_DTYPES = dict(param_dtype="bfloat16", moment_dtype="bfloat16",
                   grad_dtype="bfloat16")


def bf16_train_cuts(on_card: bool) -> list:
    """Phase 31 (a)'s cuts, each one layer at float32 compute with its
    config's bfloat16 parameters, gradients and moments, µ = 2, sized so
    that the CPU's halves take ~30 s on an 8-core H100 host (a
    llama3-405b layer at full d_model and d_ff with a 8,192 vocabulary,
    3.46·10⁹ parameters, took 218.5 s there): llama3-405b's d_model
    16,384 with 8 of its 128 heads, d_ff 4,096 and a 2,048 vocabulary
    (0.34·10⁹); arctic-480b's d_model 7,168 with 4 of its experts at
    their full d_ff 4,864, top 2, its dense residual MLP, 8 of its 56
    heads and a 2,048 vocabulary (0.58·10⁹) — and (llama3-405b's) whether
    the Adam update is held word for word.  Reduced configs in the CPU
    rehearsal."""
    import dataclasses

    from repro_torch.configs import base as CB

    cuts = []
    for name, kw in (("llama3-405b", dict(n_heads=8, d_ff=4096,
                                          vocab=2048)),
                     ("arctic-480b", dict(n_experts=4, n_heads=8,
                                          vocab=2048))):
        base = CB.get(name)
        if not on_card:
            base, kw = dataclasses.replace(CB.reduced(base),
                                           **BF16_DTYPES), {}
        cuts.append((dataclasses.replace(base, L=1, dtype="float32",
                                         microbatches=2, **kw),
                     name == "llama3-405b"))
    return cuts


_CAPTURE = threading.local()


def captured_step(cfg, params, opt, batch, update: bool = True):
    """One `make_train_step` step → (the gradient sum it hands Adam, its
    ``denom`` (1 where the step divided in place), the step's aux); with
    ``update`` False Adam is skipped, the parameters and moments left as
    they were.  Adam reads the sum and writes nothing into it.

    `steps.adam_update` is wrapped once (the wrapper stays): it captures
    for the thread that asked and is the plain update for every other
    call.  Patched and restored around each call instead, a CPU half's
    capture in the worker thread took the card's steps beside it: their
    gradient sums, and with ``update`` False their Adam updates."""
    from repro_torch.models import steps

    if not hasattr(steps.adam_update, "plain"):
        adam = steps.adam_update

        def capturing(cfg_, params_, grads, opt_, **kw):
            slot = getattr(_CAPTURE, "slot", None)
            if slot is None:
                return adam(cfg_, params_, grads, opt_, **kw)
            slot["g"], slot["denom"] = grads, kw.get("denom")
            if slot["update"]:
                return adam(cfg_, params_, grads, opt_, **kw)
            return params_, opt_, torch.zeros(())

        capturing.plain = adam
        steps.adam_update = capturing
    _CAPTURE.slot = slot = {"update": update}
    try:
        _, _, aux = steps.make_train_step(cfg)(params, opt, batch)
    finally:
        _CAPTURE.slot = None
    denom = slot["denom"]
    return slot["g"], 1.0 if denom is None else float(denom), aux


def bf16_train_cut_card(cut, adam: bool, dev, seed: int) -> dict:
    """Phase 31 (a), the card's half on one cut (B 2 × S 16, µ = 2): the
    parameters drawn on the card and kept as they were before the step;
    moe routes of each microbatch; the gradient sum of ``mb_mask`` [1, 0]
    (the control, Adam skipped) against [1, 1]'s on the card; then the
    [1, 1] step, with its Adam update in place if ``adam``.  → the job's
    card tensors (to be copied to the host) and what the card measured."""
    from repro_torch import prng
    from repro_torch import tree as T
    from repro_torch.models import lm, steps

    t0 = time.perf_counter()
    p = lm.init_params(cut, prng.PRNGKey(31), model_shards=1, device=dev)
    p0 = T.tree_map(torch.clone, p)
    opt = steps.init_opt(cut, p)
    rng = np.random.default_rng(seed + 31)
    b = {k: torch.from_numpy(rng.integers(0, cut.vocab, (2, 16)).astype(
        np.int32)) for k in ("tokens", "labels")}
    on_dev = {k: v.to(dev) for k, v in b.items()}
    eids = []
    if cut.family == "moe":
        with torch.no_grad():
            for i in range(2):
                eids.append(moe_routes(cut, p, on_dev["tokens"][i:i + 1])[1])
    ones = torch.ones(2, device=dev)
    g_ctrl, d_ctrl, _ = captured_step(cut, p, opt, dict(
        on_dev, mb_mask=torch.tensor([1.0, 0.0], device=dev)), update=False)
    g_ctrl = T.tree_map(torch.clone, g_ctrl)
    g, denom, aux = captured_step(cut, p, opt, dict(on_dev, mb_mask=ones),
                                  update=adam)
    ctrl = worst_leaf(g_ctrl, g, (d_ctrl, denom))
    del g_ctrl
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return dict(cut=cut, batch=b, eids=eids, loss=float(aux["loss"]),
                gnorm=float(aux["gnorm"]), denom=denom, ctrl=ctrl,
                card=dict(p0=p0, g=g) | (dict(after=(p, opt)) if adam
                                         else {}),
                t_card=time.perf_counter() - t0)


def bf16_train_cut_copy(job: dict) -> dict:
    """Phase 31 (a): the card's tensors of a job to the host (a worker
    thread; the card's copies are dropped after)."""
    from repro_torch import tree as T

    t0 = time.perf_counter()
    host = lambda tree: T.tree_map(lambda t: t.to("cpu", copy=True), tree)
    card = job.pop("card")
    job["host"] = {k: host(v) for k, v in card.items()}
    job["t_copy"] = time.perf_counter() - t0
    job["copied_gb"] = sum(t.numel() * t.element_size() for t in T.leaves(
        job["host"])) / 1e9
    return job


def bf16_train_cut_cpu(job: dict, card: str) -> None:
    """Phase 31 (a), the CPU's half: the same step on the host from the
    card's state before it — moe routes equal first, the loss within
    1e-5, each gradient sum's leaf within 8u of its max (u = 2⁻⁸: each
    microbatch's float32 gradient, summed in another order, rounds to
    one bfloat16 ulp (2u) apart at most, and their sum once more); the
    control above 8u; an Adam update on the CPU from the card's gradient
    sum, the card's parameters and moments after its update against it:
    bit-equal, each difference counted and one bfloat16 ulp at most (the
    cut that holds it)."""
    from repro_torch import tree as T
    from repro_torch.models import steps

    u = 2.0 ** -8
    cut, hst = job["cut"], job["host"]
    t0 = time.perf_counter()
    routes = ""
    if job["eids"]:
        with torch.no_grad():
            got = [moe_routes(cut, hst["p0"], job["batch"]["tokens"][i:i + 1])
                   for i in range(2)]
        same = all(torch.equal(e, w[1]) for e, w in zip(job["eids"], got))
        gap = min(float(w[2].min()) for w in got)
        routes = (f"routes of both microbatches card = CPU {same} (smallest "
                  f"top-2 gap {gap:.4g}); ")
        if not same:
            raise AssertionError(f"{cut.name}: the card's routes differ "
                                 f"from the CPU's")
    marks = [time.perf_counter()]
    p = T.tree_map(torch.clone, hst["p0"])
    g, denom, aux = captured_step(cut, p, steps.init_opt(cut, p), dict(
        job["batch"], mb_mask=torch.ones(2)), update=False)
    marks.append(time.perf_counter())
    rel = abs(job["loss"] - float(aux["loss"])) / abs(float(aux["loss"]))
    worst, path = worst_leaf(hst["g"], g, (job["denom"], denom))
    ctrl, cpath = job["ctrl"]
    del g, p
    marks.append(time.perf_counter())
    # Adam from the card's gradient sum, from the state before the step
    n_diff = n_all = ulp = 0
    adam = "after" in hst
    if adam:
        p, opt, gn = steps.adam_update(cut, hst["p0"], hst["g"],
                                       steps.init_opt(cut, hst["p0"]),
                                       denom=torch.tensor(job["denom"]))
    marks.append(time.perf_counter())
    if adam:
        after_p, after_o = hst["after"]
        for a, w in zip(T.leaves((p, opt["m"], opt["v"])),
                        T.leaves((after_p, after_o["m"], after_o["v"]))):
            n_all += a.numel()
            if torch.equal(a, w):
                continue
            for ai, wi in zip(
                    a.reshape(-1).view(torch.int16).split(1 << 26),
                    w.reshape(-1).view(torch.int16).split(1 << 26)):
                d = (ai.to(torch.int32) - wi.to(torch.int32)).abs()
                n_diff += int((d != 0).sum())
                ulp = max(ulp, int(d.max()))
    marks.append(time.perf_counter())
    t_cpu = time.perf_counter() - t0
    split = ", ".join(f"{w} {b - a:.1f}" for w, a, b in zip(
        ("routes", "step", "distance", "Adam", "compare"),
        [t0] + marks[:-1], marks))
    nparam = sum(t.numel() for t in T.leaves(hst["p0"]))
    print(f"[31 cpu] {cut.name} cut (L=1, d={cut.d_model}, ff={cut.d_ff}, "
          f"V={cut.vocab}"
          + (f", {cut.n_experts} experts of ff {cut.d_ff}, top "
             f"{cut.moe_top_k}, dense ff {cut.moe_dense_ff}"
             if cut.family == "moe" else "")
          + f"; {nparam / 1e9:.3f}e9 bfloat16 params, grad and moment "
          f"dtypes bfloat16, float32 compute), µ=2 B 2 x S 16, card vs CPU:"
          f" {routes}loss {job['loss']:.6f} vs {float(aux['loss']):.6f} (rel "
          f"{rel:.3g}, limit 1e-5); the gradient sum's worst leaf "
          f"{worst / u:.3f}u of its max ({path}; limit 8u); control, "
          f"mb_mask [1, 0] against [1, 1] on the card: {ctrl / u:.1f}u "
          f"({cpath}); "
          + (f"Adam of the card's gradient sum on the CPU (gnorm "
             f"{float(gn):.6g}, the card's {job['gnorm']:.6g}): {n_diff} of "
             f"{n_all} parameter and moment words differ from the card's, "
             f"by at most {ulp} bfloat16 ulp (limit 1); " if adam else "")
          + f"card {job['t_card']:.1f} "
          f"s, copies to the host {job['copied_gb']:.1f} GB in "
          f"{job['t_copy']:.1f} s, the CPU {t_cpu:.1f} s ({split}) in a "
          f"worker thread ({card})", flush=True)
    if not (rel <= 1e-5 and worst <= 8 * u):
        raise AssertionError(f"{cut.name}: the card's bfloat16 train step "
                             f"disagrees with the CPU's")
    if not ctrl > 8 * u:
        raise AssertionError(f"{cut.name}: the gradient limit passes a "
                             f"dropped microbatch")
    if ulp > 1:
        raise AssertionError(f"{cut.name}: the card's Adam update is more "
                             f"than one bfloat16 ulp from the CPU's")


def bf16_train_full(name: str, kw: dict, args, dev, on_card: bool,
                    card: str) -> str:
    """Phase 31 (b) / (c): ``name`` at full width cut to L = 1 (and ``kw``)
    in its own bfloat16 dtypes and µ through `train_loop` (3 steps at
    batch 8 × seq 128, lr `BF16_LR`; the draw timed inside it), then 3
    synchronised `make_train_step` steps over batches drawn before: init
    s, step s and tokens/s beside the bound, the loss from first to last
    (it must fall), resident and own peak MB (≤ `BF16_OWN_PEAK_MB`), a
    profiled step's busy share; moe: the distinct experts a microbatch.
    → a summary for the done line."""
    import dataclasses

    from repro_torch import tree as T
    from repro_torch.configs import base as CB
    from repro_torch.launch import train as ltrain
    from repro_torch.models import lm, steps
    from repro_torch.models import moe as MOE

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    base = CB.get(name)
    full = dataclasses.replace(base, L=1, **kw)
    if not on_card:                                  # rehearsal size
        full = dataclasses.replace(CB.reduced(base), **BF16_DTYPES,
                                   microbatches=base.microbatches)
    B, S, N_LOOP, N_TIMED = 8, 128, 3, 3
    gc_collect(on_card)
    held = torch.cuda.memory_allocated() / 1e6 if on_card else 0.0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t_init, per_call = [], []
    draw, route = lm.init_params, MOE.moe_dense_ref

    def timed_draw(*a, **k):
        t0 = time.perf_counter()
        out = draw(*a, **k)
        sync()
        t_init.append(time.perf_counter() - t0)
        return out

    owner = threading.get_ident()      # not the CPU checks' worker

    def counted(pl, x, eid, gate, cfg):
        if threading.get_ident() == owner:
            per_call.append(int(torch.unique(eid).numel()))
        return route(pl, x, eid, gate, cfg)

    lm.init_params, MOE.moe_dense_ref = timed_draw, counted
    try:
        t0 = time.perf_counter()
        params, opt, losses = ltrain.train_loop(
            full, steps_n=N_LOOP, batch=B, seq=S, lr=BF16_LR, device=dev,
            seed=args.seed, log=lambda *_: None)
        sync()
        wall = time.perf_counter() - t0
        resident = torch.cuda.memory_allocated() / 1e6 if on_card else 0.0
        step_fn = steps.make_train_step(full, lr=BF16_LR)
        trng = np.random.default_rng(args.seed + 31)
        batches = [ltrain.synth_batch(trng, full, B, S, device=dev)
                   for _ in range(N_TIMED)]
        marks = []
        for tb in batches:
            t = time.perf_counter()
            params, opt, aux = step_fn(params, opt, tb)
            sync()
            marks.append(time.perf_counter() - t)
            losses.append(float(aux["loss"]))
    finally:
        lm.init_params, MOE.moe_dense_ref = draw, route
    peak = torch.cuda.max_memory_allocated() / 1e6 if on_card else 0.0
    own = peak - held
    leaves = T.leaves((params, opt["m"], opt["v"]))
    nparam = sum(t.numel() for t in T.leaves(params))
    step_s = float(np.median(marks))
    # the bound: the larger of the operations over the bfloat16 rate
    # (every product's operands are bfloat16: the logits' float32 product
    # of bfloat16 operands included) and the bytes over the memory rate
    if full.family == "moe":
        bf, f32 = moe_step_flops(full, B, S)
    else:
        bf, f32 = lm_step_flops(full, B, S)
    lay = params["layers"]
    size = lambda t: t.numel() * t.element_size()
    experts = ("w1", "w3", "w2") if full.family == "moe" else ()
    dense = sum(size(v) for n, v in lay.items() if n not in experts)
    tables = sum(size(params[n]) for n in ("embed", "out_embed"))
    moe_txt = ""
    if experts:
        per_call = np.asarray(per_call, dtype=np.float64)
        one = sum(size(lay[n][0, 0]) for n in experts)
        # each microbatch reads the experts it routes to: forward, the
        # rematerialised forward and the backward (2 calls a microbatch)
        dense += one * per_call.mean()
        moe_txt = (f"; distinct experts a microbatch (each of "
                   f"{len(per_call)} calls, 2 a microbatch) mean "
                   f"{per_call.mean():.2f} (min {per_call.min():.0f}, max "
                   f"{per_call.max():.0f}) of {full.n_experts}")
    tree = 2 * nparam
    mu = full.microbatches
    b_bytes = (mu * (3 * dense + 2 * tables) + mu * 2 * tree
               + 14 * nparam)
    t_bytes = b_bytes / HBM_BYTES_PER_S
    t_ops = (bf + f32) / BF16_OPS_PER_S
    bound = max(t_bytes, t_ops)
    timed_cell("31", full, B, S, bound, step_s)
    print(f"[31 train] {full.name} cut to L={full.L} of {base.L}"
          + (f" with {full.n_experts} of {base.n_experts} experts"
             if experts else "")
          + f", full widths ({nparam / 1e9:.4f}e9 params; parameters, "
          f"gradient sum and moments {full.param_dtype}/{full.grad_dtype}/"
          f"{full.moment_dtype}, {full.dtype} compute, µ={mu}), batch {B} "
          f"seq {S}, lr {BF16_LR:g}: init (the draw) {t_init[0]:.2f} s; "
          f"{N_LOOP} train_loop steps in {wall:.1f} s (the draw included); "
          f"{N_TIMED} synchronised make_train_step steps, median "
          f"{step_s:.4f} s (min {min(marks):.4f}, max {max(marks):.4f}), "
          f"{B * S / step_s:.0f} tokens/s; loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} over {len(losses)} steps{moe_txt}"
          + (f"; resident {resident:.0f} MB, the card's peak {peak:.0f} MB "
             f"of which phases before held {held:.0f} MB: own peak "
             f"{own:.0f} MB (limit {BF16_OWN_PEAK_MB})" if on_card else "")
          + f" ({card})", flush=True)
    print(f"[31 bound] {full.name}: bytes — µ={mu} x (3 reads of the "
          f"layer's {dense / 1e9:.2f} GB of weights read a microbatch + 2 of"
          f" the {tables / 1e9:.2f} GB of tables) + µ x 2 x the "
          f"{tree / 1e9:.2f} GB accumulator + Adam's 14 B x {nparam:.4g} = "
          f"{b_bytes / 1e9:.1f} GB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s "
          f"{1e3 * t_bytes:.1f} ms; operations {(bf + f32) / 1e12:.2f} "
          f"TFLOP at {BF16_OPS_PER_S / 1e12:.0f} TFLOP/s {1e3 * t_ops:.1f} "
          f"ms; bound {1e3 * bound:.1f} ms (by "
          f"{'bytes' if t_bytes >= t_ops else 'operations'}); the step took "
          f"{1e3 * step_s:.1f} ms, {step_s / bound:.1f}x ({card})",
          flush=True)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"{full.name}: the loss did not fall: {losses}")
    if any(t.dtype != torch.bfloat16 for t in leaves):
        raise AssertionError(f"{full.name}: a leaf left bfloat16")
    if on_card and not own <= BF16_OWN_PEAK_MB:
        raise AssertionError(f"{full.name}: own peak {own:.0f} MB > "
                             f"{BF16_OWN_PEAK_MB}")
    busy = float("nan")
    if on_card:
        busy = profile_train_step(full, params, opt, batches[0],
                                  tag="31 profile", n_top=6, card=card)
    del params, opt, batches, leaves
    gc_collect(on_card)
    return (f"{full.name} step {step_s:.3f} s (bound {bound:.3f}), own peak "
            f"{own:.0f} MB, busy {busy:.3f}")


def bf16_train_ckpt(args, dev, card: str) -> None:
    """Phase 31 (d): reduced arctic-480b in bfloat16 parameters, gradient
    sum and moments at µ = 2: the step-2 checkpoint (under
    ``build/chip_smoke_bf16_ckpt``, removed) restored bit for bit, and
    the loop resumed from it to step 4 against the same state stepped in
    memory — losses and every leaf bit-equal."""
    import dataclasses
    import shutil

    from repro_torch import tree as T
    from repro_torch.configs import base as CB
    from repro_torch.launch import train as ltrain
    from repro_torch.models import steps
    from repro_torch.train import checkpoint as ckpt

    red = dataclasses.replace(CB.reduced(CB.get("arctic-480b")),
                              **BF16_DTYPES, microbatches=2)
    d = os.path.join(ROOT, "build", "chip_smoke_bf16_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    kw = dict(batch=8, seq=32, device=dev, seed=args.seed)
    p2, o2, first = ltrain.train_loop(red, steps_n=2, ckpt_dir=d,
                                      ckpt_every=2, log=lambda *_: None, **kw)
    got, step = ckpt.restore(d, (p2, o2))
    bits = lambda t: t.reshape(-1).view(torch.uint8)
    same = step == 2 and all(
        a.dtype == w.dtype and a.device == w.device
        and torch.equal(bits(a), bits(w))
        for a, w in zip(T.leaves(got), T.leaves((p2, o2))))
    del got
    logs = []
    p4, o4, resumed = ltrain.train_loop(red, steps_n=4, ckpt_dir=d,
                                        log=logs.append, **kw)
    step_fn = steps.make_train_step(red)
    brng, in_mem = np.random.default_rng(args.seed), []
    for _ in range(2):
        p2, o2, aux = step_fn(p2, o2, ltrain.synth_batch(brng, red, 8, 32,
                                                         device=dev))
        in_mem.append(float(aux["loss"]))
    equal = all(torch.equal(bits(a), bits(w)) for a, w in zip(
        T.leaves((p4, o4)), T.leaves((p2, o2))))
    dts = {t.dtype for t in T.leaves((p4, o4["m"], o4["v"]))}
    print(f"[31 ckpt] reduced {red.name} (µ={red.microbatches}; parameters,"
          f" gradient sum and moments bfloat16: {dts}): the step-2 "
          f"checkpoint restored every leaf bit for bit: {same}; resumed "
          f"{logs[:1]}: losses {resumed} vs the state in memory {in_mem}, "
          f"every leaf bit-equal after step 4: {equal} (first two {first}) "
          f"({card})", flush=True)
    shutil.rmtree(d, ignore_errors=True)
    if not (same and equal and dts == {torch.bfloat16} and resumed == in_mem
            and logs[:1] == ["resumed from step 2"]):
        raise AssertionError("the bfloat16 checkpoint did not resume bit for "
                             "bit")


def bf16_train_phase(args, dev, on_card: bool, power: str) -> None:
    """Phase 31: training with bfloat16 parameters, gradients and moments
    (`steps.make_train_step`'s in-place bfloat16 sum, `adam_update`'s
    folded division and sliced norm, `logits_of`'s blocked backward,
    `moe._ExpertFFN` on bfloat16 stacks, `launch/train.py::train_loop`,
    bfloat16 leaves through `train/checkpoint.py`): (a) the card against
    the CPU on one-layer cuts (`bf16_train_cuts`), the CPU's halves in a
    worker thread beside (b)–(d); (b) llama3-405b and (c) arctic-480b
    (64 of 128 experts) trained at full width, L = 1, µ = 8
    (`bf16_train_full`); (d) reduced arctic-480b's bfloat16 checkpoint
    resumed bit for bit (`bf16_train_ckpt`).  Launches none of the seven
    kernels."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import launch_counts

    t_phase = time.perf_counter()
    counts0 = launch_counts()
    card = (f"{torch.cuda.get_device_name(0)}, power limit {power}"
            if on_card else power)
    parts = []
    with ThreadPoolExecutor(max_workers=1) as pool:
        # (a) the card's halves; each job's tensors go to the host in the
        # worker while the card runs on, and the CPU's halves follow there
        copies, checks = [], []
        for cut, adam in bf16_train_cuts(on_card):
            gc_collect(on_card)
            copies.append(pool.submit(bf16_train_cut_copy,
                                      bf16_train_cut_card(cut, adam, dev,
                                                          args.seed)))
        for f in copies:
            checks.append(pool.submit(bf16_train_cut_cpu, f.result(), card))
        del copies
        parts.append(f"(a) card {time.perf_counter() - t_phase:.1f}")
        t0 = time.perf_counter()
        bf16_train_ckpt(args, dev, card)
        parts.append(f"(d) {time.perf_counter() - t0:.1f}")

        # (b), (c) beside the CPU's halves: a full-width step is
        # device-paced (busy 0.99; a CPU kept busy beside it moved it by
        # under 1 %: PERF.md §5)
        for name, kw in BF16_TRAINED:
            t0 = time.perf_counter()
            parts.append(bf16_train_full(name, kw, args, dev, on_card, card)
                         + f" in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        for f in checks:
            f.result()
        parts.append(f"waiting for the CPU's halves "
                     f"{time.perf_counter() - t0:.1f}")
    gc_collect(on_card)
    launched = {k: v - counts0[k] for k, v in launch_counts().items()}
    print(f"[31 kernels] launches in phase 31: {launched} (plain torch "
          f"products and elementwise ops, as the JAX package's are plain "
          f"XLA) ({card})", flush=True)
    if any(launched.values()):
        raise AssertionError("phase 31 launched a kernel it should not")
    print(f"[31 done] phase 31 in {time.perf_counter() - t_phase:.1f} s: "
          f"{'; '.join(parts)} s ({card})", flush=True)


class DrawLog:
    """Logs every parameter tree `lm.init_params` draws while installed
    (the entry points' draws inside `serve` and `train_loop` too): the
    phase, the config cut, ``model_shards`` and the tree's parameter
    count."""

    def __init__(self):
        self.phase, self.rows, self._draw = "", [], None

    def install(self) -> None:
        from repro_torch import tree as T
        from repro_torch.models import lm
        self._draw = draw = lm.init_params

        def logged(cfg, key, model_shards=16, device=None):
            p = draw(cfg, key, model_shards=model_shards, device=device)
            self.rows.append((self.phase, cfg, model_shards,
                              sum(t.numel() for t in T.leaves(p))))
            return p

        lm.init_params = logged

    def uninstall(self) -> None:
        from repro_torch.models import lm
        lm.init_params = self._draw


def timed_cell(phase: str, cfg, B: int, S: int, bound_s: float,
               step_s: float) -> None:
    """A timed training cell for phase 32: the cut as trained (its own
    µ), batch B, S positions a sequence, the phase's bound, the step."""
    TIMED_CELLS.append(dict(phase=phase, cfg=cfg, B=B, S=S,
                            bound_ms=1e3 * bound_s, step_ms=1e3 * step_s))


def cut_name(cfg) -> str:
    """``cfg.name`` and every field it changes from the registered
    config."""
    import dataclasses
    from repro_torch.configs import base as CB
    full = CB.get(cfg.name)
    diff = [f"{f.name}={getattr(cfg, f.name)}"
            for f in dataclasses.fields(cfg)
            if getattr(cfg, f.name) != getattr(full, f.name)]
    return cfg.name + (f"[{', '.join(diff)}]" if diff else "")


def roofline_phase(draws: DrawLog, on_card: bool, power: str) -> None:
    """Phase 32: the analytic roofline on meta tensors (module docstring).
    Launches no kernel and allocates nothing on the card."""
    from repro_torch import tree as T
    from repro_torch.configs import base as CB
    from repro_torch.launch import roofline as R
    from repro_torch.launch import specs as SP

    t_phase = time.perf_counter()
    card = (f"{torch.cuda.get_device_name(0)}, {power}" if on_card
            else "cpu rehearsal")
    # (a) the ten meta trees at full depth
    for name in CB.names():
        line = []
        for ms in (1, 16):
            t0 = time.perf_counter()
            p = SP.param_specs(CB.get(name), ms)
            dt = time.perf_counter() - t0
            n = sum(t.numel() for t in T.leaves(p))
            if any(not t.is_meta for t in T.leaves(p)):
                raise AssertionError(f"{name}: a leaf left the meta device")
            line.append(f"model_shards {ms}: {n:,} parameters in "
                        f"{1e3 * dt:.2f} ms")
        print(f"[32 meta] {name} (L={CB.get(name).L}): " + "; ".join(line),
              flush=True)
    # (b) every runnable cell at one card's axes
    for arch, shape, ok, why in CB.cells(include_skips=True):
        if not ok:
            print(f"[32 roofline] {arch} x {shape}: skipped ({why})",
                  flush=True)
            continue
        r = R.analytic_cell(CB.get(arch), CB.SHAPES[shape])
        print(f"[32 roofline] {arch} x {shape}: model_flops "
              f"{r['model_flops']:.6g}, analytic_hbm_bytes "
              f"{r['hbm_bytes']:.6g}, t_compute {1e3 * r['t_compute']:.4f} "
              f"ms, t_memory {1e3 * r['t_memory']:.4f} ms, bound "
              f"{r['bound']}, t_step {1e3 * r['t_step']:.4f} ms ({card})",
              flush=True)
    # (c) every tree phases 23-31 drew against param_counts of its cut
    seen = {}
    for phase, cfg, ms, n in draws.rows:
        want = R.param_counts(cfg, ms)[0]
        if want != n:
            raise AssertionError(f"phase {phase}: {cut_name(cfg)} at "
                                 f"model_shards {ms} drew {n} parameters, "
                                 f"param_counts says {want}")
        seen.setdefault((phase, cut_name(cfg), ms, n), 0)
        seen[(phase, cut_name(cfg), ms, n)] += 1
    for (phase, name, ms, n), k in seen.items():
        print(f"[32 counts] phase {phase}: {name} model_shards {ms}: drawn "
              f"{n:,} = param_counts ({k} draw{'s' if k > 1 else ''})",
              flush=True)
    if not draws.rows:
        raise AssertionError("phases 23-31 logged no draw")
    # (d) the timed training cells: roofline, phase bound, measured step
    for c in TIMED_CELLS:
        shape = CB.ShapeSpec(f"phase {c['phase']}", c["S"], c["B"], "train")
        r = R.analytic_cell(c["cfg"], shape)
        print(f"[32 cells] phase {c['phase']}: {cut_name(c['cfg'])} batch "
              f"{c['B']} x {c['S']}: roofline t_step "
              f"{1e3 * r['t_step']:.2f} ms ({r['bound']}: compute "
              f"{1e3 * r['t_compute']:.2f}, memory {1e3 * r['t_memory']:.2f}"
              f" ms), the phase's bound {c['bound_ms']:.2f} ms, measured "
              f"step {c['step_ms']:.2f} ms ({card})", flush=True)
    # (e) llama3-8b's dense forward counted on meta tensors
    cfg = CB.get("llama3-8b")
    for B, S in ((1, 128), (CB.SHAPES["prefill_32k"].global_batch,
                            CB.SHAPES["prefill_32k"].seq_len)):
        t0 = time.perf_counter()
        n = R.forward_flops(cfg, {"tokens": SP.meta((B, S), torch.int32)},
                            model_shards=1)
        dt = time.perf_counter() - t0
        d = R.dense_forward_flops(cfg, B, S, model_shards=1)
        mf = R.model_flops(cfg, CB.ShapeSpec("prefill", S, B, "prefill"), 1)
        print(f"[32 flops] llama3-8b forward + logits at B {B} x S {S}: "
              f"FlopCounterMode {n:.6g} in {dt:.2f} s, model_flops "
              f"{mf:.6g}; count - model_flops = tied table "
              f"{d['tied_table']:.4g} + vector params "
              f"{d['vector_params']:.4g} + attention {d['attention']:.4g}",
              flush=True)
        if n != d["total"] or mf + d["tied_table"] + d["vector_params"] \
                + d["attention"] != n:
            raise AssertionError(f"the forward count {n} is not its "
                                 f"derivation {d}")
    print(f"[32 done] {time.perf_counter() - t_phase:.2f} s", flush=True)


DRYRUN_TIMEOUT_S = 900      # phase 34 (a): the sweep's own limit
MEM_CELL = ("llama3-8b", "decode_32k", [("L", 2)])   # phase 34 (b)


def dryrun_sweep_start() -> dict:
    """Phase 34 (a), started before the card phases: ``python -m
    repro_torch.launch.dryrun --all --roofline`` in a subprocess with one
    thread and no card (``CUDA_VISIBLE_DEVICES`` empty), its records in a
    temp dir under ``build/``, its output in files there.  The process is
    killed and the dir removed at exit, whatever happens."""
    import atexit
    import shutil
    import tempfile

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    out = tempfile.mkdtemp(prefix="chip_smoke_dryrun_",
                           dir=os.path.join(ROOT, "build"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    log = open(os.path.join(out, "sweep.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--roofline", "--out", os.path.join(out, "dryrun")],
        cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
    atexit.register(shutil.rmtree, out, True)
    atexit.register(proc.kill)
    return dict(proc=proc, out=out, log=log, t0=time.perf_counter(),
                t_wall0=time.time())


def moe_a2a_bytes(cfg, shape, axes) -> tuple[int, str]:
    """The counted collective bytes a moe cell must show, per device, and
    the formula: per dispatch and receiving cell n·C_send·(2·D·b + 4)
    forward (the rows out, the int32 expert ids, the rows back) and
    n·C_send·2·D·b in a training cell's backward (the remat runs the
    forward again), × the moe layers and µ; a decode step's replicated
    dispatch one all-reduce of its b_dp·D·b output block a layer."""
    from repro_torch.launch import roofline as R
    from repro_torch.models import layers as L

    b = L.torch_dtype(cfg.dtype).itemsize
    D, k, n = cfg.d_model, cfg.moe_top_k, axes["ntp"]
    mshape = R.micro_shape(shape, cfg)
    mu = max(1, cfg.microbatches) if shape.kind == "train" else 1
    b_dp = mshape.global_batch // axes["ndp"]
    if shape.kind == "decode":
        return (cfg.L * b_dp * D * b,
                f"all-reduce L·b_dp·D·b = {cfg.L}·{b_dp}·{D}·{b}")
    s_loc = mshape.seq_len // n
    C_send = max(1, int(round(b_dp * s_loc * k / n * cfg.moe_capacity)))
    fwd = n * C_send * (2 * D * b + 4)
    if shape.kind == "train":
        per = fwd * (2 if cfg.remat else 1) + n * C_send * 2 * D * b
        text = (f"all-to-all L·µ·((1 + remat)·n·C_send·(2·D·b + 4) + "
                f"n·C_send·2·D·b) = {cfg.L}·{mu}·({1 + cfg.remat}·{n}·"
                f"{C_send}·{2 * D * b + 4} + {n}·{C_send}·{2 * D * b})")
    else:
        per = fwd
        text = (f"all-to-all L·n·C_send·(2·D·b + 4) = {cfg.L}·{n}·{C_send}"
                f"·{2 * D * b + 4}")
    return cfg.L * mu * per, text


def dryrun_phase(sweep: dict, on_card: bool, power: str) -> None:
    """Phase 34: the dry run (`launch/dryrun.py`, `perf.py`, `report.py`).
    (a) collects the sweep started before the card phases and checks its
    40 records; (b) measures one serving cell's peak on the card with
    `perf.run(..., do_mem=True)`.  Launches no kernel."""
    import glob
    import shutil

    from repro_torch.configs import base as CB
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import perf as PF
    from repro_torch.launch import report as RP
    from repro_torch.launch import roofline as R
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import sharding as SH

    t_phase = time.perf_counter()
    counts0 = launch_counts()
    card = (f"{torch.cuda.get_device_name(0)}, {power}" if on_card
            else "cpu rehearsal")
    # ---- (a) the sweep ----
    proc = sweep["proc"]
    try:
        rc = proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT_S - (
            time.perf_counter() - sweep["t0"])))
    except subprocess.TimeoutExpired:
        proc.kill()
        raise AssertionError(f"the dry-run sweep ran past "
                             f"{DRYRUN_TIMEOUT_S} s")
    waited = time.perf_counter() - t_phase
    sweep["log"].close()
    log_path = os.path.join(sweep["out"], "sweep.log")
    wall = os.path.getmtime(log_path) - sweep["t_wall0"]
    with open(log_path) as f:
        text = f.read()
    lines = [ln for ln in text.splitlines()
             if ln[:4] in ("OK  ", "SKIP", "FAIL")]
    recs = {}
    for path in glob.glob(os.path.join(sweep["out"], "dryrun", "16x16",
                                       "*.json")):
        with open(path) as f:
            r = json.load(f)
        recs[(r["arch"], r["shape"])] = r
    counted = sum(r.get("count_s", 0.0) for r in recs.values())
    print(f"[34 sweep] `python -m repro_torch.launch.dryrun --all "
          f"--roofline` in a subprocess beside phases 3-33: exit {rc}, wall "
          f"{wall:.1f} s (its cells' count_s sum to {counted:.1f} s); phase "
          f"34 waited {waited:.1f} s for it; {len(lines)} lines: "
          f"{sum(ln.startswith('OK') for ln in lines)} OK, "
          f"{sum(ln.startswith('SKIP') for ln in lines)} SKIP, "
          f"{sum(ln.startswith('FAIL') for ln in lines)} FAIL", flush=True)
    if rc != 0:
        raise AssertionError(f"the dry-run sweep exited {rc}:\n"
                             f"{text[-4000:]}")
    cells = CB.cells(include_skips=True)
    if len(recs) != 40 or set(recs) != {c[:2] for c in cells}:
        raise AssertionError(f"the sweep wrote {len(recs)} records")
    axes = dict(dp="data", tp="model", ndp=16, ntp=16)
    n_ok = 0
    for arch, shape_name, ok, why in cells:
        r = recs[(arch, shape_name)]
        if r["skipped"] != (not ok) or r["skip_reason"] != why:
            raise AssertionError(f"{arch} x {shape_name}: skip "
                                 f"{r['skipped']} ({r['skip_reason']!r}), "
                                 f"the configs say {not ok} ({why!r})")
        if not ok:
            continue
        n_ok += 1
        cfg, shape = CB.get(arch), CB.SHAPES[shape_name]
        x = r["roofline"]
        if not r["cost_analysis"]["flops"] > 0:
            raise AssertionError(f"{arch} x {shape_name}: no products")
        if (x["model_flops_global"] != R.model_flops(cfg, shape, 16)
                or x["hbm_bytes_per_chip"] != R.analytic_hbm_bytes(
                    cfg, shape, axes)):
            raise AssertionError(f"{arch} x {shape_name}: the record's "
                                 f"analytic fields are not roofline.py's")
        if cfg.family == "moe":
            want, formula = moe_a2a_bytes(cfg, shape, axes)
            kind = "all-reduce" if shape.kind == "decode" else "all-to-all"
            got = r["collectives_in_module"]
            print(f"[34 moe] {arch} x {shape_name}: {kind} {got.get(kind, 0):,}"
                  f" bytes a device counted, {formula} = {want:,}", flush=True)
            if got != {kind: want}:
                raise AssertionError(f"{arch} x {shape_name}: collectives "
                                     f"{got}, the formula says {want}")
        elif r["collectives_in_module"]:
            raise AssertionError(f"{arch} x {shape_name}: a dense family "
                                 f"counted {r['collectives_in_module']}")
    if n_ok != 32:
        raise AssertionError(f"{n_ok} cells ran, not 32")
    # llama3-8b prefill_32k: the composition against one direct count
    cfg, shape = CB.get("llama3-8b"), CB.SHAPES["prefill_32k"]
    t0 = time.perf_counter()
    with DR.production_cells():
        mesh = make_production_mesh(device="meta")
        fn, in_sh, args, _ = DR.build_cell(cfg, shape, mesh,
                                           SH.mesh_axes(mesh))
        direct = R._count_cost(fn, in_sh, args, mesh)
    composed = recs[("llama3-8b", "prefill_32k")]["cost_analysis"]
    print(f"[34 compose] llama3-8b x prefill_32k on the 16 x 16 meta mesh: "
          f"composed fixed + 32·layer {composed['flops_global']:,} products"
          f", one count at full depth {direct.flops:,} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if composed["flops_global"] != direct.flops:
        raise AssertionError("the composed count is not the direct one")
    root = os.path.join(sweep["out"], "dryrun")
    for section in (RP.dryrun_table, RP.roofline_table):
        for row in section("16x16", root).splitlines():
            print(f"[34 report] {row}", flush=True)
    shutil.rmtree(sweep["out"], ignore_errors=True)
    # ---- (b) one serving cell's peak on the card ----
    arch, shape_name, over = MEM_CELL
    if on_card:
        t0 = time.perf_counter()
        rec = PF.run(arch, shape_name, over, "chip_smoke", True,
                     outdir=os.path.join(ROOT, "build", "chip_smoke_perf"))
        t_mem = time.perf_counter() - t0
        shutil.rmtree(os.path.join(ROOT, "build", "chip_smoke_perf"),
                      ignore_errors=True)
        print(f"[34 mem] {arch} x {shape_name} cut to "
              f"{', '.join(f'{k}={v}' for k, v in over)} at one card's axes"
              f": peak {rec['peak_bytes']:,} bytes ({rec['peak_gib']} GiB, "
              f"{rec['peak_source']}) beside the meta arguments "
              f"{rec['argument_bytes']:,} bytes ({rec['argument_gib']} GiB): "
              f"temporaries {rec['temp_gib']} GiB; roofline {rec['bound']} "
              f"t_step {1e3 * rec['t_step']:.3f} ms on the 16 x 16 mesh; "
              f"{t_mem:.1f} s ({card})", flush=True)
        if not rec["peak_bytes"] >= rec["argument_bytes"] > 0:
            raise AssertionError("the measured peak is below the arguments")
        if t_mem > 30.0:
            raise AssertionError(f"perf --mem took {t_mem:.1f} s (> 30 s)")
    else:
        print(f"[34 mem] skipped: `perf --mem` measures on a card ({card})",
              flush=True)
    launched = {k: v - counts0[k] for k, v in launch_counts().items()}
    if any(launched.values()):
        raise AssertionError(f"phase 34 launched a kernel: {launched}")
    print(f"[34 done] phase 34 in {time.perf_counter() - t_phase:.1f} s "
          f"({card})", flush=True)


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
    from concurrent.futures import ThreadPoolExecutor

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
    sweep = dryrun_sweep_start()        # phase 34 (a), beside the rest
    # phase 8's host-side ratings, made beside the build and phases 3–4
    # (which time nothing); phase 5 waits for them before it serves
    pool = ThreadPoolExecutor(max_workers=1)
    fit_job = pool.submit(fit_data, args)
    pool.shutdown(wait=False)
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
    t0 = time.perf_counter()
    fit_in = fit_job.result()
    print(f"[8 data] the fit's ratings made on the host in {fit_in[2]:.1f} "
          f"s beside phases 2-4; phase 5 waited {time.perf_counter() - t0:.1f}"
          f" s for them", flush=True)
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
    entries, ctx = fit_phases(args, fit_in, dev, on_card, power)
    kernels += entries
    kernels.append(encode_phase(sp, lsh, prng.PRNGKey(args.seed, device=dev),
                                sigs, dev, on_card, power))
    legacy_phase(ctx, dev)
    kernels.append(predict_phase(ctx, dev, on_card, power))
    octx = online_phase(args, ctx, cfg, dev, on_card, power)
    kernels.append(resil_phase(
        args, octx, dict(params=params, sp=sp, sigs=sigs, cfg=cfg,
                         p5=(st["p50_ms"], st["p99_ms"]), lo=ctx["lo"]),
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
    draws = DrawLog()
    draws.install()
    try:
        draws.phase = "23"
        lm_phase(args, dev, on_card, power)
        draws.phase = "24"
        seg24 = lm_train_phase(args, dev, on_card, power)
        draws.phase = "25"
        ssm_phase(args, dev, on_card, power)
        draws.phase = "26"
        moe_phase(args, dev, on_card, power)
        draws.phase = "27"
        moe_train_phase(args, dev, on_card, power)
        draws.phase = "28"
        encdec_vlm_phase(args, dev, on_card, power)
        draws.phase = "29"
        frontend_train_phase(args, dev, on_card, power)
        draws.phase = "30"
        arctic = bf16_phase(args, dev, on_card, power)
        draws.phase = "33"
        seg33 = mesh_phase(args, *arctic, dev, on_card, power)
        del arctic
        gc_collect(on_card)
        draws.phase = "31"
        bf16_train_phase(args, dev, on_card, power)
    finally:
        draws.uninstall()
    roofline_phase(draws, on_card, power)
    dryrun_phase(sweep, on_card, power)
    for k in kernels:        # phase 16's main path, phase 24's and 33's
        if k["name"] == "segment_add":
            print(f"[24 kernels] segment_add launches: phase 16 "
                  f"{k['launches']}, phase 24 {seg24}, phase 33 {seg33}",
                  flush=True)
            k["launches"] += seg24 + seg33
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
