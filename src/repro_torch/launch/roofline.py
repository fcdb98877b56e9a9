"""Roofline terms for one H100 (`repro/launch/roofline.py`): the
analytic half (:260-386) and the count-based half that stands for its
compile-based one (:1-259).

**The analytic half.**  The three counts are plain arithmetic on a
config and the same as the reference's at the same ``axes`` (``ndp``,
``ntp``) and ``model_shards``: `param_counts` (a sum of ``numel`` over
the meta parameter tree, the moe family's inactive experts removed),
`model_flops` (6·N_active·tokens to train, 2·N_active·tokens to serve,
plus attention against the context) and `analytic_hbm_bytes` (a step's
device-memory traffic on one chip by documented formulas).  Only
``axes["ndp"]`` and ``axes["ntp"]`` are read, so any axes run without a
mesh.  `roofline` turns a cost (operations, bytes, collective bytes)
into times with the H100 SXM's own rates, from NVIDIA's H100 Tensor
Core GPU data sheet (SXM column): 989·10¹² dense bfloat16 operations/s,
3.35·10¹² bytes/s of HBM3 and 450·10⁹ bytes/s of NVLink a direction.
One card has no collective: its cells pass ``coll_bytes = 0``.

**An operation count without XLA.** `forward_flops` counts the port's
own forward and output logits on meta tensors with
`torch.utils.flop_counter.FlopCounterMode`, which adds 2·m·n·k for
every product (``mm``, ``bmm``, the ``einsum``s that lower to them) and
nothing for elementwise work.  For the dense family at batch B, sequence
S (tokens t = B·S), padded vocabulary V, width D, L layers of Hp padded
query heads, Hkv K/V heads of width hd and an MLP of width ff, with
queries in chunks of qc = min(query_chunk, S) padded to Sq = ⌈S/qc⌉·qc,
the count is (`dense_forward_flops`, exact):

    2·t·V·D                                  the one-hot embedding product
  + L·2·t·(D·Hp·hd + 2·D·Hkv·hd + Hp·hd·D + 3·D·ff)   the projections, MLP
  + L·4·B·Sq·S·Hp·hd                         scores and values, every
                                             query chunk against all S keys
  + 2·t·V·D                                  the output logits

and `model_flops` of the same prefill cell is 2·N·t + 2·L·B·S²·H·hd.
Term by term, count − model_flops is:

* ``tied_table`` = +2·t·V·D when the embeddings are tied: the table is
  one leaf of N but two products (the one-hot lookup and the logits);
  untied, each table is its own leaf and its own product, so the one-hot
  product is exactly what N counts for ``embed``;
* ``vector_params`` = −2·t·(L·(2·D + biases + q/k norms) + D): the norm
  scales and the q/k/v biases are in N but are no product;
* ``attention`` = L·(4·B·Sq·S·Hp·hd − 2·B·S²·H·hd): `model_flops`
  counts the causal half of the S×S square for H heads, the port's
  chunked attention multiplies the whole masked square, over padded
  query chunks and padded heads.

llama3-8b at B 1 × S 128: 2.0643·10¹² counted, of which the products
without the logits are 1.9298·10¹² (2·N·t = 2.0557·10¹²).  Off a mesh
the moe family cannot be counted this way (`moe_dense_ref` reads the
group bounds to the host); on a mesh its dispatch has static shapes and
counts like the rest.

**The count-based half** (`extract_cost` and its helpers).  The
reference compiles each cell with XLA and reads `cost_analysis()` and
the collectives of the HLO text; neither exists here.  `_count_cost`
(the reference's `_compile_cost`) runs the cell's function once on meta
tensors on a mesh of logical cells, under `FlopCounterMode` and
`launch/mesh.py::count_collectives`.  `extract_cost` keeps the
reference's composition: probes at L1 and L2 layers (the hybrid's
group marginals and its partial group ``Lpart``), ``layer = C(L2) −
C(L1)``, ``fixed = C(L1) − layer``, ``fixed + L·layer``, × µ, + the
optimiser.  Where it differs:

* **per-chip operations = the mesh-wide count / nchips.**  The port's
  single-controller program does each cell's share once, so this is
  the mean over the cells; XLA's is one device's post-SPMD count.  The
  composition runs on the mesh-wide integers (``flops_global``), so it
  is exact; the division comes last.
* **products only.**  `FlopCounterMode`'s rule (phase 32's, and the
  one the tensor-core peak counts); XLA adds elementwise work.  Adam is
  elementwise, so `_opt_cost` counts 0.
* **no `_attn_chunk_correction`.**  XLA costs a ``lax.map`` body once;
  the port counts every query chunk already.  The function is ported
  for the parity of its value, and not applied.
* **``coll_bytes == coll_bytes_raw``.**  The port moves bfloat16 at its
  own width; `bf16_coll_correction` (XLA-CPU's float32 width) is not
  applied.
* **``bytes_xla_upper`` is None**: there is no XLA byte count.  The
  bytes term is `analytic_hbm_bytes`, as in the reference.
* **the dense families' GSPMD collectives count 0.**  The reference's
  FSDP all-gathers and gradient reduce-scatters are XLA's; the port
  checks those layouts (`sharding.constrain`) and moves nothing.  The
  counted collectives are the moe dispatch's all-to-alls (forward, the
  remat's recompute of the forward, and backward) and the replicated
  path's all-reduce.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.launch import specs
from repro_torch.launch.mesh import count_collectives, use_mesh
from repro_torch.models import lm, steps
from repro_torch.models import sharding as SH
from repro_torch.models import ssm as SSM

PEAK_FLOPS = 989e12          # H100 SXM dense bfloat16 (data sheet)
HBM_BW = 3.35e12             # H100 SXM HBM3 bytes/s (data sheet)
NVLINK_BW = 450e9            # H100 SXM NVLink bytes/s a direction (data sheet)
ONE_CARD = {"ndp": 1, "ntp": 1}


def _dtype_bytes(name: str) -> int:
    return {"float32": 4, "bfloat16": 2, "float16": 2}.get(name, 4)


def analytic_hbm_bytes(cfg: ArchConfig, shape: ShapeSpec, axes) -> float:
    """Per-chip device-memory bytes for one step (the reference's
    formulas, term for term)."""
    nchips = axes["ndp"] * axes["ntp"]
    total, active = param_counts(cfg, axes["ntp"])
    pb = _dtype_bytes(cfg.param_dtype)
    mb = _dtype_bytes(cfg.moment_dtype)
    gb = _dtype_bytes(cfg.grad_dtype)
    mu = max(1, cfg.microbatches) if shape.kind == "train" else 1
    B, S = shape.global_batch, shape.seq_len
    tokens_local = B * S / axes["ndp"]
    D = cfg.d_model
    act_b = _dtype_bytes(cfg.dtype)
    Lh = cfg.L if cfg.family != "encdec" else cfg.L + cfg.enc_layers

    if shape.kind == "train":
        # params: forward and backward read per microbatch
        p_shard = total * pb / nchips
        t = 2 * mu * p_shard
        # grads: write + read of the accumulator per microbatch + final read
        t += (2 * mu + 1) * total * gb / nchips
        # optimizer: read m, v + write m, v + read/write params
        t += total * (2 * mb * 2 + 2 * pb) / nchips
        # activations: the remat carry per layer (write + 2 reads)
        sp_div = axes["ntp"] if cfg.seq_shard_acts else 1
        t += 3 * Lh * tokens_local * D * act_b / sp_div
        # logits: float32 write + read, vocab-sharded
        t += 2 * tokens_local * cfg.vocab_padded(axes["ntp"]) / axes["ntp"] * 4
        return t
    if shape.kind == "prefill":
        p_shard = total * pb / nchips
        t = p_shard                                         # one param sweep
        t += 2 * Lh * tokens_local * D * act_b              # acts write+read
        if cfg.n_heads:                                     # KV cache write
            t += 2 * Lh * tokens_local * cfg.n_kv * cfg.hd * 2 / axes["ntp"]
        t += tokens_local / S * cfg.vocab_padded(axes["ntp"]) / axes["ntp"] * 4
        return t
    # decode: param sweep + the whole K/V or state read + tiny activations
    p_shard = active * pb / nchips
    t = p_shard
    B_loc = max(1, B // axes["ndp"])
    if cfg.family in ("dense", "moe", "vlm", "encdec"):
        kv = cfg.L * B_loc * S * cfg.n_kv * cfg.hd * 2 * 2  # k + v bf16
        t += kv / axes["ntp"]                               # T- or H-sharded
    if cfg.family in ("ssm", "hybrid"):
        H = max(1, SSM_n_heads(cfg))
        t += cfg.L * B_loc * H * cfg.ssm_headdim * cfg.ssm_state * 4 \
            / min(axes["ntp"], H)
        if cfg.family == "hybrid":
            napp = -(-cfg.L // cfg.attn_every)
            Tw = min(S, 8192 if S >= 100_000 else S)
            t += napp * B_loc * Tw * cfg.n_kv * cfg.hd * 2 * 2 \
                / min(axes["ntp"], cfg.n_kv)
    t += B_loc * D * Lh * 2 * 4                             # per-layer io
    return t


def SSM_n_heads(cfg: ArchConfig) -> int:
    return SSM.n_heads(cfg) if cfg.ssm_state else 0


def bf16_coll_correction(cfg: ArchConfig) -> float:
    """The reference halves the collective bytes it parses from XLA-CPU's
    HLO at bfloat16 compute (that backend moves bfloat16 at float32
    width); kept for the records that carry such counts."""
    return 0.5 if cfg.dtype == "bfloat16" else 1.0


def param_counts(cfg: ArchConfig, model_shards: int = 16):
    """(total, active) parameters of the meta tree; active leaves out the
    experts a token does not reach (the moe family)."""
    params = specs.param_specs(cfg, model_shards)
    total = sum(x.numel() for x in T.leaves(params))
    inactive = 0
    if cfg.family == "moe" and cfg.n_experts:
        expert = sum(params["layers"][k].numel() for k in ("w1", "w2", "w3"))
        inactive = int(expert * (1 - cfg.moe_top_k / cfg.n_experts))
    return total, total - inactive


def model_flops(cfg: ArchConfig, shape: ShapeSpec, model_shards: int = 16):
    """Analytic 'useful' operations (global): 6·N_active·tokens to train,
    2·N_active·tokens (+ attention against the K/V or state) to serve."""
    total, active = param_counts(cfg, model_shards)
    B, S = shape.global_batch, shape.seq_len
    hd = cfg.hd if cfg.n_heads else 0
    if shape.kind == "train":
        flops = 6.0 * active * B * S
        if cfg.n_heads:
            flops += 3.0 * 4.0 * cfg.L * B * S * S * cfg.n_heads * hd * 0.5
        return flops
    if shape.kind == "prefill":
        flops = 2.0 * active * B * S
        if cfg.n_heads:
            flops += 4.0 * cfg.L * B * S * S * cfg.n_heads * hd * 0.5
        return flops
    # decode: one token against T of context
    flops = 2.0 * active * B
    if cfg.family in ("dense", "moe", "vlm", "encdec"):
        flops += 4.0 * cfg.L * B * S * cfg.n_heads * hd
    if cfg.family == "hybrid":
        napp = -(-cfg.L // cfg.attn_every)
        T_eff = min(S, 8192 if S >= 100_000 else S)
        flops += 4.0 * napp * B * T_eff * cfg.n_heads * hd
    return flops


def roofline(cost: dict, nchips: int) -> dict:
    """Times of a cost ``{"flops", "bytes", "coll_bytes"}`` on one H100
    and the term that bounds it (ties go to compute, then memory)."""
    t_comp = cost["flops"] / PEAK_FLOPS
    t_mem = cost["bytes"] / HBM_BW
    t_coll = cost["coll_bytes"] / NVLINK_BW
    dom = max(("compute", t_comp), ("memory", t_mem), ("collective", t_coll),
              key=lambda kv: kv[1])
    return dict(t_compute=t_comp, t_memory=t_mem, t_collective=t_coll,
                bound=dom[0], t_step=max(t_comp, t_mem, t_coll))


def analytic_cell(cfg: ArchConfig, shape: ShapeSpec, axes=ONE_CARD) -> dict:
    """One cell's analytic record at ``axes``: `model_flops` and
    `analytic_hbm_bytes` with ``model_shards = ntp``, and `roofline` of
    the per-chip share of the operations with no collective bytes."""
    nchips = axes["ndp"] * axes["ntp"]
    flops = model_flops(cfg, shape, axes["ntp"])
    nbytes = analytic_hbm_bytes(cfg, shape, axes)
    return dict(model_flops=flops, hbm_bytes=nbytes, **roofline(
        dict(flops=flops / nchips, bytes=nbytes, coll_bytes=0.0), nchips))


def forward_flops(cfg: ArchConfig, batch: dict, model_shards: int = 16) -> int:
    """`FlopCounterMode`'s count of ``lm.forward`` and `steps.logits_of`
    on the meta parameter tree and the meta ``batch``: no value is
    computed and nothing is allocated."""
    p = specs.param_specs(cfg, model_shards)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        steps.logits_of(cfg, p, lm.forward(cfg, p, batch))
    return counter.get_total_flops()


def dense_forward_flops(cfg: ArchConfig, B: int, S: int,
                        model_shards: int = 16) -> dict:
    """The module docstring's derivation for the dense family: ``total``
    (what `forward_flops` counts) and its three differences from the
    prefill cell's `model_flops`, so that ``total = model_flops +
    tied_table + vector_params + attention``."""
    if cfg.family != "dense":
        raise ValueError(f"{cfg.name}: the derivation is the dense family's")
    t, V, D = B * S, cfg.vocab_padded(model_shards), cfg.d_model
    Hp, H, hd, kv, ff, L = (cfg.n_heads_padded, cfg.n_heads, cfg.hd,
                            cfg.n_kv, cfg.d_ff, cfg.L)
    qc = min(cfg.query_chunk, S)
    Sq = -(-S // qc) * qc
    layer = 2 * t * (D * Hp * hd + 2 * D * kv * hd + Hp * hd * D + 3 * D * ff)
    total = 2 * t * V * D + L * (layer + 4 * B * Sq * S * Hp * hd) \
        + 2 * t * V * D
    vec = 2 * D + (Hp * hd + 2 * kv * hd if cfg.qkv_bias else 0) \
        + (2 * hd if cfg.qk_norm else 0)
    return dict(total=total,
                tied_table=2 * t * V * D if cfg.tie_embeddings else 0,
                vector_params=-2 * t * (L * vec + D),
                attention=L * (4 * B * Sq * S * Hp * hd
                               - 2 * B * S * S * H * hd))


# --------------------------------------------------------------------------
# count-based cost terms (the reference's compile-based half)
# --------------------------------------------------------------------------


def collective_bytes(schedule) -> dict:
    """Per-kind output bytes of the collectives (per device): the
    reference's, over a `count_collectives` list in place of HLO text."""
    out = {}
    for kind, nbytes in schedule:
        out[kind] = out.get(kind, 0) + nbytes
    return out


def collective_schedule(schedule, limit: int = 2000) -> list:
    """(kind, bytes) in program order — the dry run's collective
    schedule."""
    return [(kind, nbytes) for kind, nbytes in schedule[:limit]]


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll: dict = dataclasses.field(default_factory=dict)

    def __add__(self, o):
        coll = dict(self.coll)
        for k, v in o.coll.items():
            coll[k] = coll.get(k, 0) + v
        return Cost(self.flops + o.flops, self.bytes + o.bytes, coll)

    def __sub__(self, o):
        coll = dict(self.coll)
        for k, v in o.coll.items():
            coll[k] = coll.get(k, 0) - v
        return Cost(self.flops - o.flops, self.bytes - o.bytes, coll)

    def __mul__(self, s):
        return Cost(self.flops * s, self.bytes * s,
                    {k: v * s for k, v in self.coll.items()})

    @property
    def coll_bytes(self):
        return sum(self.coll.values())


def _count_cost(fn, in_shardings, args, mesh, schedule=None) -> Cost:
    """The reference's `_compile_cost`: ``fn(*args)`` once on meta
    tensors under `use_mesh`, `FlopCounterMode` and `count_collectives`
    → Cost(the mesh-wide products (an int), 0 bytes, per-device
    collective bytes by kind).  Each argument's layout is checked against
    its sharding first (`shard_shape` raises where a sharded dimension
    does not divide), as the compile would.  ``schedule``, a list, gets
    the counted ``(kind, bytes)`` in program order."""
    for leaf, sh in zip(T.leaves(args), T.leaves(in_shardings),
                        strict=True):
        sh.shard_shape(getattr(leaf, "shape", ()))
    with use_mesh(mesh), FlopCounterMode(display=False) as counter, \
            count_collectives() as log:
        fn(*args)
    if schedule is not None:
        schedule.extend(log)
    return Cost(counter.get_total_flops(), 0, collective_bytes(log))


MAX_COST_QC = 2048   # keep chunk tensors < 2^31 elements (XLA int32 paths)


def _cost_cfg(cfg: ArchConfig, L: int, enc: int | None = None,
              shape_seq: int = 0) -> ArchConfig:
    qc = min(max(cfg.query_chunk, shape_seq or 1), MAX_COST_QC)
    return dataclasses.replace(
        cfg, L=L,
        enc_layers=enc if enc is not None else cfg.enc_layers,
        unroll_layers=True, microbatches=1,
        query_chunk=qc,
    )


def _attn_chunk_correction(cfg: ArchConfig, shape: ShapeSpec, axes) -> float:
    """The reference's FLOPs per layer of the attention chunks that XLA's
    `cost_analysis` does not count (a ``lax.map`` body is costed once):
    per chunk ≈ B_loc·H_loc·qc·T·(4·hd + 8).  The port counts every
    chunk, so `extract_cost` does not add it."""
    S = shape.seq_len
    qc = min(max(cfg.query_chunk, S), MAX_COST_QC)
    if shape.kind == "decode" or S <= qc or not cfg.n_heads:
        return 0.0
    nchunks = -(-S // qc)
    B_loc = max(1, shape.global_batch // axes["ndp"])
    H_loc = max(1, cfg.n_heads // axes["ntp"])
    per_chunk = B_loc * H_loc * qc * S * (4.0 * cfg.hd + 8.0)
    n_attn = 3 if cfg.family == "encdec" else 1
    fwd = (nchunks - 1) * per_chunk * n_attn
    # train backward recomputes (remat) + differentiates: ≈ 3.5× fwd total
    return fwd * (3.5 if shape.kind == "train" else 1.0)


def _mk_args(cfg, shape, mesh, axes, kind):
    """(fn, in_shardings, args) for one cost count: one microbatch's
    gradient (train), the prefill or a decode step, on meta tensors."""
    params = specs.param_specs(cfg, axes["ntp"])
    psp = SH.to_named(SH.param_specs(cfg, params, axes), mesh)
    if kind == "train":
        b = specs.batch_specs_for(cfg, shape)
        bsp = SH.to_named(SH.batch_specs(cfg, b, axes), mesh)

        def fwdbwd(p, batch):
            return steps.value_and_grad(cfg, p, batch, mesh, axes)[1]

        return fwdbwd, (psp, bsp), (params, b)
    if kind == "prefill":
        b = specs.prefill_specs_for(cfg, shape)
        bsp = SH.to_named(SH.batch_specs(cfg, b, axes), mesh)
        return steps.make_prefill(cfg, mesh, axes), (psp, bsp), (params, b)
    cache, tokens = specs.decode_specs_for(cfg, shape)
    csp = SH.to_named(SH.cache_specs(cfg, cache, axes), mesh)
    tsp = SH.to_named(
        SH.batch_specs(cfg, {"tokens": tokens}, axes), mesh)["tokens"]
    fn = steps.make_decode_step(cfg, mesh, axes)
    return fn, (psp, csp, tsp), (params, cache, tokens)


def _opt_cost(cfg, mesh, axes) -> Cost:
    """Adam over the whole meta tree: elementwise, so 0 products."""
    params = specs.param_specs(cfg, axes["ntp"])
    psp = SH.to_named(SH.param_specs(cfg, params, axes), mesh)
    opt = steps.init_opt(cfg, params)
    osp = dict(m=psp, v=psp, count=SH.to_named(SH.P(), mesh))

    def upd(p, g, o):
        p2, o2, _ = steps.adam_update(cfg, p, g, o)
        return p2, o2

    return _count_cost(upd, (psp, psp, osp), (params, params, opt), mesh)


def _layer_counts(cfg: ArchConfig):
    """(L1, L2, extra) probe sizes per family."""
    if cfg.family == "hybrid":
        k = cfg.attn_every
        return k, 2 * k, cfg.L % k or None     # group marginals (+ partial)
    return 1, 2, None


def micro_shape(shape: ShapeSpec, cfg: ArchConfig) -> ShapeSpec:
    mu = max(1, cfg.microbatches) if shape.kind == "train" else 1
    return dataclasses.replace(shape,
                               global_batch=max(1, shape.global_batch // mu))


def extract_cost(cfg: ArchConfig, shape: ShapeSpec, mesh, axes) -> dict:
    """Composed per-device cost for the full (arch × shape) cell, by the
    reference's composition on counted probes (module docstring).  Beside
    the reference's keys: ``flops_global`` (the mesh-wide products, an
    int) and ``schedule`` (the L1 probe's counted collectives in program
    order)."""
    kind = shape.kind
    mshape = micro_shape(shape, cfg)
    mu = max(1, cfg.microbatches) if kind == "train" else 1
    L1, L2, Lpart = _layer_counts(cfg)
    schedule: list = []

    def cost_at(L, sched=None):
        c = _cost_cfg(cfg, L, enc=(L if cfg.family == "encdec" else None),
                      shape_seq=mshape.seq_len)
        return _count_cost(*_mk_args(c, mshape, mesh, axes, kind), mesh=mesh,
                           schedule=sched)

    C1, C2 = cost_at(L1, schedule), cost_at(L2)
    layer = C2 - C1
    fixed = C1 - layer
    if cfg.family == "hybrid":
        total = fixed + layer * (cfg.L // cfg.attn_every)
        if Lpart:
            total = total + (cost_at(Lpart) - fixed)
    else:
        # encdec: enc and dec scale together in the probes (enc=dec=L)
        total = fixed + layer * cfg.L
    total = total * mu
    if kind == "train":
        total = total + _opt_cost(cfg, mesh, axes)
    nchips = mesh.size
    return dict(flops=total.flops / nchips,
                flops_global=total.flops,
                bytes=analytic_hbm_bytes(cfg, shape, axes),
                bytes_xla_upper=None,
                coll=total.coll,
                coll_bytes=total.coll_bytes,
                coll_bytes_raw=total.coll_bytes,
                per_layer_flops=layer.flops / nchips,
                fixed_flops=fixed.flops / nchips,
                schedule=schedule)
