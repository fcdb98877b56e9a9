"""Config system: architecture + shape + parallelism descriptors
(`repro/configs/base.py`; the ten architecture files beside it are the
JAX package's, field for field).

Every assigned architecture is a frozen ``ArchConfig`` registered under its
public id (``--arch <id>``).  Shapes are the four global input geometries
from the brief; ``cells()`` enumerates the runnable (arch × shape) grid with
the documented skips (long_500k needs sub-quadratic attention).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

_REGISTRY: dict[str, "ArchConfig"] = {}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                # dense | moe | ssm | hybrid | encdec | vlm
    L: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0          # 0 → d_model // n_heads
    head_pad: int = 0          # pad q-head count for TP divisibility (perf)
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    moe_dense_ff: int = 0      # arctic-style parallel dense residual MLP
    moe_capacity: float = 2.0  # a2a dispatch capacity factor
    moe_ep2d: bool = False     # experts over data axes (no FSDP gathers)
    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    attn_every: int = 0        # hybrid: shared attn block before every k ssm layers
    # enc-dec
    enc_layers: int = 0        # family == encdec: L is decoder layers
    # frontend stub (audio/vision): inputs are precomputed embeddings
    frontend: str = "none"     # none | embed_stub
    # numerics / memory policy
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    moment_dtype: str = "float32"   # bf16 = optimizer-state compression
    grad_dtype: str = "float32"     # bf16 = gradient-accumulator compression
    remat: bool = True
    unroll_layers: bool = False     # python-loop layers (exact cost_analysis)
    fsdp: bool = False              # shard params/opt over data axis too
    seq_shard_acts: bool = False    # sequence-parallel stored activations
    microbatches: int = 1           # per train step (grad accumulation)
    query_chunk: int = 1024         # chunked attention block size
    attn_window: int = 0            # 0 = full causal; >0 = sliding window
    # paper technique at the LM softmax (beyond-paper integration)
    lsh_softmax: bool = False
    lsh_candidates: int = 16384

    @property
    def n_heads_padded(self) -> int:
        return max(self.n_heads, self.head_pad) if self.head_pad else self.n_heads

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def vocab_padded(self, model_shards: int = 16) -> int:
        v = self.vocab
        return ((v + model_shards - 1) // model_shards) * model_shards


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        # import side-effect registration
        import repro_torch.configs.all  # noqa: F401
    return _REGISTRY[name]


def names() -> list[str]:
    import repro_torch.configs.all  # noqa: F401
    return sorted(_REGISTRY)


def runnable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(ok, reason-if-skipped) — the documented cell skips."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k needs sub-quadratic attention (DESIGN.md §4)"
    return True, ""


def cells(include_skips: bool = False):
    import repro_torch.configs.all  # noqa: F401
    out = []
    for a in sorted(_REGISTRY):
        for s in SHAPES.values():
            ok, why = runnable(_REGISTRY[a], s)
            if ok or include_skips:
                out.append((a, s.name, ok, why))
    return out


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests."""
    return dataclasses.replace(
        cfg,
        L=min(cfg.L, 2 if cfg.family != "hybrid" else 4),
        d_model=128,
        n_heads=4,
        n_kv=min(cfg.n_kv, 4) if cfg.n_kv else 0,
        head_dim=32,
        d_ff=256,
        vocab=512,
        n_experts=min(cfg.n_experts, 4),
        moe_dense_ff=128 if cfg.moe_dense_ff else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_headdim=16,
        enc_layers=min(cfg.enc_layers, 2),
        attn_every=2 if cfg.attn_every else 0,
        microbatches=1,
        param_dtype="float32",
        moment_dtype="float32",
        grad_dtype="float32",
        fsdp=False,
        seq_shard_acts=False,
        query_chunk=64,
        lsh_candidates=64,
    )
