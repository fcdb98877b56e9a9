"""zamba2-7b — Mamba2 backbone + shared attention blocks [arXiv:2411.15242]."""
from repro_torch.configs.base import ArchConfig, register

CFG = register(ArchConfig(
    name="zamba2-7b", family="hybrid",
    L=81, d_model=3584, n_heads=32, n_kv=32, head_dim=112,
    d_ff=14336, vocab=32000,
    ssm_state=64, ssm_expand=2, ssm_headdim=64, attn_every=6,
    seq_shard_acts=True, microbatches=2,
))
