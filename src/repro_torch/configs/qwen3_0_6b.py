"""qwen3-0.6b — dense GQA with qk_norm, 152k vocab [hf:Qwen/Qwen3-0.6B]."""
from repro_torch.configs.base import ArchConfig, register

CFG = register(ArchConfig(
    name="qwen3-0.6b", family="dense",
    L=28, d_model=1024, n_heads=16, n_kv=8, head_dim=128,
    d_ff=3072, vocab=151936, qk_norm=True, rope_theta=1_000_000.0,
    seq_shard_acts=True, tie_embeddings=True,
))
