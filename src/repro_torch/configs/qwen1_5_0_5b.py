"""qwen1.5-0.5b — dense, QKV bias, 152k vocab [hf:Qwen/Qwen1.5-0.5B]."""
from repro_torch.configs.base import ArchConfig, register

CFG = register(ArchConfig(
    name="qwen1.5-0.5b", family="dense",
    L=24, d_model=1024, n_heads=16, n_kv=16, head_dim=64,
    d_ff=2816, vocab=151936, qkv_bias=True, rope_theta=1_000_000.0,
    seq_shard_acts=True, tie_embeddings=True,
))
