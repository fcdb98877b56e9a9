"""llama3-8b — dense GQA, 128k vocab [arXiv:2407.21783]."""
from repro_torch.configs.base import ArchConfig, register

CFG = register(ArchConfig(
    name="llama3-8b", family="dense",
    L=32, d_model=4096, n_heads=32, n_kv=8, head_dim=128,
    d_ff=14336, vocab=128256, rope_theta=500_000.0,
    seq_shard_acts=True, microbatches=2,
))
