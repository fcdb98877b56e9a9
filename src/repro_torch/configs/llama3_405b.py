"""llama3-405b — dense GQA, 128k vocab [arXiv:2407.21783]."""
from repro_torch.configs.base import ArchConfig, register

CFG = register(ArchConfig(
    name="llama3-405b", family="dense",
    L=126, d_model=16384, n_heads=128, n_kv=8, head_dim=128,
    d_ff=53248, vocab=128256, rope_theta=500_000.0,
    fsdp=True, seq_shard_acts=True, microbatches=8,
    param_dtype="bfloat16", moment_dtype="bfloat16", grad_dtype="bfloat16", query_chunk=512,
))
