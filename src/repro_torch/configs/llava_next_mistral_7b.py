"""llava-next-mistral-7b — Mistral-7B backbone, anyres vision stub
[hf:llava-hf/llava-v1.6-mistral-7b-hf].  Patch embeddings are a stub input."""
from repro_torch.configs.base import ArchConfig, register

CFG = register(ArchConfig(
    name="llava-next-mistral-7b", family="vlm",
    L=32, d_model=4096, n_heads=32, n_kv=8, head_dim=128,
    d_ff=14336, vocab=32000, frontend="embed_stub", rope_theta=10_000.0,
    seq_shard_acts=True, microbatches=2,
))
