"""seamless-m4t-large-v2 — enc-dec, audio frontend stub, 256k vocab
[arXiv:2308.11596].  Encoder inputs are precomputed frame embeddings."""
from repro_torch.configs.base import ArchConfig, register

CFG = register(ArchConfig(
    name="seamless-m4t-large-v2", family="encdec",
    L=24, enc_layers=24, d_model=1024, n_heads=16, n_kv=16, head_dim=64,
    d_ff=8192, vocab=256206, frontend="embed_stub", rope_theta=10_000.0,
    seq_shard_acts=True,
))
