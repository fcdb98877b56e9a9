"""dbrx-132b — 16-expert top-4 fine-grained MoE [hf:databricks/dbrx-base]."""
from repro_torch.configs.base import ArchConfig, register

CFG = register(ArchConfig(
    name="dbrx-132b", family="moe",
    L=40, d_model=6144, n_heads=48, n_kv=8, head_dim=128,
    d_ff=10752, vocab=100352, n_experts=16, moe_top_k=4,
    fsdp=True, seq_shard_acts=True, microbatches=4,
    moment_dtype="bfloat16", query_chunk=512,
))
