"""arctic-480b — 128-expert top-2 MoE + dense residual MLP
[hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.configs.base import ArchConfig, register

CFG = register(ArchConfig(
    name="arctic-480b", family="moe",
    L=35, d_model=7168, n_heads=56, n_kv=8, head_dim=128,
    d_ff=4864, vocab=32000, n_experts=128, moe_top_k=2, moe_dense_ff=4864,
    fsdp=True, seq_shard_acts=True, microbatches=8,
    param_dtype="bfloat16", moment_dtype="bfloat16", grad_dtype="bfloat16", query_chunk=512,
))
