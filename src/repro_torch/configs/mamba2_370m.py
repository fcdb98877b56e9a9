"""mamba2-370m — attention-free SSD state-space model [arXiv:2405.21060]."""
from repro_torch.configs.base import ArchConfig, register

CFG = register(ArchConfig(
    name="mamba2-370m", family="ssm",
    L=48, d_model=1024, n_heads=0, n_kv=0, d_ff=0, vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64,
    seq_shard_acts=True,
))
