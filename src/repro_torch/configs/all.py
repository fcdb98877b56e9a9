"""Import side-effect registration of every assigned architecture."""
from repro_torch.configs import (  # noqa: F401
    arctic_480b,
    dbrx_132b,
    llama3_405b,
    llama3_8b,
    llava_next_mistral_7b,
    mamba2_370m,
    qwen1_5_0_5b,
    qwen3_0_6b,
    seamless_m4t_large_v2,
    zamba2_7b,
)
