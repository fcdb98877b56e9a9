"""PyTorch/CUDA port of the LSH-aggregated neighbourhood MF system.

The package mirrors the layout and names of the JAX package `repro`, so
each module's counterpart is found by path (`repro_torch/serve/index.py`
↔ `repro/serve/index.py`).  It imports torch and numpy only — never JAX
and never `repro` — and its accelerator hot path runs on hand-written
CUDA kernels for Hopper (`repro_torch/csrc/`).

Entry points (`build_index`, `encode`, `RecsysService`, the `convert`
helpers) run on ``cuda`` unless the caller passes ``device="cpu"``; on
the CPU every kernel wrapper runs its plain PyTorch version.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
