"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (`<name>/{kernel,ops,ref}.py`, the JAX package's split).

``kernel.py`` is the launch wrapper: on a CUDA tensor it launches the
kernel or raises, on a CPU tensor it runs the plain version in
``ref.py``.  ``ops.py`` is the serving-level function, whose ``impl``
picks the path: ``auto`` (the wrapper), ``cuda`` (the wrapper, and the
tensors must be on the card) or ``ref`` (the plain version on any
device — what the kernels are compared with).

A kernel that fails to build or launch, or a wrapper that refuses the
operands it is given, raises a `KernelError`: a caller that keeps a
fallback path (the service's exact `full_topn`) re-raises it, so the
plain version never answers for a failing kernel.
"""
from __future__ import annotations

import torch

IMPLS = ("auto", "cuda", "ref")


class KernelError(RuntimeError):
    """A CUDA kernel failed to build or launch, or its wrapper refused its
    operands."""


class KernelValueError(KernelError, ValueError):
    """A wrapper refused an operand's device, shape or value."""


class KernelTypeError(KernelError, TypeError):
    """A wrapper refused an operand's dtype."""


def pick(impl: str, device: torch.device, kernel, ref):
    """The function ``impl`` selects for tensors on ``device``."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "ref":
        return ref
    if impl == "cuda" and device.type != "cuda":
        raise KernelValueError(
            f"impl='cuda' needs tensors on a CUDA device, got "
            f"{device}")
    return kernel


def check_operand(t: torch.Tensor, name: str, dtype: torch.dtype,
                  ndim: int, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of rank
    ``ndim`` on ``device`` — what the kernels take."""
    if t.device != device:
        raise KernelValueError(f"{name}: expected a tensor on {device}, got "
                               f"{t.device}")
    if t.dtype != dtype:
        raise KernelTypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise KernelValueError(f"{name}: expected rank {ndim}, got shape "
                               f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise KernelValueError(f"{name}: the kernel needs a contiguous tensor")


def launch_counts() -> dict:
    """Each hand-written kernel's launch counter, by the kernel's name
    (what an entry point's ``--report`` line prints)."""
    from repro_torch.core import scatter
    from repro_torch.kernels.candidate_score import kernel as score
    from repro_torch.kernels.lsh_retrieve import kernel as lsh
    from repro_torch.kernels.mf_sgd import kernel as sgd
    from repro_torch.kernels.neighbor_predict import kernel as pred
    from repro_torch.kernels.simlsh_encode import kernel as enc
    return dict(lsh_retrieve=lsh.LAUNCHES, candidate_score=score.LAUNCHES,
                culsh_sgd=sgd.CULSH_LAUNCHES, mf_sgd=sgd.MF_LAUNCHES,
                simlsh_encode=enc.LAUNCHES, neighbor_predict=pred.LAUNCHES,
                segment_add=scatter.LAUNCHES)
