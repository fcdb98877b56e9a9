"""Launch wrapper of the CUDA simLSH accumulator kernel
(`csrc/simlsh_encode.cu`), the Hopper counterpart of the TPU kernel
`repro/kernels/simlsh_encode/kernel.py::simlsh_encode`.

On CUDA tensors it launches the kernel or raises — it never falls back.
On CPU tensors it runs the plain version (`ref.simlsh_encode_ref`).
``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, KernelValueError, check_operand
from repro_torch.kernels.simlsh_encode.ref import simlsh_encode_ref

__all__ = ["LAUNCHES", "simlsh_encode"]

LAUNCHES = 0
MAX_BITS = 32                # one lane per signature bit


def simlsh_encode(psi, phi):
    """psi [N, deg] f32 (Ψ weights, 0 at padding), phi [N, deg, bits] f32
    (±1 rows of each item's raters) → S [N, bits] f32, the Eq. (3)
    pre-sign accumulator.  Unlike the TPU kernel it needs no ``tile_n``
    padding of N."""
    global LAUNCHES
    dev = psi.device
    if dev.type == "cpu":
        return simlsh_encode_ref(psi, phi)
    if dev.type != "cuda":
        raise KernelValueError(f"simlsh_encode: unsupported device {dev}")
    check_operand(psi, "psi", torch.float32, 2, dev)
    check_operand(phi, "phi", torch.float32, 3, dev)
    N, deg = psi.shape
    bits = phi.shape[2]
    if phi.shape[:2] != (N, deg) or not 0 < bits <= MAX_BITS:
        raise KernelValueError(
            f"simlsh_encode: psi {tuple(psi.shape)} and phi "
            f"{tuple(phi.shape)} disagree, or bits > "
            f"{MAX_BITS}")
    out = torch.empty((N, bits), dtype=torch.float32, device=dev)
    err = _build.library().simlsh_encode_launch(
        psi.data_ptr(), phi.data_ptr(), out.data_ptr(), N, deg, bits,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "simlsh_encode")
    LAUNCHES += 1
    return out
