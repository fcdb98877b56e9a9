"""Launch wrapper of the CUDA LSH bucket walk + dedup kernel
(`csrc/lsh_retrieve.cu`), the Hopper counterpart of the TPU kernel
`repro/kernels/lsh_retrieve/kernel.py::lsh_retrieve_topc`.

On CUDA tensors it launches the kernel or raises — it never falls back.
On CPU tensors it runs the plain version (`ref.lsh_retrieve_topc_ref`).
``LAUNCHES`` counts kernel launches, so a run can show that its main
path went through the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, KernelValueError, check_operand
from repro_torch.kernels.lsh_retrieve.ref import lsh_retrieve_topc_ref

LAUNCHES = 0
_MAX_SMEM = 232_448          # bytes of shared memory a block may use


def pool_width(I: int, cap: int, X: int) -> int:
    """The sort width: the next power of two of the pool I·cap + X."""
    return 1 << (I * cap + X - 1).bit_length()


def lsh_retrieve_topc(starts, lens, extra, ids_flat, exclude, *, C: int,
                      cap: int) -> torch.Tensor:
    """starts/lens [B, I] int32 window descriptors; extra [B, X] int32
    SENTINEL-padded appended ids; ids_flat [q·N + cap] int32
    (`padded_flat_ids`); exclude [E] int32 → cand [B, C] int32 unique ids,
    SENTINEL-padded, in hashed order (the `ref` contract)."""
    global LAUNCHES
    dev = starts.device
    if dev.type == "cpu":
        return lsh_retrieve_topc_ref(starts, lens, extra, ids_flat, exclude,
                                     C=C, cap=cap)
    if dev.type != "cuda":
        raise KernelValueError(f"lsh_retrieve_topc: unsupported device {dev}")
    for t, name, nd in ((starts, "starts", 2), (lens, "lens", 2),
                        (extra, "extra", 2), (ids_flat, "ids_flat", 1),
                        (exclude, "exclude", 1)):
        check_operand(t, name, torch.int32, nd, dev)
    B, I = starts.shape
    X, E = extra.shape[1], exclude.shape[0]
    if lens.shape != starts.shape or extra.shape[0] != B:
        raise KernelValueError(
            f"lsh_retrieve_topc: starts {tuple(starts.shape)}, "
            f"lens {tuple(lens.shape)} and extra "
            f"{tuple(extra.shape)} disagree")
    if cap < 1 or X < 1 or E < 1:
        raise KernelValueError("lsh_retrieve_topc: cap, X and E must be ≥ 1")
    W = I * cap + X
    if not 1 <= C <= W:
        raise KernelValueError(f"candidate budget C={C} must lie in [1, {W}]")
    Wp = pool_width(I, cap, X)
    if (2 * Wp + E) * 4 > _MAX_SMEM:
        raise KernelValueError(f"lsh_retrieve_topc: pool width {Wp} and {E} "
                               f"exclusions exceed a block's shared memory")
    out = torch.empty((B, C), dtype=torch.int32, device=dev)
    lib = _build.library()
    err = lib.lsh_retrieve_topc_launch(
        starts.data_ptr(), lens.data_ptr(), extra.data_ptr(),
        ids_flat.data_ptr(), exclude.data_ptr(), out.data_ptr(), B, I, X, E,
        C, cap, Wp, ids_flat.shape[0],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "lsh_retrieve_topc")
    LAUNCHES += 1
    return out
