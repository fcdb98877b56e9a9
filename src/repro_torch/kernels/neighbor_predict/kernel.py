"""Launch wrapper of the CUDA fused Eq. (1) prediction kernel
(`csrc/neighbor_predict.cu`), the Hopper counterpart of the TPU kernel
`repro/kernels/neighbor_predict/kernel.py::neighbor_predict`.

On CUDA tensors it launches the kernel or raises — it never falls back.
On CPU tensors it runs the plain version (`ref.neighbor_predict_ref`).
``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, KernelValueError, check_operand
from repro_torch.kernels.neighbor_predict.ref import neighbor_predict_ref

__all__ = ["LAUNCHES", "neighbor_predict"]

LAUNCHES = 0


def neighbor_predict(u, v, w, c, resid, impl, bbar, sR, sN):
    """All inputs f32 and row-aligned on the batch dim B (u, v [B, F];
    w, c, resid, impl [B, K]; bbar, sR, sN [B]) → pred [B] f32.  Unlike
    the TPU kernel it needs no ``tile_b`` padding of B."""
    global LAUNCHES
    dev = u.device
    if dev.type == "cpu":
        return neighbor_predict_ref(u, v, w, c, resid, impl, bbar, sR, sN)
    if dev.type != "cuda":
        raise KernelValueError(f"neighbor_predict: unsupported device {dev}")
    check_operand(u, "u", torch.float32, 2, dev)
    check_operand(w, "w", torch.float32, 2, dev)
    B, F = u.shape
    K = w.shape[1]
    for name, t, shape in (("u", u, (B, F)), ("v", v, (B, F)),
                           ("w", w, (B, K)), ("c", c, (B, K)),
                           ("resid", resid, (B, K)), ("impl", impl, (B, K)),
                           ("bbar", bbar, (B,)), ("sR", sR, (B,)),
                           ("sN", sN, (B,))):
        check_operand(t, name, torch.float32, len(shape), dev)
        if tuple(t.shape) != shape:
            raise KernelValueError(
                f"neighbor_predict: {name} {tuple(t.shape)}, "
                f"expected {shape}")
    out = torch.empty((B,), dtype=torch.float32, device=dev)
    err = _build.library().neighbor_predict_launch(
        u.data_ptr(), v.data_ptr(), w.data_ptr(), c.data_ptr(),
        resid.data_ptr(), impl.data_ptr(), bbar.data_ptr(), sR.data_ptr(),
        sN.data_ptr(), out.data_ptr(), B, F, K,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "neighbor_predict")
    LAUNCHES += 1
    return out
