"""Launch wrappers of the CUDA fused SGD steps (`csrc/culsh_sgd.cu`,
`csrc/mf_sgd.cu`), the Hopper counterparts of the TPU kernels
`repro/kernels/mf_sgd/kernel.py::culsh_sgd_step` and `::mf_sgd_step`.

The CULSH-MF kernel does the whole step of a conflict-free batch in one
cooperative launch: it reads the plane rows and the neighbour baselines
b̂[J^K[j]] by id, meets the whole grid at a barrier, and writes the new
rows back into the planes (the gather → step → delta scatter of
`ref.apply_culsh_sgd_ref`).  `culsh_sgd_tier` validates a schedule tier's
operands once and returns a step function that is one ctypes call per
batch (the epoch loop); `culsh_sgd_batch` runs one `Batch`.
`mf_sgd_step` stays a tile kernel: tiles in, updated tiles out, the
gathers and the scatter in `ops.py`.

On CUDA tensors a wrapper launches its kernel or raises — it never falls
back; on CPU tensors it runs the plain version in `ref.py`.
``CULSH_LAUNCHES`` and ``MF_LAUNCHES`` count kernel launches.  ``hp`` is
a device tensor built once per epoch, so a launch reads no scalar from
the host.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.model import Batch, PackedParams, slice_batch
from repro_torch.kernels import _build, check_operand
from repro_torch.kernels.mf_sgd.ref import apply_culsh_sgd_ref, mf_sgd_step_ref

__all__ = ["CULSH_LAUNCHES", "MF_LAUNCHES", "culsh_sgd_batch",
           "culsh_sgd_tier", "mf_sgd_step"]

CULSH_LAUNCHES = 0
MF_LAUNCHES = 0
_CULSH_WARPS = 2                        # slots per block (csrc kThreads / 32)


class _CulshArgs(ctypes.Structure):
    """`CulshArgs` of `csrc/culsh_sgd.cu`."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "row", "col", "i", "j", "r", "nb", "rnb", "expl", "valid", "hp",
        "stream")] + [(n, ctypes.c_int) for n in ("width", "F", "K", "bce")])


def _check_vectors(dev, B, **vecs):
    for name, t in vecs.items():
        check_operand(t, name, torch.float32, 1, dev)
        if t.shape[0] != B:
            raise ValueError(f"{name}: expected [{B}], got {tuple(t.shape)}")


def _culsh_args(pp: PackedParams, i, j, r, nb, rnb, expl, valid, hp, *,
                width: int, end: int, bce: bool) -> _CulshArgs:
    """Validate the operands of the fused step on the card and pack them:
    the planes, the triples' [P] and [P, K] arrays (a window of ``width``
    slots must fit below ``end`` ≤ P), the [n, width] slot masks and the
    [13] hyper vector.  Raises on anything the kernel does not take,
    including a batch the card cannot hold as one cooperative grid."""
    dev = pp.row.device
    if dev.type != "cuda":
        raise ValueError(f"culsh_sgd: unsupported device {dev}")
    F, K = pp.F, pp.K
    if F < 1 or K < 0:
        raise ValueError(f"culsh_sgd: F={F}, K={K}")
    check_operand(pp.row, "row", torch.float32, 2, dev)
    check_operand(pp.col, "col", torch.float32, 2, dev)
    if pp.row.shape[1] != F + 1 or pp.col.shape[1] != F + 2 * K + 1:
        raise ValueError(f"culsh_sgd: planes {tuple(pp.row.shape)}, "
                         f"{tuple(pp.col.shape)} disagree with F={F}, K={K}")
    for name, t, dtype in (("i", i, torch.int32), ("j", j, torch.int32),
                           ("r", r, torch.float32)):
        check_operand(t, name, dtype, 1, dev)
    P = i.shape[0]
    for name, t, dtype in (("nb", nb, torch.int32), ("rnb", rnb,
                                                     torch.float32),
                           ("expl", expl, torch.float32)):
        check_operand(t, name, dtype, 2, dev)
        if t.shape != (P, K):
            raise ValueError(f"culsh_sgd: {name} {tuple(t.shape)} disagrees "
                             f"with [{P}, {K}]")
    if j.shape[0] != P or r.shape[0] != P:
        raise ValueError(f"culsh_sgd: i, j, r of lengths {P}, {j.shape[0]}, "
                         f"{r.shape[0]} disagree")
    if end > P:
        raise ValueError(f"culsh_sgd: a window ends at {end}, past the "
                         f"{P} triples")
    check_operand(valid, "valid", torch.float32, 2, dev)
    if valid.shape[1] != width:
        raise ValueError(f"culsh_sgd: valid {tuple(valid.shape)} disagrees "
                         f"with width {width}")
    _check_vectors(dev, 13, hp=hp)
    lib = _build.library()
    with torch.cuda.device(dev):
        cap = lib.culsh_sgd_capacity(F, K, int(bce))
    if cap < 0:
        raise RuntimeError(f"culsh_sgd: occupancy query failed ({cap})")
    blocks = -(-width // _CULSH_WARPS)
    if blocks > cap:
        raise ValueError(f"culsh_sgd: a batch of {width} slots needs {blocks} "
                         f"co-resident blocks; the card holds {cap}")
    return _CulshArgs(
        pp.row.data_ptr(), pp.col.data_ptr(), i.data_ptr(), j.data_ptr(),
        r.data_ptr(), nb.data_ptr(), rnb.data_ptr(), expl.data_ptr(),
        valid.data_ptr(), hp.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, width, F, K, int(bce))


class _CulshTier:
    """The step function of `culsh_sgd_tier` on the card: the validated
    operands in a `_CulshArgs`, one ctypes call per batch."""

    def __init__(self, args: _CulshArgs):
        self.args = args
        self._ptr = ctypes.addressof(args)
        self._launch = _build.library().culsh_sgd_launch

    def __call__(self, start: int, k: int) -> None:
        global CULSH_LAUNCHES
        err = self._launch(self._ptr, start, k)
        if err:
            _build.check(err, "culsh_sgd")
        CULSH_LAUNCHES += 1


def culsh_sgd_tier(pp: PackedParams, sd, valid: torch.Tensor,
                   hp: torch.Tensor, *, width: int, starts: np.ndarray,
                   bce: bool = False):
    """A step function for one conflict-free tier of the schedule:
    ``step(start, k)`` runs the fused CULSH-MF step (paper Alg. 3, Eq. 5)
    of the batch of ``width`` slots at offset ``start`` of the
    `ScheduledData` ``sd``, whose slot mask is ``valid[k]``, updating the
    planes of ``pp`` in place.  ``starts`` are the tier's host offsets.

    On the card every operand is validated here, once — dtypes,
    contiguity, device, every window inside ``sd``, the batch inside one
    cooperative grid — and a step is one launch.  On CPU tensors a step is
    `apply_culsh_sgd_ref` of the window.  The batches must be
    conflict-free: the kernel writes the planes in place without atomics
    and does not check."""
    if pp.row.device.type == "cpu":
        def step(start: int, k: int) -> None:
            apply_culsh_sgd_ref(pp, slice_batch(sd, start, width, valid[k]),
                                hp, bce=bce)
        return step
    if valid.shape[0] != len(starts):
        raise ValueError(f"culsh_sgd: {valid.shape[0]} slot masks for "
                         f"{len(starts)} batches")
    end = int(np.max(starts)) + width if len(starts) else 0
    return _CulshTier(_culsh_args(pp, sd.i, sd.j, sd.r, sd.nb, sd.rnb,
                                  sd.expl, valid, hp, width=width, end=end,
                                  bce=bce))


def culsh_sgd_batch(pp: PackedParams, bt: Batch, hp: torch.Tensor, *,
                    bce: bool = False) -> PackedParams:
    """The fused CULSH-MF step of one conflict-free `Batch` on the packed
    planes, in place: a tier of one batch (a `Batch` carries the arrays
    of a `ScheduledData`); ``hp`` from `ops.culsh_hyper`."""
    width = bt.i.shape[0]
    if width:
        culsh_sgd_tier(pp, bt, bt.valid[None], hp, width=width,
                       starts=np.zeros(1, np.int64), bce=bce)(0, 0)
    return pp


def mf_sgd_step(u, v, r, valid, hp, *, bce: bool = False):
    """CUSGD++ step on a conflict-free tile: u, v [B, F]; r, valid [B];
    hp [4] = (γu, γv, λu, λv) → (u′, v′, e)."""
    global MF_LAUNCHES
    dev = u.device
    if dev.type == "cpu":
        return mf_sgd_step_ref(u, v, r, valid, hp, bce=bce)
    if dev.type != "cuda":
        raise ValueError(f"mf_sgd_step: unsupported device {dev}")
    check_operand(u, "u", torch.float32, 2, dev)
    check_operand(v, "v", torch.float32, 2, dev)
    if v.shape != u.shape:
        raise ValueError(f"mf_sgd_step: u {tuple(u.shape)} and v "
                         f"{tuple(v.shape)} disagree")
    B, F = u.shape
    _check_vectors(dev, B, r=r, valid=valid)
    _check_vectors(dev, 4, hp=hp)
    u_out, v_out = torch.empty_like(u), torch.empty_like(v)
    e = torch.empty((B,), dtype=torch.float32, device=dev)
    err = _build.library().mf_sgd_step_launch(
        u.data_ptr(), v.data_ptr(), r.data_ptr(), valid.data_ptr(),
        hp.data_ptr(), u_out.data_ptr(), v_out.data_ptr(), e.data_ptr(),
        B, F, int(bce), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "mf_sgd_step")
    MF_LAUNCHES += 1
    return u_out, v_out, e
