"""Launch wrappers of the CUDA fused SGD steps (`csrc/culsh_sgd.cu`,
`csrc/mf_sgd.cu`), the Hopper counterparts of the TPU kernels
`repro/kernels/mf_sgd/kernel.py::culsh_sgd_step` and `::mf_sgd_step`.

Each kernel does the whole step of a conflict-free batch in one launch:
it reads the plane rows by id and writes the new rows back into the
planes (the gather → step → delta scatter of `ref.apply_culsh_sgd_ref`
and `ref.apply_mf_sgd_ref`).  The CULSH-MF launch is cooperative: it
also reads the neighbour baselines b̂[J^K[j]], which other slots may
rewrite, so the whole grid meets at a barrier between the reads and the
writes.  A CUSGD++ slot reads only its own u and v, so its launch is a
plain one.  `culsh_sgd_tier` and `mf_sgd_tier` validate a schedule
tier's operands once and return a step function that is one ctypes call
per batch (the epoch loop); `culsh_sgd_batch` and `mf_sgd_batch` run one
`Batch`.

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
from repro_torch.kernels.mf_sgd.ref import (apply_culsh_sgd_ref,
                                            apply_mf_sgd_ref)

__all__ = ["CULSH_LAUNCHES", "MF_LAUNCHES", "culsh_sgd_batch",
           "culsh_sgd_tier", "mf_sgd_batch", "mf_sgd_tier"]

CULSH_LAUNCHES = 0
MF_LAUNCHES = 0
_CULSH_WARPS = 2                        # slots per block (csrc kThreads / 32)


class _CulshArgs(ctypes.Structure):
    """`CulshArgs` of `csrc/culsh_sgd.cu`."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "row", "col", "i", "j", "r", "nb", "rnb", "expl", "valid", "hp",
        "stream")] + [(n, ctypes.c_int) for n in ("width", "F", "K", "bce")])


class _MfArgs(ctypes.Structure):
    """`MfArgs` of `csrc/mf_sgd.cu`."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "row", "col", "i", "j", "r", "valid", "hp", "stream")]
        + [(n, ctypes.c_int) for n in ("width", "F", "row_w", "col_w",
                                       "bce")])


def _check_vectors(dev, B, **vecs):
    for name, t in vecs.items():
        check_operand(t, name, torch.float32, 1, dev)
        if t.shape[0] != B:
            raise ValueError(f"{name}: expected [{B}], got {tuple(t.shape)}")


def _check_tier(what: str, pp: PackedParams, i, j, r, valid, *, width: int,
                end: int) -> None:
    """The operands both fused steps share: the planes on the card, the
    triples' [P] arrays (a window of ``width`` slots must fit below
    ``end`` ≤ P) and the [n, width] slot masks."""
    dev = pp.row.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    F, K = pp.F, pp.K
    if F < 1 or K < 0:
        raise ValueError(f"{what}: F={F}, K={K}")
    check_operand(pp.row, "row", torch.float32, 2, dev)
    check_operand(pp.col, "col", torch.float32, 2, dev)
    if pp.row.shape[1] != F + 1 or pp.col.shape[1] != F + 2 * K + 1:
        raise ValueError(f"{what}: planes {tuple(pp.row.shape)}, "
                         f"{tuple(pp.col.shape)} disagree with F={F}, K={K}")
    for name, t, dtype in (("i", i, torch.int32), ("j", j, torch.int32),
                           ("r", r, torch.float32)):
        check_operand(t, name, dtype, 1, dev)
    P = i.shape[0]
    if j.shape[0] != P or r.shape[0] != P:
        raise ValueError(f"{what}: i, j, r of lengths {P}, {j.shape[0]}, "
                         f"{r.shape[0]} disagree")
    if end > P:
        raise ValueError(f"{what}: a window ends at {end}, past the {P} "
                         f"triples")
    check_operand(valid, "valid", torch.float32, 2, dev)
    if valid.shape[1] != width:
        raise ValueError(f"{what}: valid {tuple(valid.shape)} disagrees "
                         f"with width {width}")


def _culsh_args(pp: PackedParams, i, j, r, nb, rnb, expl, valid, hp, *,
                width: int, end: int, bce: bool) -> _CulshArgs:
    """Validate the operands of the fused CULSH-MF step on the card and
    pack them: `_check_tier`'s, the [P, K] neighbour arrays and the [13]
    hyper vector.  Raises on anything the kernel does not take, including
    a batch the card cannot hold as one cooperative grid."""
    _check_tier("culsh_sgd", pp, i, j, r, valid, width=width, end=end)
    dev, F, K, P = pp.row.device, pp.F, pp.K, i.shape[0]
    for name, t, dtype in (("nb", nb, torch.int32), ("rnb", rnb,
                                                     torch.float32),
                           ("expl", expl, torch.float32)):
        check_operand(t, name, dtype, 2, dev)
        if t.shape != (P, K):
            raise ValueError(f"culsh_sgd: {name} {tuple(t.shape)} disagrees "
                             f"with [{P}, {K}]")
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


def _mf_args(pp: PackedParams, i, j, r, valid, hp, *, width: int, end: int,
             bce: bool) -> _MfArgs:
    """Validate the operands of the fused CUSGD++ step on the card and
    pack them: `_check_tier`'s and the [4] hyper vector.  The kernel
    reads U and V as the first F columns of the planes, with the planes'
    own row widths."""
    _check_tier("mf_sgd", pp, i, j, r, valid, width=width, end=end)
    dev = pp.row.device
    _check_vectors(dev, 4, hp=hp)
    return _MfArgs(
        pp.row.data_ptr(), pp.col.data_ptr(), i.data_ptr(), j.data_ptr(),
        r.data_ptr(), valid.data_ptr(), hp.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, width, pp.F,
        pp.row.shape[1], pp.col.shape[1], int(bce))


class _Tier:
    """The step function of a tier on the card: the validated operands in
    a ctypes structure, one ctypes call per batch."""

    def __init__(self, args, launch, mf: bool):
        self.args = args
        self._ptr = ctypes.addressof(args)
        self._launch = launch
        self._mf = mf

    def __call__(self, start: int, k: int) -> None:
        global CULSH_LAUNCHES, MF_LAUNCHES
        err = self._launch(self._ptr, start, k)
        if err:
            _build.check(err, "mf_sgd" if self._mf else "culsh_sgd")
        if self._mf:
            MF_LAUNCHES += 1
        else:
            CULSH_LAUNCHES += 1


def _tier_end(valid: torch.Tensor, starts: np.ndarray, width: int) -> int:
    """Where the tier's last window ends (0 for an empty tier)."""
    if valid.shape[0] != len(starts):
        raise ValueError(f"{valid.shape[0]} slot masks for {len(starts)} "
                         f"batches")
    return int(np.max(starts)) + width if len(starts) else 0


def _ref_tier(apply):
    """The tier function of a plain step ``apply``: ``step(start, k)``
    applies it to the window at ``start`` with mask ``valid[k]``."""
    def tier(pp: PackedParams, sd, valid: torch.Tensor, hp: torch.Tensor, *,
             width: int, starts: np.ndarray, bce: bool = False):
        def step(start: int, k: int) -> None:
            apply(pp, slice_batch(sd, start, width, valid[k]), hp, bce=bce)
        return step
    return tier


# the plain versions of the two tier functions below, on any device
culsh_sgd_tier_ref = _ref_tier(apply_culsh_sgd_ref)
mf_sgd_tier_ref = _ref_tier(apply_mf_sgd_ref)


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
        return culsh_sgd_tier_ref(pp, sd, valid, hp, width=width,
                                  starts=starts, bce=bce)
    end = _tier_end(valid, starts, width)
    args = _culsh_args(pp, sd.i, sd.j, sd.r, sd.nb, sd.rnb, sd.expl, valid,
                       hp, width=width, end=end, bce=bce)
    return _Tier(args, _build.library().culsh_sgd_launch, mf=False)


def mf_sgd_tier(pp: PackedParams, sd, valid: torch.Tensor, hp: torch.Tensor,
                *, width: int, starts: np.ndarray, bce: bool = False):
    """A step function for one conflict-free tier of a plain-MF
    (``method="none"``) schedule: ``step(start, k)`` runs the fused
    CUSGD++ step (paper Alg. 2) of the batch of ``width`` slots at offset
    ``start`` of ``sd``, whose slot mask is ``valid[k]``, updating the U
    and V columns of the planes of ``pp`` in place.  ``hp`` is the [4]
    vector of `ops.mf_hyper`.

    On the card every operand is validated here, once, and a step is one
    launch; on CPU tensors a step is `apply_mf_sgd_ref` of the window.
    The batches must be conflict-free, as for `culsh_sgd_tier`."""
    if pp.row.device.type == "cpu":
        return mf_sgd_tier_ref(pp, sd, valid, hp, width=width, starts=starts,
                               bce=bce)
    end = _tier_end(valid, starts, width)
    args = _mf_args(pp, sd.i, sd.j, sd.r, valid, hp, width=width, end=end,
                    bce=bce)
    return _Tier(args, _build.library().mf_sgd_launch, mf=True)


def _batch(tier, pp: PackedParams, bt: Batch, hp: torch.Tensor,
           bce: bool) -> PackedParams:
    """Run one conflict-free `Batch` as a tier of one batch (a `Batch`
    carries the arrays of a `ScheduledData`)."""
    width = bt.i.shape[0]
    if width:
        tier(pp, bt, bt.valid[None], hp, width=width,
             starts=np.zeros(1, np.int64), bce=bce)(0, 0)
    return pp


def culsh_sgd_batch(pp: PackedParams, bt: Batch, hp: torch.Tensor, *,
                    bce: bool = False) -> PackedParams:
    """The fused CULSH-MF step of one conflict-free `Batch` on the packed
    planes, in place; ``hp`` from `ops.culsh_hyper`."""
    return _batch(culsh_sgd_tier, pp, bt, hp, bce)


def mf_sgd_batch(pp: PackedParams, bt: Batch, hp: torch.Tensor, *,
                 bce: bool = False) -> PackedParams:
    """The fused CUSGD++ step of one conflict-free `Batch` on the packed
    planes, in place (only the U and V columns change); ``hp`` from
    `ops.mf_hyper`."""
    return _batch(mf_sgd_tier, pp, bt, hp, bce)
