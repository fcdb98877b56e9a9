"""Launch wrappers of the CUDA fused SGD steps (`csrc/culsh_sgd.cu`,
`csrc/mf_sgd.cu`), the Hopper counterparts of the TPU kernels
`repro/kernels/mf_sgd/kernel.py::culsh_sgd_step` and `::mf_sgd_step`.

Tiles in, updated tiles out, as on the TPU: the plane gathers and the
delta scatter stay in `ops.py`.  On CUDA tensors a wrapper launches its
kernel or raises — it never falls back; on CPU tensors it runs the plain
version in `ref.py`.  ``CULSH_LAUNCHES`` and ``MF_LAUNCHES`` count kernel
launches.  ``hp`` is a device tensor built once per epoch, so a launch
reads no scalar from the host.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, check_operand
from repro_torch.kernels.mf_sgd.ref import culsh_sgd_step_ref, mf_sgd_step_ref

__all__ = ["CULSH_LAUNCHES", "MF_LAUNCHES", "culsh_sgd_step", "mf_sgd_step"]

CULSH_LAUNCHES = 0
MF_LAUNCHES = 0


def _check_vectors(dev, B, **vecs):
    for name, t in vecs.items():
        check_operand(t, name, torch.float32, 1, dev)
        if t.shape[0] != B:
            raise ValueError(f"{name}: expected [{B}], got {tuple(t.shape)}")


def culsh_sgd_step(row, col, rnb, bh_nb, expl, r, valid, hp, *,
                   bce: bool = False):
    """Fused six-parameter CULSH-MF step (paper Alg. 3, Eq. 5) on packed
    tiles: row [B, F+1], col [B, F+2K+1], rnb/bh_nb/expl [B, K], r/valid
    [B], hp [13] (see `ref.culsh_sgd_step_ref`) → (row′, col′).  Rows
    with ``valid == 0`` come back bit for bit unchanged."""
    global CULSH_LAUNCHES
    dev = row.device
    if dev.type == "cpu":
        return culsh_sgd_step_ref(row, col, rnb, bh_nb, expl, r, valid, hp,
                                  bce=bce)
    if dev.type != "cuda":
        raise ValueError(f"culsh_sgd_step: unsupported device {dev}")
    for name, t in (("row", row), ("col", col), ("rnb", rnb),
                    ("bh_nb", bh_nb), ("expl", expl)):
        check_operand(t, name, torch.float32, 2, dev)
    B, Fp1 = row.shape
    K = rnb.shape[1]
    F = Fp1 - 1
    if (col.shape != (B, F + 2 * K + 1) or bh_nb.shape != (B, K)
            or expl.shape != (B, K)):
        raise ValueError(f"culsh_sgd_step: row {tuple(row.shape)}, col "
                         f"{tuple(col.shape)}, rnb {tuple(rnb.shape)}, bh_nb "
                         f"{tuple(bh_nb.shape)}, expl {tuple(expl.shape)} "
                         f"disagree")
    _check_vectors(dev, B, r=r, valid=valid)
    _check_vectors(dev, 13, hp=hp)
    row_out = torch.empty_like(row)
    col_out = torch.empty_like(col)
    err = _build.library().culsh_sgd_step_launch(
        row.data_ptr(), col.data_ptr(), rnb.data_ptr(), bh_nb.data_ptr(),
        expl.data_ptr(), r.data_ptr(), valid.data_ptr(), hp.data_ptr(),
        row_out.data_ptr(), col_out.data_ptr(), B, F, K, int(bce),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "culsh_sgd_step")
    CULSH_LAUNCHES += 1
    return row_out, col_out


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
