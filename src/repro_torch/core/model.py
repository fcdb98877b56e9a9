"""The nonlinear neighbourhood MF model (`repro/core/model.py`).

Paper Eq. (1):

    r̂_ij = b̄_ij + |R^K(i;j)|^{-1/2} Σ_{j1∈R^K} (r_ij1 − b̄_ij1)·w_{j,k1}
                 + |N^K(i;j)|^{-1/2} Σ_{j2∈N^K} c_{j,k2} + u_i·v_jᵀ

with the CULSH-MF complement trick (§4.2(2)): each of the K neighbours
of j is either explicit (i rated it) or implicit, so every sample touches
exactly K of the 2K parameters {w_j, c_j}.

Three layouts of the parameters: the public `Params`; the training
planes `PackedParams` (U‖b and V‖W‖C‖b̂, two gather/scatter pairs per SGD
step); and the serving planes `ServePlanes` (U‖b and V‖b̂).  The fit's
data layout is `ScheduledData` (triples in schedule order, so a batch is
a contiguous view) and its eval cache `EvalCache`; the legacy path
evaluates with a lookup per batch instead (`eval_batches`, `rmse`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import prng
from repro_torch.data.sparse import SparseMatrix, baselines, lookup


@dataclasses.dataclass(frozen=True)
class Params:
    """Unpacked parameters — the public API layout."""

    U: torch.Tensor   # [M, F]
    V: torch.Tensor   # [N, F]
    b: torch.Tensor   # [M]
    bh: torch.Tensor  # [N]
    W: torch.Tensor   # [N, K]
    C: torch.Tensor   # [N, K]
    mu: torch.Tensor  # []

    def to(self, device) -> "Params":
        return Params(*(getattr(self, f.name).to(device)
                        for f in dataclasses.fields(self)))


@dataclasses.dataclass(frozen=True)
class PackedParams:
    """Packed-plane training layout: all row-side parameters in one
    ``[M, F+1]`` plane and all col-side ones in one ``[N, F+2K+1]``
    plane, so an SGD step is two gather/scatter pairs instead of six.

    * ``row[:, :F]`` = U,   ``row[:, F]`` = b
    * ``col[:, :F]`` = V,   ``col[:, F:F+K]`` = W,
      ``col[:, F+K:F+2K]`` = C,   ``col[:, F+2K]`` = b̂

    The port's packed SGD steps update the two planes in place (the JAX
    package's are functional); the tensors of an instance are therefore
    the live training state.
    """

    row: torch.Tensor  # [M, F+1] float32 — U ‖ b
    col: torch.Tensor  # [N, F+2K+1] float32 — V ‖ W ‖ C ‖ b̂
    mu: torch.Tensor   # []
    F: int
    K: int

    @property
    def bh(self) -> torch.Tensor:
        """The b̂ column (a view)."""
        return self.col[:, self.F + 2 * self.K]


def pack_params(p: Params) -> PackedParams:
    """Params → the two training planes (one concatenate per side)."""
    F, K = int(p.U.shape[1]), int(p.W.shape[1])
    return PackedParams(
        row=torch.cat([p.U, p.b[:, None]], dim=1).contiguous(),
        col=torch.cat([p.V, p.W, p.C, p.bh[:, None]], dim=1).contiguous(),
        mu=p.mu, F=F, K=K)


def unpack_params(pp: PackedParams) -> Params:
    """The inverse of `pack_params`: six column views of the planes."""
    F, K = pp.F, pp.K
    return Params(U=pp.row[:, :F], V=pp.col[:, :F], b=pp.row[:, F],
                  bh=pp.col[:, F + 2 * K], W=pp.col[:, F:F + K],
                  C=pp.col[:, F + K:F + 2 * K], mu=pp.mu)


def remap_params(p: Params, sched) -> Params:
    """Re-lay params from original ids into the schedule's block-padded id
    space (`EpochSchedule.row_map`/``col_map``; zero rows where no id
    maps).  The identity on a one-shard schedule."""
    if sched.row_map.size == 0:
        return p
    dev = p.U.device
    rm = torch.from_numpy(sched.row_map).to(dev).long()
    cm = torch.from_numpy(sched.col_map).to(dev).long()
    Mp = sched.shards * sched.block_rows
    Np = sched.shards * sched.block_cols

    def scat(a, m, n):
        out = torch.zeros((n,) + tuple(a.shape[1:]), dtype=a.dtype,
                          device=dev)
        out[m] = a
        return out

    return Params(U=scat(p.U, rm, Mp), V=scat(p.V, cm, Np),
                  b=scat(p.b, rm, Mp), bh=scat(p.bh, cm, Np),
                  W=scat(p.W, cm, Np), C=scat(p.C, cm, Np), mu=p.mu)


def unmap_params(p: Params, sched) -> Params:
    """Inverse of `remap_params` (drops the padding rows)."""
    if sched.row_map.size == 0:
        return p
    dev = p.U.device
    rm = torch.from_numpy(sched.row_map).to(dev).long()
    cm = torch.from_numpy(sched.col_map).to(dev).long()
    return Params(U=p.U[rm], V=p.V[cm], b=p.b[rm], bh=p.bh[cm],
                  W=p.W[cm], C=p.C[cm], mu=p.mu)


@dataclasses.dataclass(frozen=True)
class Batch:
    i: torch.Tensor        # [B] row ids
    j: torch.Tensor        # [B] col ids
    r: torch.Tensor        # [B] ratings
    nb: torch.Tensor       # [B, K] neighbour ids (J^K[j])
    rnb: torch.Tensor      # [B, K] r_{i, nb} (0 where unobserved)
    expl: torch.Tensor     # [B, K] float mask: neighbour in R^K(i;j)
    impl: torch.Tensor     # [B, K] float mask: neighbour in N^K(i;j)
    valid: torch.Tensor    # [B] float mask (padding)


def init_params(key, M, N, F, K, mu=0.0, scale=None,
                device="cpu") -> Params:
    """U, V ~ normal · (1/√F) from two `prng` keys split off ``key`` (the
    JAX package's draws, to a few ulp); b, b̂, W, C zero."""
    ku, kv = prng.split(key.to(device))
    if scale is None:
        scale = np.float32(1.0) / np.sqrt(np.float32(F))
    scale = torch.tensor(scale, dtype=torch.float32, device=device)
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return Params(U=prng.normal(ku, (M, F)) * scale,
                  V=prng.normal(kv, (N, F)) * scale,
                  b=z(M), bh=z(N), W=z(N, K), C=z(N, K),
                  mu=torch.tensor(mu, dtype=torch.float32, device=device))


def init_from_data(key, sp: SparseMatrix, F, K) -> Params:
    """`init_params` with μ, b and b̂ from the data's baselines."""
    mu, b, bh = baselines(sp)
    p = init_params(key, sp.M, sp.N, F, K, device=sp.vals.device)
    return dataclasses.replace(p, mu=mu, b=b, bh=bh)


def assemble(sp: SparseMatrix, JK: torch.Tensor, idx: torch.Tensor,
             valid: torch.Tensor) -> Batch:
    """Gather everything a training batch of triples ``idx`` needs (the
    neighbour ratings by `lookup`)."""
    idx = idx.long()
    i, j, r = sp.rows[idx], sp.cols[idx], sp.vals[idx]
    nb = JK[j.long()]
    rnb, hit = lookup(sp, i[:, None].expand(nb.shape), nb)
    expl = hit.to(torch.float32)
    return Batch(i, j, r, nb, rnb, expl, 1.0 - expl,
                 valid.to(torch.float32))


@dataclasses.dataclass(frozen=True)
class ScheduledData:
    """Cf-region training data in `EpochSchedule` order (once per fit):
    every width-tier / leftover batch is a contiguous window of these
    arrays, so batch assembly is a slice (`slice_batch`), never a gather.
    Padded by ``sched.pad_width`` zero slots so a window reading past
    the last batch's fill stays in bounds.  ``mf_only`` fits build the
    neighbour planes zero-width."""

    i: torch.Tensor     # [P] int32 row ids
    j: torch.Tensor     # [P] int32 col ids
    r: torch.Tensor     # [P] float32 ratings
    nb: torch.Tensor    # [P, K] int32 neighbour ids (J^K[j])
    rnb: torch.Tensor   # [P, K] float32 r_{i, nb} (0 where unobserved)
    expl: torch.Tensor  # [P, K] float32 explicit-slot mask


def _ordered_planes(sp: SparseMatrix, JK: torch.Tensor, sched, order_ids,
                    pad: int, *, mf_only: bool, chunk: int):
    """The (i, j, r, nb, rnb, expl) planes of the ``order_ids``-ordered
    triples, padded by ``pad`` zero slots; the rating lookups run in
    chunks of ``chunk`` triples.  Ids are remapped into the schedule's
    block-padded space when it carries maps; lookups use original ids."""
    dev = sp.vals.device
    n = int(order_ids.shape[0])
    has_map = sched.row_map.size > 0
    to_dev = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
    padded = lambda a: torch.cat(
        [a, torch.zeros((pad,) + tuple(a.shape[1:]), dtype=a.dtype,
                        device=dev)])
    order_ids = to_dev(order_ids).long()
    ri, cj = sp.rows[order_ids], sp.cols[order_ids]
    row_map = to_dev(sched.row_map).long() if has_map else None
    col_map = to_dev(sched.col_map).long() if has_map else None
    i = padded(row_map[ri.long()].to(torch.int32) if has_map else ri)
    j = padded(col_map[cj.long()].to(torch.int32) if has_map else cj)
    r = padded(sp.vals[order_ids])
    if mf_only:
        z2 = torch.zeros((i.shape[0], 0), dtype=torch.float32, device=dev)
        return i, j, r, z2.to(torch.int32), z2, z2
    nb = JK[cj.long()]                  # original col ids (for the lookup)
    rnb = torch.empty(nb.shape, dtype=torch.float32, device=dev)
    expl = torch.empty(nb.shape, dtype=torch.float32, device=dev)
    for c0 in range(0, n, chunk):
        nn = nb[c0:c0 + chunk]
        v, hit = lookup(sp, ri[c0:c0 + chunk, None].expand(nn.shape), nn)
        rnb[c0:c0 + chunk] = v
        expl[c0:c0 + chunk] = hit
    nb_stored = col_map[nb.long()].to(torch.int32) if has_map else nb
    return i, j, r, padded(nb_stored), padded(rnb), padded(expl)


def build_scheduled_data(sp: SparseMatrix, JK: torch.Tensor, sched, *,
                         mf_only: bool = False,
                         chunk: int = 65536) -> ScheduledData:
    """Cf-region (width tiers + leftovers) planes in schedule order on
    ``sp``'s device — see `_ordered_planes`."""
    return ScheduledData(*_ordered_planes(
        sp, JK, sched, sched.order[sched.shard_span:], sched.pad_width,
        mf_only=mf_only, chunk=chunk))


def slice_batch(sd: ScheduledData, start: int, width: int,
                valid: torch.Tensor) -> Batch:
    """A schedule-window batch: contiguous views, zero gathers.  ``start``
    is a host int, so the slice never reads the device."""
    sl = lambda a: a[start:start + width]
    expl = sl(sd.expl)
    return Batch(sl(sd.i), sl(sd.j), sl(sd.r), sl(sd.nb), sl(sd.rnb),
                 expl, 1.0 - expl, valid)


def predict_gathered(mu, b_i, bh_j, ui, vj, wj, cj, bh_of_nb,
                     rnb, expl, impl):
    """Eq. (1) on pre-gathered row-aligned operands — the one forward
    shared by `predict`, the packed SGD steps and the plain version of
    the `culsh_sgd_step` kernel, so the layouts agree bit for bit."""
    bbar = mu + b_i + bh_j                                  # [B]
    bbar_nb = mu + b_i[:, None] + bh_of_nb                  # [B, K]
    resid = (rnb - bbar_nb) * expl                          # [B, K]
    nR = expl.sum(1)
    nN = impl.sum(1)
    sR = torch.where(nR > 0, torch.rsqrt(nR.clamp(min=1.0)), 0.0)
    sN = torch.where(nN > 0, torch.rsqrt(nN.clamp(min=1.0)), 0.0)
    expl_term = sR * (resid * wj).sum(1)
    impl_term = sN * (impl * cj).sum(1)
    dot = (ui * vj).sum(1)
    pred = bbar + expl_term + impl_term + dot
    return pred, dict(resid=resid, sR=sR, sN=sN)


def predict(p: Params, bt: Batch, bh_nb: torch.Tensor | None = None):
    """Eq. (1) → (pred [B], aux) with aux reused by the SGD step.
    ``bh_nb`` optionally substitutes pre-gathered neighbour baselines."""
    i, j = bt.i.long(), bt.j.long()
    bh_of_nb = p.bh[bt.nb.long()] if bh_nb is None else bh_nb
    return predict_gathered(p.mu, p.b[i], p.bh[j], p.U[i], p.V[j], p.W[j],
                            p.C[j], bh_of_nb, bt.rnb, bt.expl, bt.impl)


def predict_mf(p: Params, bt: Batch):
    """Plain-MF prediction (the CUSGD++ model): r̂ = u_i·v_j."""
    return (p.U[bt.i.long()] * p.V[bt.j.long()]).sum(1)


@dataclasses.dataclass(frozen=True)
class EvalCache:
    """Test-set neighbour gathers, computed once per fit (the test
    triples and J^K are fixed), so per-epoch eval is plain slices."""

    nb: torch.Tensor    # [T, K] int32 — J^K[test cols]
    rnb: torch.Tensor   # [T, K] float32 — r_{i, nb} from the train matrix
    expl: torch.Tensor  # [T, K] float32


def build_eval_cache(sp_train: SparseMatrix, JK: torch.Tensor, rows, cols,
                     *, mf_only: bool = False,
                     chunk: int = 65536) -> EvalCache:
    """One lookup sweep over the test triples → EvalCache."""
    dev = sp_train.vals.device
    T = int(rows.shape[0])
    if mf_only:
        z = torch.zeros((T, 0), dtype=torch.float32, device=dev)
        return EvalCache(z.to(torch.int32), z, z)
    nb = JK[cols.long()]
    rnb = torch.empty(nb.shape, dtype=torch.float32, device=dev)
    expl = torch.empty(nb.shape, dtype=torch.float32, device=dev)
    for c0 in range(0, T, chunk):
        nn = nb[c0:c0 + chunk]
        v, hit = lookup(sp_train, rows[c0:c0 + chunk, None].expand(nn.shape),
                        nn)
        rnb[c0:c0 + chunk] = v
        expl[c0:c0 + chunk] = hit
    return EvalCache(nb, rnb, expl)


def rmse_cached(p: Params, ec: EvalCache, rows, cols, vals, *,
                batch: int = 8192, mf_only: bool = False) -> torch.Tensor:
    """Test RMSE (Eq. 6) from the per-fit `EvalCache`, as a 0-dim device
    tensor (no host read)."""
    n = int(rows.shape[0])
    sse = torch.zeros((), dtype=torch.float32, device=vals.device)
    for s in range(0, n, batch):
        sl = lambda a: a[s:s + batch]
        expl = sl(ec.expl)
        r = sl(vals)
        bt = Batch(sl(rows), sl(cols), r, sl(ec.nb), sl(ec.rnb), expl,
                   1.0 - expl, torch.ones_like(r))
        pred = predict_mf(p, bt) if mf_only else predict(p, bt)[0]
        sse = sse + ((r - pred) ** 2).sum()
    return torch.sqrt(sse / n)


def eval_batches(sp_train: SparseMatrix, JK: torch.Tensor, rows, cols, vals,
                 *, batch: int = 8192):
    """The uncached eval's batches of the test triples: ``batch``-wide
    `Batch`es whose neighbour ratings are looked up in the *train*
    matrix, the last one padded by repeating triple 0 with ``valid`` 0."""
    n = int(rows.shape[0])
    nb_batches = -(-n // batch)
    pad = nb_batches * batch - n
    padded = lambda a: torch.cat([a, a[:1].repeat(pad)])
    rows_p, cols_p, vals_p = padded(rows), padded(cols), padded(vals)
    valid = (torch.arange(nb_batches * batch, device=vals.device)
             < n).to(torch.float32)
    for s in range(0, nb_batches * batch, batch):
        i, j = rows_p[s:s + batch], cols_p[s:s + batch]
        nb = JK[j.long()]
        rnb, hit = lookup(sp_train, i[:, None].expand(nb.shape), nb)
        expl = hit.to(torch.float32)
        yield Batch(i, j, vals_p[s:s + batch], nb, rnb, expl, 1.0 - expl,
                    valid[s:s + batch])


def rmse(p: Params, sp_train: SparseMatrix, JK, rows, cols, vals, *,
         batch: int = 8192, mf_only: bool = False) -> torch.Tensor:
    """Test RMSE (Eq. 6) with a `lookup` per batch (`eval_batches`), the
    legacy path's eval, as a 0-dim device tensor."""
    sse = torch.zeros((), dtype=torch.float32, device=vals.device)
    for bt in eval_batches(sp_train, JK, rows, cols, vals, batch=batch):
        pred = predict_mf(p, bt) if mf_only else predict(p, bt)[0]
        sse = sse + ((bt.r - pred) ** 2 * bt.valid).sum()
    return torch.sqrt(sse / int(rows.shape[0]))


@dataclasses.dataclass(frozen=True)
class ServePlanes:
    """Packed serving layout.

    * ``row[:, :F]`` = U,  ``row[:, F]`` = b
    * ``col[:, :F]`` = V,  ``col[:, F]`` = b̂

    The `candidate_score` kernel gathers col-plane rows by candidate id
    inside the kernel, so no ``[B, C, F]`` cube is ever materialized.
    """

    row: torch.Tensor  # [M, F+1] float32 — U ‖ b
    col: torch.Tensor  # [N, F+1] float32 — V ‖ b̂
    mu: torch.Tensor   # []
    F: int

    @property
    def n_items(self) -> int:
        return self.col.shape[0]


def pack_serve_planes(p: Params) -> ServePlanes:
    """Params → the two serving planes (one concatenate per side)."""
    return ServePlanes(
        row=torch.cat([p.U, p.b[:, None]], dim=1).contiguous(),
        col=torch.cat([p.V, p.bh[:, None]], dim=1).contiguous(),
        mu=p.mu, F=int(p.U.shape[1]))


def unpack_serve_planes(sp: ServePlanes) -> Params:
    """Inverse of `pack_serve_planes`, with zero-width W/C planes (the
    serving score never uses them)."""
    F = sp.F
    z = torch.zeros((sp.col.shape[0], 0), dtype=torch.float32,
                    device=sp.col.device)
    return Params(U=sp.row[:, :F], V=sp.col[:, :F], b=sp.row[:, F],
                  bh=sp.col[:, F], W=z, C=z, mu=sp.mu)
