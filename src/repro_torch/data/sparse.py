"""Sparse interaction-matrix substrate (`repro/data/sparse.py`).

The COO triples of the rating matrix ``R ∈ R^{M×N}``, kept
(row, col)-lexicographically sorted so a user's ratings are one
contiguous run addressed with `torch.searchsorted`; rating lookup,
degrees and baselines over them; the legacy path's shuffled batches
(`epoch_batches`); and the host-side tiered conflict-free
epoch scheduler of the offline fit (`conflict_free_schedule`), a numpy
copy of the JAX package's that yields the same arrays from the same
seed.  The schedule stays on the host: its batch starts are Python ints,
so every batch of the fit is a view of the schedule-ordered device
arrays (`core.model.slice_batch`), never a device-to-host read.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.scatter import index_add_det_
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SparseMatrix:
    """COO sparse matrix, (row, col)-lexicographically sorted."""

    rows: torch.Tensor  # [nnz] int32, sorted (major)
    cols: torch.Tensor  # [nnz] int32, sorted within row (minor)
    vals: torch.Tensor  # [nnz] float32
    shape: tuple[int, int]

    @property
    def M(self) -> int:
        return self.shape[0]

    @property
    def N(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    def to(self, device) -> "SparseMatrix":
        return dataclasses.replace(self, rows=self.rows.to(device),
                                   cols=self.cols.to(device),
                                   vals=self.vals.to(device))


def _tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A tensor moved/cast, or array data copied, to ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(x, dtype=dtype, device=device)


def from_coo(rows, cols, vals, shape, *, device=None) -> SparseMatrix:
    """Build a SparseMatrix from (unsorted, unique) COO triples.

    The order equals ``jnp.lexsort((cols, rows))``: a stable sort by the
    minor key followed by a stable sort by the major key."""
    dev = resolve_device(device)
    rows = _tensor(rows, torch.int32, dev)
    cols = _tensor(cols, torch.int32, dev)
    vals = _tensor(vals, torch.float32, dev)
    order = torch.sort(cols, stable=True).indices
    order = order[torch.sort(rows[order], stable=True).indices]
    M, N = shape
    return SparseMatrix(rows[order], cols[order], vals[order],
                        (int(M), int(N)))


def _host(x, dtype) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def merge_coo(sp: SparseMatrix, rows, cols, vals,
              shape: tuple[int, int]) -> SparseMatrix:
    """Sorted-array union of Ω̂ and ΔΩ (host numpy) → a `SparseMatrix` of
    ``shape`` on ``sp``'s device.

    ``sp`` is already (row, col)-lexsorted, so merging d new triples needs
    only the delta sorted plus two `searchsorted` passes and one linear
    scatter.  ``shape`` may be larger than ``sp.shape`` (a grown id
    space); keys use the new N, which keeps the old entries' order.  ΔΩ
    is assumed not to repeat observed entries; equal keys land old-first.
    """
    M, N = shape
    r0 = _host(sp.rows, np.int64)
    c0 = _host(sp.cols, np.int64)
    v0 = _host(sp.vals, np.float32)
    rd = _host(rows, np.int64)
    cd = _host(cols, np.int64)
    vd = _host(vals, np.float32)
    k0 = r0 * N + c0
    kd = rd * N + cd
    o = np.argsort(kd, kind="stable")
    rd, cd, vd, kd = rd[o], cd[o], vd[o], kd[o]
    n, d = len(k0), len(kd)
    out_r = np.empty(n + d, np.int32)
    out_c = np.empty(n + d, np.int32)
    out_v = np.empty(n + d, np.float32)
    pos0 = np.arange(n) + np.searchsorted(kd, k0, side="left")
    posd = np.arange(d) + np.searchsorted(k0, kd, side="right")
    out_r[pos0], out_c[pos0], out_v[pos0] = r0, c0, v0
    out_r[posd], out_c[posd], out_v[posd] = rd, cd, vd
    dev = sp.vals.device
    return SparseMatrix(torch.from_numpy(out_r).to(dev),
                        torch.from_numpy(out_c).to(dev),
                        torch.from_numpy(out_v).to(dev), (int(M), int(N)))


def lookup(sp: SparseMatrix, qi: torch.Tensor, qj: torch.Tensor):
    """Rating lookup r_{i,j} for query id tensors of any shape →
    ``(vals, hit)``, 0 where (i, j) is unobserved.  A `searchsorted` over
    the (row, col) keys ``row·N + col`` (int64, so no overflow at any
    M·N), which finds the position the JAX package's binary search
    finds."""
    keys = sp.rows.to(torch.int64) * sp.N + sp.cols
    q = qi.to(torch.int64) * sp.N + qj.to(torch.int64)
    pos = torch.searchsorted(keys, q.reshape(-1)).reshape(q.shape)
    pos = pos.clamp(max=max(sp.nnz - 1, 0))
    hit = keys[pos] == q
    return torch.where(hit, sp.vals[pos], 0.0), hit


def degrees(sp: SparseMatrix):
    """(row_degree [M], col_degree [N]) int32 — |Ω_i| and |Ω̂_j|."""
    dr = torch.bincount(sp.rows.long(), minlength=sp.M).to(torch.int32)
    dc = torch.bincount(sp.cols.long(), minlength=sp.N).to(torch.int32)
    return dr, dc


def baselines(sp: SparseMatrix, eps: float = 1e-9):
    """Paper §3.2 part ①: (μ [], b_i [M], b̂_j [N]) from the observed
    entries; the per-row and per-column sums add in COO order
    (`scatter.index_add_det_`), the same bits on every run."""
    mu = sp.vals.sum() / (sp.nnz + eps)
    dr, dc = degrees(sp)
    dev = sp.vals.device
    sr = index_add_det_(torch.zeros(sp.M, device=dev), sp.rows.long(),
                        sp.vals)
    sc = index_add_det_(torch.zeros(sp.N, device=dev), sp.cols.long(),
                        sp.vals)
    b = torch.where(dr > 0, sr / dr.clamp(min=1) - mu, 0.0)
    bh = torch.where(dc > 0, sc / dc.clamp(min=1) - mu, 0.0)
    return mu, b, bh


def train_test_split(rng: np.random.Generator, rows, cols, vals,
                     test_frac=0.1):
    """Host-side split of COO triples into train/test index sets."""
    nnz = len(vals)
    perm = rng.permutation(nnz)
    ntest = int(nnz * test_frac)
    te, tr = perm[:ntest], perm[ntest:]
    return (rows[tr], cols[tr], vals[tr]), (rows[te], cols[te], vals[te])


def epoch_batches(key: torch.Tensor, nnz: int, batch: int):
    """Shuffled sample indices padded to a whole number of batches, drawn
    on ``key``'s device as the JAX package draws them → ``idx [nb,
    batch]`` int32 and ``valid [nb, batch]`` bool; padding repeats
    samples but is masked out of the update."""
    perm = prng.permutation(key, nnz)
    nb = -(-nnz // batch)
    pad = nb * batch - nnz
    idx = torch.cat([perm, perm[:pad]]).to(torch.int32)
    valid = torch.arange(nb * batch, device=perm.device) < nnz
    return idx.reshape(nb, batch), valid.reshape(nb, batch)


@dataclasses.dataclass(frozen=True)
class EpochSchedule:
    """Tiered conflict-free epoch schedule (host numpy arrays, built once
    per fit) — the JAX package's `EpochSchedule`, field for field.

    ``order`` permutes the triple indices so that every batch of every
    tier is a contiguous window of the schedule-ordered arrays.  Three
    kinds of batches, each conflict-free (every row id and col id at most
    once) except the leftovers:

    * ``shard_*`` — the block-aligned D×D rotation tier (``shards > 1``;
      positions ``[0, shard_span)``; scheduled here, but not trained by
      the port yet);
    * ``tier_*``  — width-tiered conflict-free batches (``widths[t]``);
    * ``lo_*``    — the unschedulable residue, trained with the scaled
      summed step and the precomputed collision normalizers
      ``lo_scale_*``.

    Tier and leftover starts are relative to the cf region that follows
    ``shard_span``.  Windows may read past a batch's fill into the next
    batch's triples; ``*_valid`` masks them out.  With ``shards > 1``
    ``row_map``/``col_map`` send original ids to the block-padded id
    space (empty otherwise).
    """

    order: np.ndarray          # [nnz] int32 — schedule position → triple id
    shard_starts: np.ndarray   # [D, S, R] int32
    shard_valid: np.ndarray    # [D, S, R, Wsh] bool
    tier_starts: tuple         # per tier: [nb_t] int32 into the cf region
    tier_valid: tuple          # per tier: [nb_t, widths[t]] bool
    lo_starts: np.ndarray      # [nb_lo] int32 into the cf region
    lo_valid: np.ndarray       # [nb_lo, widths[0]] bool
    lo_scale_i: np.ndarray     # [nb_lo, widths[0]] float32 1/row-count
    lo_scale_j: np.ndarray     # [nb_lo, widths[0]] float32 1/col-count
    row_bounds: np.ndarray     # [D+1] int32 ([] if D == 1)
    col_bounds: np.ndarray     # [D+1] int32 ([] if D == 1)
    row_map: np.ndarray        # [M] int32 ([] if D == 1)
    col_map: np.ndarray        # [N] int32 ([] if D == 1)
    widths: tuple
    shard_width: int
    shards: int
    block_rows: int
    block_cols: int
    shard_span: int

    @property
    def pad_width(self) -> int:
        """Slack the schedule-ordered arrays need past their fill so every
        window slice stays in bounds (widest batch)."""
        return self.widths[0]

    def stats(self) -> dict:
        """Occupancy breakdown: ``n_cf``/``n_lo`` triples and ``nb_cf``/
        ``nb_lo`` batches conflict-free vs leftover, ``cf_frac`` = n_cf /
        nnz, ``fill``/``cf_fill``/``lo_fill``, and per width tier its
        width, rounds, n and fill (the JAX package's `stats`)."""
        tiers = []
        n_cf = slots_cf = nb_cf = 0
        if self.shard_valid.size:
            n_sh = int(self.shard_valid.sum())
            nb_sh = int(np.prod(self.shard_valid.shape[:3]))
            n_cf += n_sh
            slots_cf += self.shard_valid.size
            nb_cf += nb_sh
            shard = dict(shards=self.shards, width=self.shard_width,
                         rounds=nb_sh, n=n_sh,
                         fill=n_sh / max(self.shard_valid.size, 1),
                         extent_rows=np.diff(self.row_bounds).tolist(),
                         extent_cols=np.diff(self.col_bounds).tolist())
        else:
            shard = dict(shards=self.shards, width=self.shard_width,
                         rounds=0, n=0, fill=0.0)
        for w, valid in zip(self.widths, self.tier_valid):
            n_t = int(valid.sum()) if valid.size else 0
            nb_t = int(valid.shape[0])
            tiers.append(dict(width=w, rounds=nb_t, n=n_t,
                              fill=n_t / max(valid.size, 1)))
            n_cf += n_t
            slots_cf += valid.size
            nb_cf += nb_t
        n_lo = int(self.lo_valid.sum()) if self.lo_valid.size else 0
        slots = slots_cf + self.lo_valid.size
        return dict(
            n_cf=n_cf, n_lo=n_lo, nb_cf=nb_cf,
            nb_lo=int(self.lo_valid.shape[0]),
            cf_frac=n_cf / max(n_cf + n_lo, 1),
            fill=(n_cf + n_lo) / max(slots, 1),
            cf_fill=n_cf / max(slots_cf, 1),
            lo_fill=n_lo / max(self.lo_valid.size, 1),
            tiers=tiers, shard=shard)


class _PriorityPool:
    """Unscheduled triples in (fixed) priority order, with O(window)
    round extraction — the vectorized replacement for PR 2's per-triple
    python-int bitmask probes."""

    def __init__(self, ids):
        self.arr = np.asarray(ids, np.int64)
        self.alive = np.ones(len(self.arr), bool)
        self.cursor = 0
        self.n = int(len(self.arr))

    def window(self, want: int):
        """Positions of the first ≤``want`` alive candidates."""
        want = min(want, self.n)
        if want == 0:
            return np.empty(0, np.int64)
        pos = self.cursor + np.flatnonzero(
            self.alive[self.cursor:self.cursor + 4 * want])
        if len(pos) < want:  # prefix too diluted — compact the pool
            live = self.cursor + np.flatnonzero(self.alive[self.cursor:])
            self.arr = self.arr[live]
            self.alive = np.ones(len(live), bool)
            self.cursor = 0
            pos = np.arange(min(want, len(live)), dtype=np.int64)
        return pos[:want]

    def take(self, positions):
        self.alive[positions] = False
        self.n -= len(positions)
        while self.cursor < len(self.alive):
            seg = np.flatnonzero(self.alive[self.cursor:self.cursor + 1024])
            if len(seg):
                self.cursor += int(seg[0])
                break
            self.cursor += 1024

    def drain(self):
        out = self.arr[self.cursor:][self.alive[self.cursor:]]
        self.alive[:] = False
        self.n = 0
        return out


def _match_round(rr, cc, width, passes, row_used, col_used):
    """Greedy conflict-free matching over a candidate window (vectorized).

    Each pass keeps the first occurrence of every row AND every col among
    the still-available candidates (`np.unique` return_index — the
    vectorized form of the old per-triple bitmask probe), removes their
    row/col peers, and repeats; ≤ ``width`` selections.  Returns positions
    into the window.  ``row_used``/``col_used`` are reusable scratch —
    reset before returning.
    """
    sel = []
    avail = np.ones(len(rr), bool)
    got = 0
    for _ in range(passes):
        cand = np.flatnonzero(avail)
        if not len(cand) or got >= width:
            break
        mr = np.zeros(len(cand), bool)
        mr[np.unique(rr[cand], return_index=True)[1]] = True
        mc = np.zeros(len(cand), bool)
        mc[np.unique(cc[cand], return_index=True)[1]] = True
        take = cand[mr & mc][:width - got]
        if not len(take):
            break
        sel.append(take)
        got += len(take)
        row_used[rr[take]] = True
        col_used[cc[take]] = True
        avail[cand] &= ~(row_used[rr[cand]] | col_used[cc[cand]])
    out = np.concatenate(sel) if sel else np.empty(0, np.int64)
    row_used[rr[out]] = False
    col_used[cc[out]] = False
    return out


def _pack_width(pool, rows, cols, width, min_fill, *, passes, window,
                row_used, col_used, budget):
    """Extract rounds at one width until a round comes up short of
    ``min_fill`` (the re-pack-narrower signal) or the budget runs out."""
    rounds = []
    while pool.n and budget > 0:
        pos = pool.window(window * width)
        ids = pool.arr[pos]
        sel = _match_round(rows[ids], cols[ids], width, passes,
                           row_used, col_used)
        if len(sel) < min_fill:
            break
        rounds.append(ids[sel])
        pool.take(pos[sel])
        budget -= 1
    return rounds, budget


def _balanced_bounds(counts: np.ndarray, D: int, floor: int = 1) -> np.ndarray:
    """Equal-weight partition cuts over an id range (host side).

    Returns ``bounds [D+1]`` with block ``d`` = ids ``[bounds[d],
    bounds[d+1])`` carrying ≈ total/D of ``counts``'s mass (cumsum
    quantile cuts), subject to every block spanning ≥ ``floor`` ids.

    The floor is load-bearing, not a degenerate-case guard: a conflict-
    free round inside a block can never be wider than the block's
    distinct-id extent, so an unconstrained nnz cut on zipf data — whose
    head block collapses to a handful of ids — would cap head-cell
    matchings at that handful and blow up the grid-wide round count the
    other cells are padded to.  Balancing *subject to* extent ≥ the shard
    round width keeps every cell able to fill its rounds (requires
    ``len(counts) ≥ D·floor``; the caller clamps).
    """
    size = len(counts)
    floor = max(1, min(floor, size // max(D, 1)))
    cum = np.cumsum(counts, dtype=np.int64)
    total = int(cum[-1]) if size else 0
    bounds = np.zeros(D + 1, np.int64)
    bounds[D] = size
    for d in range(1, D):
        cut = int(np.searchsorted(cum, d * (total / D), side="left")) + 1
        bounds[d] = min(max(cut, bounds[d - 1] + floor),
                        size - (D - d) * floor)
    return bounds


def _block_id_map(bounds: np.ndarray, size: int, extent: int) -> np.ndarray:
    """Original id → block-padded id: ``g ∈ block d ↦ d·extent + (g −
    bounds[d])``.  Strictly monotone (blocks keep their internal order and
    never overflow into the next block's range since every block extent
    ≤ ``extent``)."""
    ids = np.arange(size, dtype=np.int64)
    blk = np.searchsorted(bounds, ids, side="right") - 1
    return (blk * extent + ids - bounds[blk]).astype(np.int64)


def conflict_free_schedule(rows, cols, *, batch: int = 512, tiers: int = 4,
                           tier_shrink: float = 0.5,
                           min_fill_frac: float = 0.5, shards: int = 1,
                           M: int | None = None, N: int | None = None,
                           seed: int = 0, passes: int = 5, window: int = 6,
                           max_rounds: int | None = None,
                           balance_blocks: bool = True) -> EpochSchedule:
    """Tiered conflict-free scheduler (host side, vectorized round-major).

    Round-major greedy edge colouring of the bipartite interaction graph:
    each round takes a near-maximal conflict-free matching (capped at the
    tier width) from the priority-ordered pool of unscheduled triples.

    Knobs:

    * ``batch``        — tier-0 (widest) conflict-free batch width; auto-
      clamped to ``min(M, N)`` since a conflict-free batch holds each
      row/col at most once.
    * ``tiers`` / ``tier_shrink`` — the width ladder: a round is emitted
      at a tier only when it would not fit the next tier's width (its
      fill is therefore ≥ ``tier_shrink``); smaller rounds step the tier
      down by ``tier_shrink`` instead of being diverted to leftovers.
      Finer ladders (``tier_shrink`` ≈ 0.7) trade a few extra scans for
      tighter packing; the bench scales use 7–9 tiers at 0.71.
    * ``min_fill_frac`` — the *last* tier keeps rounds down to
      ``min_fill_frac·width`` (the measured CPU break-even between padded
      conflict-free work and the leftover path's collision rescaling);
      only below it does the residue (zipf heads whose degree exceeds the
      total round count) become scaled-fallback leftovers, whose
      per-batch collision normalizers are precomputed here into
      ``lo_scale_*``.
    * ``passes`` / ``window`` — matching effort per round: how many
      `np.unique` first-occurrence sweeps over how many candidate
      triples (``window × width``).
    * ``max_rounds``   — hard budget on emitted rounds (default: generous
      multiple of nnz/width; a safety valve, not a tuning knob).

    Priority = (arrival rank within the triple's row/col under a random
    shuffle, heaviest endpoints first): a window prefix then spans many
    distinct rows/cols (so matchings are wide) while heads — which need
    the most distinct rounds — always get a slot first.  Input order must
    NOT leak into the ranking: lexsorted input + zipf-sorted ids would
    hand every low rank to head rows and starve the matching.

    With ``shards = D > 1`` a block-aligned tier is carved first: row/col
    ids are cut into D ranges at ``row_bounds``/``col_bounds`` —
    **equal-nnz** cumsum quantiles by default (``balance_blocks=True``),
    equal-id-range otherwise — and cell ``(s, d)`` (sub-epoch, device) is
    scheduled independently at the shard width so device ``d`` processes
    block ``((d+s) % D, d)``: the cuMF_SGD rotation that lets the D
    cells of a step run on D devices in parallel with no collective (the
    port's fit does not train this tier yet).  Cells are padded to the max round count over the grid,
    so equal-id-range cuts on zipf data leave head-block rounds empty;
    nnz balancing equalizes per-cell round counts and recovers that fill.
    The unequal original ranges are then re-laid as equal ``block_rows``/
    ``block_cols`` ranges in the block-padded id space (``row_map``/
    ``col_map``).  Cell residue falls through to the ordinary tiers.
    """
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    nnz = int(rows.shape[0])
    rng = np.random.default_rng(seed)
    M = int(M) if M is not None else int(rows.max(initial=-1)) + 1
    N = int(N) if N is not None else int(cols.max(initial=-1)) + 1
    # a conflict-free batch holds each row/col at most once, so width
    # beyond min(M, N) can only ever be padding — clamp
    batch = max(1, min(batch, M, N))
    widths = []
    w = batch
    for _ in range(max(1, int(tiers))):
        widths.append(w)
        if w == 1:
            break
        w = max(1, min(w - 1, int(w * tier_shrink)))
    widths = tuple(widths)
    # emit a round at tier t only if it can't fit tier t+1's width — fill
    # per emitted round is then ≥ tier_shrink; the last tier uses the
    # padded-work vs collision-rescaling break-even
    min_fills = tuple(widths[1:]) + (max(1, int(widths[-1] * min_fill_frac)),)

    dr = np.bincount(rows, minlength=M)
    dc = np.bincount(cols, minlength=N)
    # arrival rank within each row/col under a *random* arrival order
    # (input order must not leak in: lexsorted input + zipf-sorted ids
    # would hand every low rank to head rows and starve the matching)
    shuffle = rng.permutation(nnz)

    def arrival_rank(ids, size):
        a = ids[shuffle]
        o = np.argsort(a, kind="stable")
        counts = np.bincount(a, minlength=size)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        r = np.empty(nnz, np.int64)
        r[o] = np.arange(nnz) - np.repeat(starts, counts)
        out = np.empty(nnz, np.int64)
        out[shuffle] = r
        return out

    if nnz:
        rank = np.maximum(arrival_rank(rows, M), arrival_rank(cols, N))
        priority = np.lexsort((rng.random(nnz), -(dr[rows] + dc[cols]), rank))
    else:
        priority = np.empty(0, np.int64)

    row_used = np.zeros(M, bool)
    col_used = np.zeros(N, bool)
    order_parts: list[np.ndarray] = []
    pos = 0

    def layout(chunks, width, starts_shape=None):
        """Append chunks to the layout; rows sorted within each batch for
        scatter locality.  Returns (starts, valid)."""
        nonlocal pos
        starts = np.zeros(len(chunks), np.int32)
        valid = np.zeros((len(chunks), width), bool)
        for b, m in enumerate(chunks):
            m = m[np.argsort(rows[m], kind="stable")]
            order_parts.append(m)
            starts[b] = pos
            valid[b, :len(m)] = True
            pos += len(m)
        return starts, valid

    # ---- block-aligned shard tier (cuMF-style D×D rotation) --------------
    D = max(1, int(shards))
    mB = nB = 0
    Wsh = widths[0]
    row_bounds = np.zeros(0, np.int64)
    col_bounds = np.zeros(0, np.int64)
    row_map = np.zeros(0, np.int64)
    col_map = np.zeros(0, np.int64)
    if D > 1 and nnz:
        if balance_blocks:
            # equal-nnz cumsum quantile cuts, floored at the round width
            # so no block's matching is extent-limited (see _balanced_bounds)
            row_bounds = _balanced_bounds(dr, D, floor=min(batch, M // D))
            col_bounds = _balanced_bounds(dc, D, floor=min(batch, N // D))
            Wsh = max(1, min(batch, int(np.diff(row_bounds).min()),
                             int(np.diff(col_bounds).min())))
        else:                # legacy equal-id-range cuts
            row_bounds = np.minimum(np.arange(D + 1) * (-(-M // D)), M)
            col_bounds = np.minimum(np.arange(D + 1) * (-(-N // D)), N)
            Wsh = max(1, min(batch, -(-M // D), -(-N // D)))
        mB = int(np.diff(row_bounds).max())      # block-padded extents
        nB = int(np.diff(col_bounds).max())
        row_map = _block_id_map(row_bounds, M, mB)
        col_map = _block_id_map(col_bounds, N, nB)
        rb = np.searchsorted(row_bounds, rows, side="right") - 1
        cb = np.searchsorted(col_bounds, cols, side="right") - 1
        cell_of = ((rb - cb) % D) * D + cb       # cell = (s, d) flattened
        fill_sh = max(1, int(Wsh * min_fill_frac))
        by_cell = np.argsort(cell_of[priority], kind="stable")
        grouped = priority[by_cell]              # cell-major, priority kept
        cbounds = np.searchsorted(cell_of[grouped], np.arange(D * D + 1))
        cells = []
        for c0 in range(D * D):
            pool = _PriorityPool(grouped[cbounds[c0]:cbounds[c0 + 1]])
            n_cell = pool.n
            rounds, _ = _pack_width(
                pool, rows, cols, Wsh, fill_sh, passes=passes, window=window,
                row_used=row_used, col_used=col_used,
                budget=4 * n_cell // Wsh + 8)
            cells.append(rounds)
        R = max((len(r) for r in cells), default=0)
        shard_starts = np.zeros((D, D, R), np.int32)
        shard_valid = np.zeros((D, D, R, Wsh), bool)
        scheduled = np.zeros(nnz, bool)
        for s in range(D):
            for r in range(R):
                for d in range(D):
                    cell = cells[s * D + d]
                    chunk = [cell[r]] if r < len(cell) else [np.empty(0, np.int64)]
                    st, va = layout(chunk, Wsh)
                    shard_starts[d, s, r] = st[0]
                    shard_valid[d, s, r] = va[0]
                    scheduled[chunk[0]] = True
        priority = priority[~scheduled[priority]]
    else:
        shard_starts = np.zeros((D, D, 0), np.int32)
        shard_valid = np.zeros((D, D, 0, Wsh), bool)
    shard_span = pos   # schedule positions [0, shard_span) are shard cells

    # ---- width-tiered conflict-free rounds -------------------------------
    # tier/lo starts are rebased to the cf region (positions − shard_span):
    # shard cells are kept apart from it, so `model.ScheduledData` only
    # holds the cf-region triples
    pool = _PriorityPool(priority)
    budget = max_rounds if max_rounds is not None else 8 * max(nnz, 1) // widths[-1] + 64
    tier_starts, tier_valid = [], []
    for w, mf in zip(widths, min_fills):
        rounds, budget = _pack_width(
            pool, rows, cols, w, max(1, min(mf, w)),
            passes=passes, window=window, row_used=row_used,
            col_used=col_used, budget=budget)
        st, va = layout(rounds, w)
        tier_starts.append(st - shard_span)
        tier_valid.append(va)

    # ---- scaled-fallback leftovers ---------------------------------------
    lo = pool.drain()
    rng.shuffle(lo)   # decorrelate: priority order packs same-head runs
    W0 = widths[0]
    # pre-sort each chunk by row (the sort `layout` would apply) so the
    # precomputed collision normalizers stay slot-aligned with the layout
    chunks = [m[np.argsort(rows[m], kind="stable")]
              for c0 in range(0, len(lo), W0)
              for m in (lo[c0:c0 + W0],)]
    lo_si = np.ones((len(chunks), W0), np.float32)
    lo_sj = np.ones((len(chunks), W0), np.float32)
    for b, m in enumerate(chunks):
        # 1/count per slot — the collision normalizer of the scaled step,
        # a schedule constant (batch composition is fixed per fit)
        _, inv, cnt = np.unique(rows[m], return_inverse=True,
                                return_counts=True)
        lo_si[b, :len(m)] = np.float32(1.0) / cnt.astype(np.float32)[inv]
        _, inv, cnt = np.unique(cols[m], return_inverse=True,
                                return_counts=True)
        lo_sj[b, :len(m)] = np.float32(1.0) / cnt.astype(np.float32)[inv]
    lo_starts, lo_valid = layout(chunks, W0)
    lo_starts = lo_starts - shard_span

    assert pos == nnz
    order = (np.concatenate(order_parts) if order_parts
             else np.empty(0, np.int64))
    return EpochSchedule(
        order=order.astype(np.int32),
        shard_starts=shard_starts, shard_valid=shard_valid,
        tier_starts=tuple(tier_starts), tier_valid=tuple(tier_valid),
        lo_starts=lo_starts, lo_valid=lo_valid,
        lo_scale_i=lo_si, lo_scale_j=lo_sj,
        row_bounds=row_bounds.astype(np.int32),
        col_bounds=col_bounds.astype(np.int32),
        row_map=row_map.astype(np.int32),
        col_map=col_map.astype(np.int32),
        widths=widths, shard_width=int(Wsh), shards=D,
        block_rows=int(mB), block_cols=int(nB), shard_span=int(shard_span))
