"""Boundary validation: poison-batch quarantine and index invariants
(`repro/resil/validate.py`, single device).

* **Poison ingest batches** — NaN values, negative or out-of-range ids,
  wrong dtypes.  Unchecked they do not crash: a NaN rating trains NaN
  into the planes, a float id silently truncates, an id ≥ 2³⁰ aliases in
  the retrieval dedup hash.  `check_ingest_batch` / `check_delta` raise
  `PoisonBatchError` before any state is touched (quarantine = reject,
  not repair).
* **Corrupt indexes** — a structurally broken `LSHIndex` must never be
  swapped in.  `validate_index` checks the CSR bucket invariants on the
  index's device and runs a recall smoke test: every probed item must
  retrieve itself through `lookup_items`, in the window centred on its
  own slot.  This is a declared divergence from the JAX package, whose
  smoke looks for each item among the first 4 slots of its bucket
  (`lookup_signatures`) and so refuses a correct index once a bucket
  holds more than 4 items (the fit's 8-bit bands at N = 30,000 hold up
  to 1,762); on buckets of at most 4 items both give the same verdicts.

The batch checks run on the host between flushes.  They accept numpy
arrays and tensors on either device; a tensor is copied to the host once
(for the accumulators, only the new columns are).
"""
from __future__ import annotations

import numpy as np
import torch

_MAX_ID = 1 << 30   # the retrieval dedup hash's id bound


class PoisonBatchError(ValueError):
    """An ingest batch failed boundary validation and was quarantined —
    no state was modified.  The message says which check failed and what
    the caller should fix."""


class IndexValidationError(RuntimeError):
    """A freshly built index failed its invariant or recall-smoke checks
    and must not be swapped in."""


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def check_ids(ids, *, what: str, upper: int | None = None) -> np.ndarray:
    """Ids must be an integer array, non-negative, below 2³⁰ (and below
    ``upper`` when given).  Returns the host array for reuse."""
    a = _np(ids)
    if a.dtype.kind == "f":
        bad = "NaN values" if np.isnan(a).any() else "fractional ids"
        raise PoisonBatchError(
            f"{what}: float dtype {a.dtype} ({bad} would silently corrupt "
            f"integer ids) — cast to int32 after validating upstream")
    if a.dtype.kind not in "iu":
        raise PoisonBatchError(
            f"{what}: expected an integer dtype, got {a.dtype}")
    if a.size and int(a.min()) < 0:
        raise PoisonBatchError(
            f"{what}: negative id {int(a.min())} — ids are 0-based "
            f"positions in the catalog/user space")
    if a.size and int(a.max()) >= _MAX_ID:
        raise PoisonBatchError(
            f"{what}: id {int(a.max())} ≥ 2^30 breaks the serve-side dedup "
            f"hash contract (the lsh_retrieve kernel's 30-bit hash)")
    if upper is not None and a.size and int(a.max()) >= upper:
        raise PoisonBatchError(
            f"{what}: id {int(a.max())} out of range (expected < {upper})")
    return a


def check_ingest_batch(new_sigs, new_ids, *, q: int) -> None:
    """Validate one `RecsysService.ingest` batch: signatures [q, n] int32
    (no NaN-poisoned float rows), ids [n] integer, non-negative, < 2³⁰,
    unique.  Raises `PoisonBatchError`; touches no state."""
    sigs = _np(new_sigs)
    ids = check_ids(new_ids, what="ingest new_ids")
    if sigs.dtype.kind == "f":
        nan_rows = (np.isnan(sigs).any(axis=0).sum()
                    if sigs.ndim == 2 else int(np.isnan(sigs).any()))
        raise PoisonBatchError(
            f"ingest new_sigs: float dtype {sigs.dtype} "
            f"({nan_rows} NaN-poisoned columns) — signatures must be the "
            f"packed int32 output of simlsh.pack_bits / encode")
    if sigs.dtype != np.int32:
        raise PoisonBatchError(
            f"ingest new_sigs: expected int32 signatures, got {sigs.dtype}")
    if sigs.ndim != 2 or sigs.shape[0] != q:
        raise PoisonBatchError(
            f"ingest new_sigs: expected shape [q={q}, n], got "
            f"{sigs.shape} — one row per LSH band")
    if ids.ndim != 1 or sigs.shape[1] != ids.shape[0]:
        raise PoisonBatchError(
            f"ingest batch mismatch: {sigs.shape[1]} signature columns vs "
            f"{ids.shape} ids — one id per new item")
    if ids.shape[0] and np.unique(ids).shape[0] != ids.shape[0]:
        raise PoisonBatchError(
            "ingest new_ids: duplicate ids in one batch — each item may "
            "be inserted once")


def check_delta(new_rows, new_cols, new_vals, *, M_new: int, N_new: int,
                M_old: int, N_old: int) -> None:
    """Validate ΔΩ triples at the `online_update` boundary.  Raises
    `PoisonBatchError` before any accumulator, merge or training work."""
    if M_new < M_old or N_new < N_old:
        raise PoisonBatchError(
            f"online_update: grown sizes must not shrink — "
            f"M {M_old}→{M_new}, N {N_old}→{N_new}")
    rows = check_ids(new_rows, what="online_update new_rows", upper=M_new)
    cols = check_ids(new_cols, what="online_update new_cols", upper=N_new)
    vals = _np(new_vals)
    if vals.dtype.kind not in "fiu":
        raise PoisonBatchError(
            f"online_update new_vals: non-numeric dtype {vals.dtype}")
    if not (rows.shape == cols.shape == vals.shape) or rows.ndim != 1:
        raise PoisonBatchError(
            f"online_update ΔΩ: triple arrays must be equal-length 1-D, "
            f"got rows {rows.shape}, cols {cols.shape}, vals {vals.shape}")
    if rows.size == 0:
        raise PoisonBatchError("online_update ΔΩ: empty batch")
    if vals.dtype.kind == "f" and not np.isfinite(vals).all():
        n_bad = int((~np.isfinite(vals)).sum())
        raise PoisonBatchError(
            f"online_update new_vals: {n_bad} non-finite ratings (NaN/inf) "
            f"— a single NaN trains NaN into every touched parameter; "
            f"filter or impute upstream")


def check_accumulators(S, N_old: int) -> None:
    """New-column accumulator slabs must be finite — a NaN-poisoned S row
    signs as garbage (NaN ≥ 0 is False, so `pack_bits` silently produces
    a valid-looking signature that lands the item in a wrong bucket)."""
    new = _np(S[:, N_old:] if S.ndim >= 2 else S)
    if new.size and not np.isfinite(new).all():
        if new.ndim == 3:         # [q, N̄, p·G] → first poisoned column
            bad = int(np.argmax(~np.isfinite(new).all(axis=(0, 2))))
        else:
            bad = 0
        raise PoisonBatchError(
            f"online state: non-finite simLSH accumulators for new column "
            f"{N_old + bad} — re-signing would bucket it randomly; "
            f"quarantine the update that produced it")


def validate_index(index, *, probe: int = 64, seed: int = 0) -> list:
    """Structural and behavioural checks on a (candidate) `LSHIndex`.
    Returns a list of problem strings — empty means the index may be
    swapped in.  The O(q·N) checks run on the index's own device (the
    background rebuilder's stream on the card): only their per-band
    verdicts and one probe batch's candidates come back to the host, so
    validating a 10⁶-item index moves kilobytes, not the index.  A
    `ShardedLSHIndex` goes to `validate_sharded_index`."""
    from repro_torch.serve.index import lookup_items   # no cycle

    if hasattr(index, "bounds"):           # a ShardedLSHIndex
        return validate_sharded_index(index, probe=probe, seed=seed)
    probs: list = []
    arrays = [(torch.as_tensor(getattr(index, name)), name) for name in (
        "sorted_sigs", "sorted_ids", "bucket_lo", "bucket_hi", "slot_of")]
    (ss, _), (si, _), (lo, _), (hi, _), (so, _) = arrays
    q, N = ss.shape
    if N != index.n_base:
        probs.append(f"n_base {index.n_base} != array width {N}")
    for a, name in arrays:
        if tuple(a.shape) != (q, N):
            probs.append(f"{name}: shape {tuple(a.shape)} != ({q}, {N})")
        if a.dtype != torch.int32:
            probs.append(f"{name}: dtype {str(a.dtype).split('.')[-1]} != "
                         f"int32")
    if probs:                      # shape/dtype broken — stop before indexing
        return probs

    # every band's verdicts at once, on the index's device
    ar = torch.arange(N, dtype=torch.int32, device=ss.device)
    asc = (ss[:, 1:] >= ss[:, :-1]).all(dim=1)
    perm = (torch.sort(si, dim=1).values == ar).all(dim=1)
    inv = (torch.gather(so, 1, si.long().clamp(0, max(N - 1, 0)))
           == ar).all(dim=1)
    bucket = ((lo == torch.searchsorted(ss, ss, out_int32=True))
              & (hi == torch.searchsorted(ss, ss, right=True,
                                          out_int32=True))).all(dim=1)
    asc, perm, inv, bucket = torch.stack([asc, perm, inv, bucket]).cpu()
    for b in range(q):
        if not asc[b]:
            probs.append(f"band {b}: sorted_sigs not ascending")
        if not perm[b]:
            probs.append(f"band {b}: sorted_ids is not a permutation")
        elif not inv[b]:
            probs.append(f"band {b}: slot_of is not the inverse of "
                         f"sorted_ids")
        # on a band that is not ascending the binary search's answer is
        # undefined, so this second verdict may differ from the JAX
        # package's numpy one there; the band is refused either way
        if not bucket[b]:
            probs.append(f"band {b}: bucket_lo/hi inconsistent with "
                         f"sorted_sigs")
        if probs:
            break                  # one broken band is enough to refuse

    # recall smoke: every probed item must retrieve itself from the
    # cap-4 window centred on its own slot and clipped to its bucket
    # (exactly 1.0 on a correct index at any bucket size — any miss is
    # structural corruption, not ANN noise)
    if not probs and N and probe:
        rng = np.random.default_rng(seed)
        ids = rng.choice(N, size=min(probe, N), replace=False)
        cand = _np(lookup_items(index, torch.as_tensor(
            ids, dtype=torch.int32, device=so.device), cap=4,
            include_tail=False, assume_base=True))
        miss = [int(i) for k, i in enumerate(ids) if i not in cand[k]]
        if miss:
            probs.append(f"recall smoke: {len(miss)}/{len(ids)} probe items "
                         f"failed self-retrieval (e.g. id {miss[0]})")
    return probs


def validate_sharded_index(index, *, probe: int = 64, seed: int = 0) -> list:
    """`validate_index` for a `ShardedLSHIndex`: the CSR bucket
    invariants on each shard's `shard_local_view`, and the sharded
    geometry — bounds strictly increasing over [0, n_items], ``n_local``
    equal to the cuts' extents, the common ``block`` their largest, and
    every padding slot (and no real item) carrying `_EMPTY_SIG`, so no
    probe lands on one.  The self-retrieval smoke probes real local ids
    only (< ``n_local``): the padding slots share one large `_EMPTY_SIG`
    bucket, where a cap-4 probe would miss on a healthy index."""
    from repro_torch.serve.index import (_EMPTY_SIG, lookup_signatures,
                                         shard_local_view)

    probs: list = []
    bounds = _np(index.bounds)
    n_local = _np(index.n_local)
    D = int(index.shards)
    if bounds.shape != (D + 1,):
        return [f"bounds: shape {bounds.shape} != ({D + 1},)"]
    if bounds[0] != 0 or bounds[-1] != index.n_items:
        probs.append(f"bounds: [{bounds[0]}, {bounds[-1]}] does not cover "
                     f"[0, {index.n_items}]")
    if np.any(np.diff(bounds) <= 0):
        probs.append("bounds: not strictly increasing")
    if not np.array_equal(n_local, np.diff(bounds)):
        probs.append(f"n_local {n_local.tolist()} != diff(bounds)")
    if n_local.size and int(n_local.max()) != index.block:
        probs.append(f"block {index.block} != max shard extent "
                     f"{int(n_local.max())}")
    if probs:
        return probs

    rng = np.random.default_rng(seed)
    per = max(1, probe // D)
    for d in range(D):
        view = shard_local_view(index, d)
        for p in validate_index(view, probe=0):
            probs.append(f"shard {d}: {p}")
        ss = view.sorted_sigs
        q = ss.shape[0]
        nl = int(n_local[d])
        n_pad = int((ss == _EMPTY_SIG).sum())
        if n_pad != (index.block - nl) * q:
            probs.append(f"shard {d}: {n_pad} padding signatures, expected "
                         f"{(index.block - nl) * q} "
                         f"(block {index.block} - n_local {nl} per band)")
        if probs:
            break
        if nl and per:
            ids = rng.choice(nl, size=min(per, nl), replace=False)
            slots = view.slot_of[:, torch.as_tensor(ids, device=ss.device)]
            qsigs = torch.gather(ss, 1, slots.long()).T.contiguous()
            cand = _np(lookup_signatures(view, qsigs, cap=4))
            miss = [int(i) for k, i in enumerate(ids) if i not in cand[k]]
            if miss:
                probs.append(f"shard {d}: recall smoke {len(miss)}/"
                             f"{len(ids)} real items failed self-retrieval "
                             f"(e.g. local id {miss[0]})")
    return probs
