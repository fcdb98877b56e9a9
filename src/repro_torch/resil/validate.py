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
  host and runs a recall smoke test: every probed item must retrieve
  itself through `lookup_signatures`.

The checks run on the host between flushes.  They accept numpy arrays
and tensors on either device; a tensor is copied to the host once (for
the accumulators, only the new columns are).
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
    swapped in.  O(q·N) host numpy plus one probe batch on the index's
    device.  The sharded index is not ported (a later slice)."""
    from repro_torch.serve.index import lookup_signatures   # no cycle

    probs: list = []
    ss = _np(index.sorted_sigs)
    si = _np(index.sorted_ids)
    lo = _np(index.bucket_lo)
    hi = _np(index.bucket_hi)
    so = _np(index.slot_of)
    q, N = ss.shape
    if N != index.n_base:
        probs.append(f"n_base {index.n_base} != array width {N}")
    for a, name in ((ss, "sorted_sigs"), (si, "sorted_ids"),
                    (lo, "bucket_lo"), (hi, "bucket_hi"), (so, "slot_of")):
        if a.shape != (q, N):
            probs.append(f"{name}: shape {a.shape} != ({q}, {N})")
        if a.dtype != np.int32:
            probs.append(f"{name}: dtype {a.dtype} != int32")
    if probs:                      # shape/dtype broken — stop before indexing
        return probs

    ar = np.arange(N, dtype=np.int64)
    for b in range(q):
        if np.any(np.diff(ss[b].astype(np.int64)) < 0):
            probs.append(f"band {b}: sorted_sigs not ascending")
        if not np.array_equal(np.sort(si[b]), ar):
            probs.append(f"band {b}: sorted_ids is not a permutation")
        elif not np.array_equal(so[b, si[b]], ar):
            probs.append(f"band {b}: slot_of is not the inverse of "
                         f"sorted_ids")
        l_ref = np.searchsorted(ss[b], ss[b], side="left")
        h_ref = np.searchsorted(ss[b], ss[b], side="right")
        if not (np.array_equal(lo[b], l_ref) and np.array_equal(hi[b], h_ref)):
            probs.append(f"band {b}: bucket_lo/hi inconsistent with "
                         f"sorted_sigs")
        if probs:
            break                  # one broken band is enough to refuse

    # recall smoke: every probed item must retrieve itself when queried
    # with its own band signatures (exactly 1.0 on a correct index — any
    # miss is structural corruption, not ANN noise)
    if not probs and N and probe:
        rng = np.random.default_rng(seed)
        ids = rng.choice(N, size=min(probe, N), replace=False)
        qsigs = ss[np.arange(q)[:, None], so[:, ids]].T       # [P, q]
        cand = _np(lookup_signatures(
            index, torch.tensor(qsigs, dtype=torch.int32,
                                device=index.sorted_sigs.device), cap=4))
        miss = [int(i) for k, i in enumerate(ids) if i not in cand[k]]
        if miss:
            probs.append(f"recall smoke: {len(miss)}/{len(ids)} probe items "
                         f"failed self-retrieval (e.g. id {miss[0]})")
    return probs
