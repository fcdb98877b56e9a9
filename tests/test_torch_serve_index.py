"""Port vs JAX package: sparse COO order, serve planes, simLSH encoding and
the bucketed LSH index with its retrieval building blocks.

Both packages compute from identical state: the catalog is made with
numpy from a seed, the JAX package encodes it, and its signatures (and,
for the encoder, its Φ rows) reach the port through numpy.  Index
arrays, window descriptors, the padded id plane, seeds and tail hits
must be equal; accumulators agree to the tolerance of
`tests/test_kernels.py` (1e-4 / 1e-3), and signature bits may differ
only where an accumulator is within 1e-5 of 0 (summation order).
"""
import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import simlsh as jsim
from repro.core.model import Params as JParams
from repro.core.model import pack_serve_planes as jpack
from repro.data.sparse import from_coo as jfrom_coo
from repro.serve import build_index as jbuild
from repro.serve import insert as jinsert
from repro.serve import padded_flat_ids as jpadded
from repro.serve import seed_items as jseed
from repro.serve import tail_hits as jtail
from repro.serve import window_slices as jwindows
from repro.serve.index import _sig_of_items as jsig_of
from repro_torch import convert, prng
from repro_torch.core import simlsh
from repro_torch.core.model import pack_serve_planes, unpack_serve_planes
from repro_torch.data.sparse import from_coo
from repro_torch.serve import (build_index, insert, padded_flat_ids,
                               seed_items, tail_hits, window_slices)
from repro_torch.serve.index import _sig_of_items

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from chip_smoke import make_catalog  # noqa: E402  (the smoke's catalog)

SENTINEL = 2 ** 31 - 1
LSH = dict(G=8, p=2, q=10, band_cap=16)


def planted_catalog(N=2000, *, seed=0, F=16):
    """`chip_smoke.make_catalog` (the recipe of `benchmarks/bench_serve.py::
    make_catalog`) at F = 16, as numpy: (U, V, bh, rows, cols, vals, M)."""
    U, V, bh, rows, cols, vals, M = make_catalog(N, "cpu", seed=seed, F=F)
    return U, V, bh, rows.numpy(), cols.numpy(), vals.numpy(), M


def planted_state(N=2000, *, seed=0, tail_cap=32):
    """Both packages' serving state from one planted catalog: returns
    (jax dict, port dict), each with params, sp, sigs (jax) and index."""
    U, V, bh, rows, cols, vals, M = planted_catalog(N, seed=seed)
    z = np.zeros((N, 1), np.float32)
    jp = JParams(U=jnp.asarray(U), V=jnp.asarray(V),
                 b=jnp.zeros((M,), jnp.float32), bh=jnp.asarray(bh),
                 W=jnp.asarray(z), C=jnp.asarray(z),
                 mu=jnp.asarray(3.0, jnp.float32))
    jsp = jfrom_coo(rows, cols, vals, (M, N))
    sigs = jsim.encode(jsp, jsim.SimLSHConfig(**LSH), jax.random.PRNGKey(seed))
    jidx = jbuild(sigs, tail_cap=tail_cap)
    tp = convert.params_from_numpy(U, V, np.zeros(M), bh, z, z, 3.0,
                                   device="cpu")
    tsp = convert.sparse_from_numpy(np.asarray(jsp.rows), np.asarray(jsp.cols),
                                    np.asarray(jsp.vals), (M, N),
                                    device="cpu")
    tidx = convert.index_from_numpy(np.asarray(sigs), tail_cap=tail_cap,
                                    device="cpu")
    return (dict(params=jp, sp=jsp, sigs=sigs, index=jidx),
            dict(params=tp, sp=tsp, index=tidx))


def tied_sparse(M=200, N=60, seed=0):
    """Integer ratings 1..5 (`tests/test_lsh_retrieve.py::_sparse`): most
    of a user's ratings tie, which stresses every tie rule."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(M), 6).astype(np.int32)
    cols = rng.integers(0, N, M * 6).astype(np.int32)
    vals = rng.integers(1, 6, M * 6).astype(np.float32)
    _, uniq = np.unique(rows.astype(np.int64) * N + cols, return_index=True)
    return rows[uniq], cols[uniq], vals[uniq], (M, N)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def state():
    return planted_state()


@pytest.fixture(scope="module")
def state_tail(state):
    """The same index with eight cloned items resident in the tail."""
    js, ts = state
    src = np.asarray([0, 3, 7, 11, 19, 250, 900, 1999])
    new_ids = np.arange(2000, 2008, dtype=np.int32)
    jidx = jinsert(js["index"], js["sigs"][:, src], jnp.asarray(new_ids))
    tidx = insert(ts["index"], torch.tensor(np.asarray(js["sigs"])[:, src]),
                  torch.tensor(new_ids))
    return dict(js, index=jidx), dict(ts, index=tidx)


# ------------------------------------------------------------- data / model

@pytest.mark.parametrize("seed", [0, 1])
def test_from_coo_order_matches_jax(seed):
    """Two stable sorts give `jnp.lexsort((cols, rows))`'s order."""
    rng = np.random.default_rng(seed)
    rows, cols, vals, shape = tied_sparse(M=90, N=40, seed=seed)
    perm = rng.permutation(rows.shape[0])
    a = jfrom_coo(rows[perm], cols[perm], vals[perm], shape)
    b = from_coo(rows[perm], cols[perm], vals[perm], shape, device="cpu")
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(_np(getattr(b, f)),
                                      np.asarray(getattr(a, f)))
    assert b.shape == a.shape and b.nnz == a.nnz


def test_serve_planes_match_jax(state):
    js, ts = state
    a = jpack(js["params"])
    b = pack_serve_planes(ts["params"])
    np.testing.assert_array_equal(_np(b.row), np.asarray(a.row))
    np.testing.assert_array_equal(_np(b.col), np.asarray(a.col))
    assert b.F == a.F and b.n_items == a.n_items
    back = unpack_serve_planes(b)
    np.testing.assert_array_equal(_np(back.U), _np(ts["params"].U))
    np.testing.assert_array_equal(_np(back.bh), _np(ts["params"].bh))
    assert back.W.shape == (2000, 0)


def test_convert_round_trip(state):
    _, ts = state
    d = convert.to_numpy(ts["params"])
    again = convert.params_from_numpy(**d, device="cpu")
    for k, v in d.items():
        np.testing.assert_array_equal(_np(getattr(again, k)), v)
    assert convert.to_numpy(ts["index"])["n_base"] == 2000


# ------------------------------------------------------------------ simLSH

@pytest.mark.parametrize("band", [0, 3, 9])
def test_band_accumulate_matches_jax_given_its_phi(state, band):
    """Fed the JAX package's Φ rows, the port's segment sum matches its
    accumulators, and signature bits agree except where |S| ≈ 0."""
    js, ts = state
    sp, cfg = js["sp"], jsim.SimLSHConfig(**LSH)
    key = jax.random.PRNGKey(0)
    phi = np.asarray(jsim.phi_rows(key, jnp.asarray(band), sp.rows,
                                   cfg.sig_bits))
    want = np.asarray(jsim.band_accumulate(
        sp.rows, sp.cols, sp.vals, key, jnp.asarray(band), N=sp.N,
        bits=cfg.sig_bits, psi_pow=cfg.psi_pow))
    tsp = ts["sp"]
    got = simlsh.band_accumulate(
        tsp.rows, tsp.cols, tsp.vals, prng.PRNGKey(0), band, N=tsp.N,
        bits=cfg.sig_bits,
        psi_pow=cfg.psi_pow, phi=torch.tensor(phi)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    flips = (got >= 0) != (want >= 0)
    assert np.all(np.abs(want[flips]) < 1e-5)
    assert flips.sum() <= 0.001 * flips.size


def test_encode_with_jax_phi_gives_jax_signatures(state):
    js, ts = state
    sp, cfg = js["sp"], jsim.SimLSHConfig(**LSH)
    key = jax.random.PRNGKey(0)
    phi = np.stack([np.asarray(jsim.phi_rows(key, jnp.asarray(b), sp.rows,
                                             cfg.sig_bits))
                    for b in range(cfg.q)])
    sigs, S = simlsh.encode(ts["sp"], simlsh.SimLSHConfig(**LSH),
                            phi=torch.tensor(phi), return_accumulators=True)
    want_sigs, want_S = jsim.encode(sp, cfg, key, return_accumulators=True)
    differ = sigs.numpy() != np.asarray(want_sigs)
    near0 = (np.abs(np.asarray(want_S)) < 1e-5).any(axis=2)
    assert not np.any(differ & ~near0)
    assert differ.sum() <= 0.001 * differ.size
    np.testing.assert_allclose(S.numpy(), np.asarray(want_S), rtol=1e-4,
                               atol=1e-3)


def test_phi_rows_is_stateless_signed_and_keyed_by_id():
    ids = torch.arange(5000)
    a = simlsh.phi_rows(prng.PRNGKey(7), 2, ids, 18)
    assert a.shape == (5000, 18) and a.dtype == torch.float32
    assert set(a.unique().tolist()) == {-1.0, 1.0}
    # a row depends on (key, band, id) only, not on the batch it is in
    sub = torch.tensor([4999, 3, 1234])
    assert torch.equal(simlsh.phi_rows(prng.PRNGKey(7), 2, sub, 18), a[sub])
    assert not torch.equal(simlsh.phi_rows(prng.PRNGKey(8), 2, ids, 18), a)
    assert not torch.equal(simlsh.phi_rows(prng.PRNGKey(7), 3, ids, 18), a)
    assert abs(float(a.mean())) < 0.02            # balanced bits
    # distinct bits of one row are not copies of each other
    assert float((a[:, 0] == a[:, 1]).float().mean()) < 0.55
    # and they are the JAX package's threefry rows, bit for bit
    want = jsim.phi_rows(jax.random.PRNGKey(7), jnp.asarray(2),
                         jnp.arange(5000), 18)
    np.testing.assert_array_equal(a.numpy(), np.asarray(want))


def test_own_encode_is_deterministic_and_recalls_groups():
    """Drawing its own threefry Φ from a key, the port gives the JAX
    package's signatures (bits may differ only where an accumulator is
    within 1e-5 of 0), and items of one planted group collide."""
    _, _, _, rows, cols, vals, M = planted_catalog(1000)
    sp = from_coo(rows, cols, vals, (M, 1000), device="cpu")
    cfg = simlsh.SimLSHConfig(**LSH)
    s1, S = simlsh.encode(sp, cfg, prng.PRNGKey(3), return_accumulators=True)
    assert torch.equal(s1, simlsh.encode(sp, cfg, prng.PRNGKey(3)))
    assert s1.dtype == torch.int32 and s1.shape == (10, 1000)
    jsp = jfrom_coo(rows, cols, vals, (M, 1000))
    want = np.asarray(jsim.encode(jsp, jsim.SimLSHConfig(**LSH),
                                  jax.random.PRNGKey(3)))
    differ = s1.numpy() != want
    assert not np.any(differ & ~(np.abs(S.numpy()) < 1e-5).any(axis=2))
    assert differ.sum() <= 0.001 * differ.size
    same = (s1[:, :50, None] == s1[:, None, :50]).any(0).float().mean()
    other = (s1[:, :50, None] == s1[:, None, 50:100]).any(0).float().mean()
    # the JAX package's threefry Φ gives 0.216 / 0.0004 on this catalog
    assert float(same) > 0.1 and float(other) < 0.01


def test_simlsh_config_refuses_wide_signatures():
    with pytest.raises(ValueError):
        simlsh.SimLSHConfig(G=16, p=2)


# ------------------------------------------------------------------- index

def test_build_index_arrays_equal(state):
    js, ts = state
    a, b = js["index"], ts["index"]
    for f in ("sorted_sigs", "sorted_ids", "bucket_lo", "bucket_hi",
              "slot_of", "tail_sigs", "tail_ids"):
        np.testing.assert_array_equal(_np(getattr(b, f)),
                                      np.asarray(getattr(a, f)), err_msg=f)
    assert (b.n_base, b.tail_cap, b.tail_fill, b.q) == (
        a.n_base, a.tail_cap, a.tail_fill, a.q)


def test_build_index_keeps_ascending_ids_within_buckets():
    """Stable sort: equal signatures keep ascending item order."""
    sigs = torch.tensor([[5, 1, 5, 1, 5, 0]], dtype=torch.int32)
    idx = build_index(sigs, tail_cap=4, device="cpu")
    assert idx.sorted_ids.tolist() == [[5, 1, 3, 0, 2, 4]]
    assert idx.bucket_lo.tolist() == [[0, 1, 1, 3, 3, 3]]
    assert idx.bucket_hi.tolist() == [[1, 3, 3, 6, 6, 6]]


def test_build_index_raises_like_jax():
    with pytest.raises(TypeError, match="NaN-poisoned"):
        build_index(torch.zeros((2, 5)), device="cpu")
    with pytest.raises(TypeError, match="int32"):
        build_index(torch.zeros((2, 5), dtype=torch.int64), device="cpu")
    with pytest.raises(ValueError, match=r"\[q, N\]"):
        build_index(torch.zeros((5,), dtype=torch.int32), device="cpu")


def test_insert_matches_jax_and_is_functional(state, state_tail):
    (_, ts), (jt, tt) = state, state_tail
    a, b = jt["index"], tt["index"]
    np.testing.assert_array_equal(_np(b.tail_sigs), np.asarray(a.tail_sigs))
    np.testing.assert_array_equal(_np(b.tail_ids), np.asarray(a.tail_ids))
    assert b.tail_fill == a.tail_fill == 8 and b.n_items == 2008
    assert ts["index"].tail_fill == 0                   # original untouched
    assert int((ts["index"].tail_ids != SENTINEL).sum()) == 0


def test_insert_refuses_overflow_and_bad_ids(state):
    _, ts = state
    idx = ts["index"]
    sig = torch.zeros((10, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="overflow"):
        insert(idx, torch.zeros((10, 33), dtype=torch.int32),
               torch.arange(2000, 2033))
    with pytest.raises(ValueError):
        insert(idx, sig, torch.tensor([-1]))
    with pytest.raises(TypeError):
        insert(idx, sig.float(), torch.tensor([2000]))


@pytest.mark.parametrize("cap", [4, 8, 16])
def test_window_slices_equal(state, cap):
    js, ts = state
    seeds = np.random.default_rng(cap).integers(-3, 2010, (24, 6))
    seeds[0, :2] = SENTINEL
    a = jwindows(js["index"], jnp.asarray(seeds, jnp.int32), cap=cap)
    b = window_slices(ts["index"], torch.tensor(seeds, dtype=torch.int32),
                      cap=cap)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(_np(y), np.asarray(x))


@pytest.mark.parametrize("cap", [4, 8])
def test_padded_flat_ids_equal(state, cap):
    js, ts = state
    np.testing.assert_array_equal(
        _np(padded_flat_ids(ts["index"], cap=cap)),
        np.asarray(jpadded(js["index"], cap=cap)))


@pytest.mark.parametrize("n_seeds,window", [(4, 32), (8, 64), (16, 64),
                                            (16, 8)])
def test_seed_items_equal_under_ties(n_seeds, window):
    """Integer ratings tie everywhere: the stable descending sort must pick
    the same seeds as `lax.top_k`."""
    rows, cols, vals, shape = tied_sparse()
    a = jseed(jfrom_coo(rows, cols, vals, shape),
              jnp.arange(-1, 201, dtype=jnp.int32), n_seeds=n_seeds,
              window=window)
    b = seed_items(from_coo(rows, cols, vals, shape, device="cpu"),
                   torch.arange(-1, 201, dtype=torch.int32),
                   n_seeds=n_seeds, window=window)
    np.testing.assert_array_equal(_np(b), np.asarray(a))


def test_seed_items_equal_on_planted_catalog(state):
    js, ts = state
    users = np.random.default_rng(3).integers(0, js["sp"].M, 64)
    a = jseed(js["sp"], jnp.asarray(users, jnp.int32), n_seeds=8, window=64)
    b = seed_items(ts["sp"], torch.tensor(users, dtype=torch.int32),
                   n_seeds=8, window=64)
    np.testing.assert_array_equal(_np(b), np.asarray(a))


@pytest.mark.parametrize("k", [0, 16, 8])
def test_tail_hits_equal(state_tail, k):
    js, ts = state_tail
    seeds = np.asarray([[0, 5, SENTINEL], [3, 11, 1999], [250, 2003, 42],
                        [SENTINEL] * 3, [900, 7, 19]], np.int32)
    a = jtail(js["index"], jnp.asarray(seeds), k=k)
    b = tail_hits(ts["index"], torch.tensor(seeds), k=k)
    np.testing.assert_array_equal(_np(b), np.asarray(a))
    assert (_np(b) != SENTINEL).sum() >= 6


def test_sig_of_items_equal_with_tail(state_tail):
    js, ts = state_tail
    ids = np.asarray([[0, 1999, 2000, 2007], [2008, -1, SENTINEL, 500]],
                     np.int32)
    a = jsig_of(js["index"], jnp.asarray(ids))
    b = _sig_of_items(ts["index"], torch.tensor(ids))
    np.testing.assert_array_equal(_np(b), np.asarray(a))


def test_entry_points_default_to_cuda(monkeypatch):
    """With no device named, entry points run on the card — and raise when
    there is none rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sigs = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_index(sigs)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_coo([0], [0], [1.0], (1, 1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.params_from_numpy(*([np.zeros((1, 1))] * 6), 0.0)
    assert build_index(sigs, device="cpu").device.type == "cpu"


def test_index_to_moves_every_tensor(state):
    _, ts = state
    moved = ts["index"].to("cpu")
    assert dataclasses.asdict(moved).keys() == dataclasses.asdict(
        ts["index"]).keys()
    assert moved.n_base == ts["index"].n_base
