"""Port vs JAX package: the retrieval and selection stages of the legacy
pool + dedup path (``band_budget=0``) and of the plain walk path
(``impl="ref"``), on the CPU.

Both packages retrieve from identical state: the planted catalog of
`test_torch_serve_index.py` (N = 2,000), its JAX-encoded signatures and
J^K reaching the port through numpy.  Two indexes: the catalog's own
(16-bit bands, small buckets) and a coarse one over the signatures' low
3 bits (buckets of ~250), whose windows overlap, clip at bucket edges
and share starts; each also with eight cloned items in its tail.  Every
retrieval function's ids must be **bit-equal** to the JAX function's;
the scoring and selection stages must give equal ids and scores within
1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topk as jtopk
from repro.serve import build_index as jbuild
from repro.serve import insert as jinsert
from repro.serve import retrieve as jret
from repro.serve import service as jsvc
from repro_torch import convert
from repro_torch.serve import insert
from repro_torch.serve import retrieve as tret
from repro_torch.serve import service as tsvc
from test_torch_serve_index import planted_state

SENTINEL = 2 ** 31 - 1
TAIL_SRC = np.asarray([0, 3, 7, 11, 19, 250, 900, 1999])


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    """A JAX array's copy as a tensor (JAX hands out read-only buffers)."""
    return torch.from_numpy(np.array(x))


def _eq(got, want):
    np.testing.assert_array_equal(_np(got), _np(want))


def _indexes(sigs, tail_cap=32):
    """(jax index, port index) over ``sigs``, and the pair with eight
    cloned items in the tail."""
    jidx = jbuild(jnp.asarray(sigs), tail_cap=tail_cap)
    tidx = convert.index_from_numpy(sigs, tail_cap=tail_cap, device="cpu")
    ids = np.arange(sigs.shape[1], sigs.shape[1] + 8, dtype=np.int32)
    tail_sigs = sigs[:, TAIL_SRC]
    return ((jidx, tidx),
            (jinsert(jidx, jnp.asarray(tail_sigs), jnp.asarray(ids)),
             insert(tidx, torch.tensor(tail_sigs), torch.tensor(ids))))


@pytest.fixture(scope="module")
def world():
    js, ts = planted_state(tail_cap=32)
    sigs = np.asarray(js["sigs"])
    JK = np.array(jtopk.topk_from_signatures(
        js["sigs"], jax.random.fold_in(jax.random.PRNGKey(0), 1), K=16,
        band_cap=16))
    fine, fine_tail = _indexes(sigs)
    coarse, coarse_tail = _indexes(sigs & 7)
    M = int(js["sp"].M)
    users = np.concatenate([
        np.random.default_rng(3).integers(0, M, 37),
        [M - 1, M + 5]]).astype(np.int32)         # one user past the rows
    return dict(js=js, ts=ts, JK=(jnp.asarray(JK), torch.from_numpy(JK)),
                index={("fine", False): fine, ("fine", True): fine_tail,
                       ("coarse", False): coarse,
                       ("coarse", True): coarse_tail},
                users=(jnp.asarray(users), torch.from_numpy(users)))


def _pools(seed, B=12, L=200, hi=60):
    """[B, L] id pools with many duplicates, 30 % SENTINEL and a few ids
    near 2³⁰ (the hash's top)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, hi, (B, L)).astype(np.int32)
    ids[rng.random((B, L)) < 0.3] = SENTINEL
    ids[:, ::37] = (1 << 30) - 1 - rng.integers(0, 4, ids[:, ::37].shape)
    ids[0] = SENTINEL                             # an all-padding row
    return ids


# ------------------------------------------------- legacy pool + dedup


@pytest.mark.parametrize("exclude", [False, True])
@pytest.mark.parametrize("C", [8, 40, 256])
def test_dedup_candidates_equals_jax(C, exclude):
    """C = 8 truncates in hashed order (~60 unique ids a row)."""
    ids = _pools(C)
    excl = np.unique(np.random.default_rng(1).integers(0, 60, 12)).astype(
        np.int32) if exclude else None
    want = jret.dedup_candidates(
        jnp.asarray(ids), C=C,
        exclude_sorted=None if excl is None else jnp.asarray(excl))
    got = tret.dedup_candidates(
        torch.from_numpy(ids), C=C,
        exclude_sorted=None if excl is None else torch.from_numpy(excl))
    _eq(got, want)
    row = _np(got)[1]
    real = row[row != SENTINEL]
    assert len(set(real)) == len(real)
    if exclude:
        assert not set(real) & set(excl)


@pytest.mark.parametrize("width", [3, 50, 300])
def test_compact_pool_equals_jax(width):
    ids = _pools(width)
    _eq(tret.compact_pool(torch.from_numpy(ids), width=width),
        jret.compact_pool(jnp.asarray(ids), width=width))


@pytest.mark.parametrize("R,cap", [(1, 8), (2, 8), (5, 8), (7, 4), (6, 2)])
def test_fold_prefix_runs_equals_jax(R, cap):
    """Prefix-compacted runs (valid ids first, as `lookup_items` gives),
    odd R passing its last run through, and pairs over 1.5·cap."""
    rng = np.random.default_rng(R * 10 + cap)
    runs = rng.integers(0, 1000, (6, R, cap)).astype(np.int32)
    fill = rng.integers(0, cap + 1, (6, R))
    fill[0] = cap                                 # every pair overflows
    runs[np.arange(cap)[None, None, :] >= fill[..., None]] = SENTINEL
    _eq(tret._fold_prefix_runs(torch.from_numpy(runs)),
        jret._fold_prefix_runs(jnp.asarray(runs)))


@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("jk", [False, True])
@pytest.mark.parametrize("grain", ["fine", "coarse"])
def test_candidate_pool_equals_jax(world, grain, jk, tail, fold):
    (jidx, tidx) = world["index"][grain, tail]
    ju, tu = world["users"]
    kw = dict(n_seeds=8, cap=8, fold_mates=fold, tail_scan=tail)
    want = jret.candidate_pool(jidx, world["js"]["sp"], ju,
                               JK=world["JK"][0] if jk else None, **kw)
    got = tret.candidate_pool(tidx, world["ts"]["sp"], tu,
                              JK=world["JK"][1] if jk else None, **kw)
    _eq(got, want)
    if tail:          # the tail's clones collide with their sources' seeds
        assert (_np(got) >= 2000).any() and (_np(got) != SENTINEL).any()


@pytest.mark.parametrize("popular", [False, True])
@pytest.mark.parametrize("pool_width", [0, 48, 96])
def test_finalize_candidates_equals_jax(world, pool_width, popular):
    """The pool of `candidate_pool` (J^K, tail): pre-compaction to
    ``pool_width`` (48 truncates the pool), the dedup, the shortlist."""
    (jidx, tidx) = world["index"]["coarse", True]
    ju, tu = world["users"]
    jpool = jret.candidate_pool(jidx, world["js"]["sp"], ju, n_seeds=8,
                                cap=8, JK=world["JK"][0])
    pop = np.arange(500, 2000, 94, dtype=np.int32)             # 16 ids
    want = jret.finalize_candidates(
        jpool, C=64, pool_width=pool_width,
        popular=jnp.asarray(pop) if popular else None)
    got = tret.finalize_candidates(
        _t(jpool), C=64, pool_width=pool_width,
        popular=torch.from_numpy(pop) if popular else None)
    _eq(got, want)
    if popular:
        _eq(got[:, -16:], np.broadcast_to(pop, (got.shape[0], 16)))


def test_finalize_candidates_refuses_a_budget_below_the_shortlist():
    with pytest.raises(ValueError, match="must exceed the shortlist"):
        tret.finalize_candidates(torch.zeros((2, 8), dtype=torch.int32),
                                 C=16, popular=torch.arange(16,
                                                            dtype=torch.int32))


@pytest.mark.parametrize("grain,tail,C,n_seeds,cap,jk", [
    ("fine", False, 128, 8, 8, True), ("fine", True, 64, 4, 8, False),
    ("coarse", True, 48, 16, 4, True), ("coarse", False, 512, 8, 16, True)])
def test_retrieve_for_users_equals_jax(world, grain, tail, C, n_seeds, cap,
                                       jk):
    (jidx, tidx) = world["index"][grain, tail]
    ju, tu = world["users"]
    pop = np.arange(16, dtype=np.int32) * 7
    kw = dict(n_seeds=n_seeds, cap=cap, C=C, tail_scan=tail)
    want = jret.retrieve_for_users(jidx, world["js"]["sp"], ju,
                                   JK=world["JK"][0] if jk else None,
                                   popular=jnp.asarray(pop), **kw)
    got = tret.retrieve_for_users(tidx, world["ts"]["sp"], tu,
                                  JK=world["JK"][1] if jk else None,
                                  popular=torch.from_numpy(pop), **kw)
    _eq(got, want)
    assert got.shape == (tu.shape[0], C) and got.dtype == torch.int32


@pytest.mark.parametrize("grain,cap,C", [("fine", 4, 16), ("coarse", 8, 64),
                                         ("coarse", 8, 8)])
def test_retrieve_for_items_equals_jax(world, grain, cap, C):
    (jidx, tidx) = world["index"][grain, True]
    items = np.concatenate([np.arange(0, 2000, 97),
                            [2001, 2007, SENTINEL]]).astype(np.int32)
    _eq(tret.retrieve_for_items(tidx, torch.from_numpy(items), cap=cap, C=C),
        jret.retrieve_for_items(jidx, jnp.asarray(items), cap=cap, C=C))


# ------------------------------------------------------ plain walk path


def _seeds(world, n_seeds):
    ju, _ = world["users"]
    s = np.array(jret.seed_items(world["js"]["sp"], ju, n_seeds=n_seeds))
    s[1, :2] = [-3, 5000]                         # out of range: invalid
    return jnp.asarray(s), torch.from_numpy(s)


@pytest.mark.parametrize("grain,n_seeds,cap", [
    ("fine", 8, 8), ("coarse", 5, 4), ("coarse", 16, 2), ("coarse", 3, 16)])
def test_window_descriptors_equals_jax(world, grain, n_seeds, cap):
    (jidx, tidx) = world["index"][grain, False]
    js, ts = _seeds(world, n_seeds)
    want = jret.window_descriptors(jidx, js, cap=cap)
    got = tret.window_descriptors(tidx, ts, cap=cap)
    for g, w in zip(got, want):
        _eq(g, w)
    if grain == "coarse":        # seeds share buckets: windows were merged
        cnt = _np(got[1])
        assert (cnt[2:] == 0).any() and (cnt > 0).any()


@pytest.mark.parametrize("budget", [8, 64, 256, 1024])
def test_enumerate_windows_equals_jax(world, budget):
    """Budgets below a user's window mass truncate later intervals."""
    (jidx, tidx) = world["index"]["coarse", False]
    js, ts = _seeds(world, 16)
    starts, counts = jret.window_descriptors(jidx, js, cap=8)
    want = jret.enumerate_windows(starts, counts, budget=budget)
    got = tret.enumerate_windows(_t(starts), _t(counts), budget=budget)
    _eq(got, want)
    total = np.asarray(counts).sum(1)
    if budget < total.max():
        assert (_np(got) >= 0).all(1).any()           # a truncated user


@pytest.mark.parametrize("grain,budget,n_seeds", [
    ("fine", 64, 8), ("fine", 256, 8), ("coarse", 512, 16),
    ("coarse", 96, 8)])
def test_walk_candidates_equals_jax(world, grain, budget, n_seeds):
    (jidx, tidx) = world["index"][grain, False]
    ju, tu = world["users"]
    kw = dict(n_seeds=n_seeds, cap=8, budget=budget)
    want = jret.walk_candidates(jidx, world["js"]["sp"], ju, **kw)
    got = tret.walk_candidates(tidx, world["ts"]["sp"], tu, **kw)
    _eq(got[0], want[0])
    _eq(got[1], want[1])


# ------------------------------------------- scoring and selection


@pytest.mark.parametrize("topn", [5, 12])
def test_select_topn_masked_equals_jax(topn):
    """Duplicate ids across slots, exact ties (scores rounded to 0.5),
    NEG-masked slots and rows with fewer than topn distinct ids."""
    rng = np.random.default_rng(topn)
    cand = rng.integers(0, 30, (9, 80)).astype(np.int32)
    s = np.round(rng.normal(size=(9, 80)) * 2) / 2
    s = s.astype(np.float32)
    cand[0, :] = 7                                # one distinct id
    s[1, :] = -3e38                               # an exhausted row
    cand[2, 40:] = SENTINEL
    s[2, 40:] = -3e38
    ws, wi = jsvc._select_topn_masked(jnp.asarray(s), jnp.asarray(cand),
                                      topn=topn)
    gs, gi = tsvc._select_topn_masked(torch.from_numpy(s),
                                      torch.from_numpy(cand), topn=topn)
    _eq(gi, wi)
    _eq(gs, ws)
    assert (_np(gi)[1] == SENTINEL).all()
    assert _np(gi)[0, 0] == 7 and (_np(gi)[0, 1:] == SENTINEL).all()


@pytest.mark.parametrize("popular", [False, True])
def test_score_pool_equals_jax(world, popular):
    (jidx, tidx) = world["index"]["fine", False]
    ju, tu = world["users"]
    ids, _ = jret.walk_candidates(jidx, world["js"]["sp"], ju, n_seeds=8,
                                  cap=8, budget=128)
    pop = np.arange(40, 2000, 125, dtype=np.int32)
    jplanes = jsvc.model.pack_serve_planes(world["js"]["params"])
    tplanes = tsvc.pack_serve_planes(world["ts"]["params"])
    ws, wc = jsvc._score_pool(jplanes, ju, ids,
                              jnp.asarray(pop) if popular else None,
                              tile_b=16)
    gs, gc = tsvc._score_pool(tplanes, tu, _t(ids),
                              torch.from_numpy(pop) if popular else None,
                              tile_b=16)
    _eq(gc, wc)
    np.testing.assert_allclose(_np(gs), np.asarray(ws), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("popular", [False, True])
@pytest.mark.parametrize("tail_k", [0, 16])
def test_recommend_walked_equals_jax(world, tail_k, popular):
    (jidx, tidx) = world["index"]["coarse" if popular else "fine", True]
    ju, tu = world["users"]
    pop = np.arange(3, 2000, 125, dtype=np.int32)
    jplanes = jsvc.model.pack_serve_planes(world["js"]["params"])
    tplanes = tsvc.pack_serve_planes(world["ts"]["params"])
    kw = dict(n_seeds=8, cap=8, budget=256, window=64, tail_k=tail_k,
              topn=10, tile_b=16)
    ws, wi = jsvc.recommend_walked(jplanes, jidx, world["js"]["sp"], ju,
                                   jnp.asarray(pop) if popular else None,
                                   **kw)
    gs, gi = tsvc.recommend_walked(tplanes, tidx, world["ts"]["sp"], tu,
                                   torch.from_numpy(pop) if popular else None,
                                   **kw)
    _eq(gi, wi)
    np.testing.assert_allclose(_np(gs), np.asarray(ws), rtol=1e-5, atol=1e-5)
    if tail_k and not popular:     # tail clones reach the top-10
        assert (_np(gi) >= 2000).any() and (_np(gi) != SENTINEL).any()


@pytest.mark.parametrize("grain,tail,jk,pool_width", [
    ("fine", False, True, 0), ("fine", True, False, 0),
    ("coarse", True, True, 160)])
def test_recommend_candidates_ref_equals_jax(world, grain, tail, jk,
                                             pool_width):
    (jidx, tidx) = world["index"][grain, tail]
    ju, tu = world["users"]
    pop = np.arange(11, 2000, 125, dtype=np.int32)
    jplanes = jsvc.model.pack_serve_planes(world["js"]["params"])
    tplanes = tsvc.pack_serve_planes(world["ts"]["params"])
    kw = dict(n_seeds=8, cap=8, C=128, window=64, pool_width=pool_width,
              fold_mates=True, tail_scan=tail, topn=10, tile_b=8)
    ws, wi = jsvc.recommend_candidates(
        jplanes, jidx, world["js"]["sp"], ju,
        world["JK"][0] if jk else None, jnp.asarray(pop), interpret=True,
        impl="ref", **kw)
    gs, gi = tsvc.recommend_candidates(
        tplanes, tidx, world["ts"]["sp"], tu,
        world["JK"][1] if jk else None, torch.from_numpy(pop), impl="ref",
        **kw)
    _eq(gi, wi)
    np.testing.assert_allclose(_np(gs), np.asarray(ws), rtol=1e-5, atol=1e-5)
