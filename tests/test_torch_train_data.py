"""Port vs JAX package: the fit's data path — synthetic triples, the
train/test split, rating lookup, baselines, the tiered conflict-free
schedule, the schedule-ordered training data, the eval cache, simLSH
with the port's own threefry Φ, and the Top-K neighbour extraction.

Both packages start from the same numpy triples.  Everything integer is
compared bit for bit; the float planes are gathers of the same values
and must be equal too.  Signature bits may differ only where an
accumulator is within 1e-5 of 0 (`index_add_` sums in another order than
`segment_sum`), as in `test_torch_serve_index.py`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import model as jmodel
from repro.core import simlsh as jsim
from repro.core import topk as jtopk
from repro.data import sparse as jsparse
from repro.data import synthetic as jsyn
from repro_torch import prng
from repro_torch.core import model, simlsh, topk
from repro_torch.data import sparse, synthetic

SPEC = dict(M=200, N=80, nnz=3000)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread is fastest and keeps the test
    workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    spec = dataclasses.replace(synthetic.MOVIELENS_LIKE, **SPEC)
    rows, cols, vals, _ = synthetic.generate(spec, seed=0)
    tr, te = sparse.train_test_split(np.random.default_rng(0), rows, cols,
                                     vals)
    jsp = jsparse.from_coo(*tr, (spec.M, spec.N))
    tsp = sparse.from_coo(*tr, (spec.M, spec.N), device="cpu")
    return spec, tr, te, jsp, tsp


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(_np(a), _np(b), err_msg=msg)


def test_synthetic_and_split_equal_the_reference():
    for spec in (dataclasses.replace(synthetic.MOVIELENS_LIKE, **SPEC),
                 dataclasses.replace(synthetic.MOVIELENS_LIKE, M=90, N=40,
                                     nnz=700, neigh_groups=3)):
        jspec = jsyn.DatasetSpec(**dataclasses.asdict(spec))
        got = synthetic.generate(spec, seed=4)
        want = jsyn.generate(jspec, seed=4)
        for g, w in zip(got, want):
            _eq(g, w)
        a = sparse.train_test_split(np.random.default_rng(1), *got[:3])
        b = jsparse.train_test_split(np.random.default_rng(1), *want[:3])
        for part_a, part_b in zip(a, b):
            for g, w in zip(part_a, part_b):
                _eq(g, w)


def test_lookup_degrees_and_baselines(data):
    spec, _, _, jsp, tsp = data
    rng = np.random.default_rng(3)
    qi = rng.integers(0, spec.M, (300, 6)).astype(np.int32)
    qj = rng.integers(0, spec.N, (300, 6)).astype(np.int32)
    pick = rng.integers(0, tsp.nnz, 300)            # guaranteed hits too
    qi[:, 0], qj[:, 0] = _np(tsp.rows)[pick], _np(tsp.cols)[pick]
    v, hit = sparse.lookup(tsp, torch.tensor(qi), torch.tensor(qj))
    jv, jhit = jsparse.lookup(jsp, jnp.asarray(qi), jnp.asarray(qj))
    _eq(v, jv)
    _eq(hit, jhit)
    assert bool(hit[:, 0].all()) and 0 < float(hit[:, 1:].float().mean())
    for g, w in zip(sparse.degrees(tsp), jsparse.degrees(jsp)):
        _eq(g, w)
    mu, b, bh = sparse.baselines(tsp)
    jmu, jb, jbh = jsparse.baselines(jsp)
    # μ is one float32 sum over all ratings, taken in another order than
    # XLA's (1 ulp apart here); b and b̂ inherit that ulp
    np.testing.assert_allclose(float(mu), float(jmu), rtol=1e-6)
    np.testing.assert_allclose(_np(b), _np(jb), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(bh), _np(jbh), rtol=1e-6, atol=1e-6)


SCHED_ARRAYS = ("order", "shard_starts", "shard_valid", "lo_starts",
                "lo_valid", "lo_scale_i", "lo_scale_j", "row_bounds",
                "col_bounds", "row_map", "col_map")
SCHED_STATIC = ("widths", "shard_width", "shards", "block_rows",
                "block_cols", "shard_span")


@pytest.mark.parametrize("shards,batch,tiers,shrink", [
    (1, 64, 4, 0.5), (1, 512, 4, 0.5), (2, 32, 3, 0.71), (1, 16, 7, 0.71)])
def test_epoch_schedule_arrays_equal(data, shards, batch, tiers, shrink):
    spec, _, _, jsp, tsp = data
    kw = dict(batch=batch, tiers=tiers, tier_shrink=shrink, shards=shards,
              M=spec.M, N=spec.N, seed=3)
    got = sparse.conflict_free_schedule(_np(tsp.rows), _np(tsp.cols), **kw)
    want = jsparse.conflict_free_schedule(np.asarray(jsp.rows),
                                          np.asarray(jsp.cols), **kw)
    for f in SCHED_ARRAYS:
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        _eq(a, b, f)
    for f in SCHED_STATIC:
        assert getattr(got, f) == getattr(want, f), f
    assert len(got.tier_starts) == len(want.tier_starts)
    for t, (s, v) in enumerate(zip(want.tier_starts, want.tier_valid)):
        _eq(got.tier_starts[t], s, f"tier_starts[{t}]")
        _eq(got.tier_valid[t], v, f"tier_valid[{t}]")
        assert got.tier_starts[t].dtype == np.asarray(s).dtype
    assert got.stats() == want.stats()


@pytest.mark.parametrize("shards", [1, 2])
def test_scheduled_data_and_eval_cache_equal(data, shards):
    spec, _, te, jsp, tsp = data
    rng = np.random.default_rng(5)
    JK = rng.integers(0, spec.N, (spec.N, 4)).astype(np.int32)
    kw = dict(batch=32, tiers=3, shards=shards, M=spec.M, N=spec.N, seed=1)
    tsched = sparse.conflict_free_schedule(_np(tsp.rows), _np(tsp.cols),
                                           **kw)
    jsched = jsparse.conflict_free_schedule(np.asarray(jsp.rows),
                                            np.asarray(jsp.cols), **kw)
    for mf_only in (False, True):
        got = model.build_scheduled_data(tsp, torch.tensor(JK), tsched,
                                         mf_only=mf_only, chunk=700)
        want = jmodel.build_scheduled_data(jsp, jnp.asarray(JK), jsched,
                                           mf_only=mf_only)
        for f in ("i", "j", "r", "nb", "rnb", "expl"):
            a, b = getattr(got, f), np.asarray(getattr(want, f))
            assert _np(a).dtype == b.dtype and a.shape == b.shape, f
            _eq(a, b, f)
    te_r, te_c = (torch.tensor(a) for a in te[:2])
    for mf_only in (False, True):
        got = model.build_eval_cache(tsp, torch.tensor(JK), te_r, te_c,
                                     mf_only=mf_only, chunk=50)
        want = jmodel.build_eval_cache(jsp, jnp.asarray(JK),
                                       jnp.asarray(te[0]),
                                       jnp.asarray(te[1]), mf_only=mf_only)
        for f in ("nb", "rnb", "expl"):
            _eq(getattr(got, f), getattr(want, f), f)


def test_remap_unmap_pack_unpack(data):
    spec, _, _, jsp, tsp = data
    sched = sparse.conflict_free_schedule(_np(tsp.rows), _np(tsp.cols),
                                          batch=32, shards=2, M=spec.M,
                                          N=spec.N)
    jsched = jsparse.conflict_free_schedule(
        np.asarray(jsp.rows), np.asarray(jsp.cols), batch=32, shards=2,
        M=spec.M, N=spec.N)
    p = model.init_from_data(prng.PRNGKey(2), tsp, 8, 4)
    p = dataclasses.replace(p, W=torch.randn(spec.N, 4),
                            C=torch.randn(spec.N, 4))
    jp = jmodel.Params(**{f.name: jnp.asarray(_np(getattr(p, f.name)))
                          for f in dataclasses.fields(p)})
    got, want = model.remap_params(p, sched), jmodel.remap_params(jp, jsched)
    for f in ("U", "V", "b", "bh", "W", "C"):
        _eq(getattr(got, f), getattr(want, f), f)
        _eq(getattr(model.unmap_params(got, sched), f), getattr(p, f), f)
    pp = model.pack_params(p)
    jpp = jmodel.pack_params(jp)
    _eq(pp.row, jpp.row)
    _eq(pp.col, jpp.col)
    _eq(pp.bh, jpp.bh)
    back = model.unpack_params(pp)
    for f in ("U", "V", "b", "bh", "W", "C"):
        _eq(getattr(back, f), getattr(p, f), f)


def test_init_params_within_a_few_ulp(data):
    """U, V are threefry normals (≤ 4 ulp from JAX's, `prng.normal`);
    μ, b, b̂ the baselines; W, C zero."""
    spec, _, _, jsp, tsp = data
    got = model.init_from_data(prng.PRNGKey(5), tsp, 16, 4)
    want = jmodel.init_from_data(jax.random.PRNGKey(5), jsp, 16, 4)
    for f in ("U", "V"):
        np.testing.assert_array_max_ulp(_np(getattr(got, f)),
                                        np.asarray(getattr(want, f)),
                                        maxulp=4)
    for f in ("W", "C"):
        _eq(getattr(got, f), getattr(want, f), f)
    for f in ("b", "bh", "mu"):          # the baselines' μ (see above)
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   np.asarray(getattr(want, f)), rtol=1e-6,
                                   atol=1e-6)


# ------------------------------------------------------------ simLSH, Top-K

LSH = dict(G=8, p=1, q=10, band_cap=16)


def test_phi_rows_and_encode_with_the_ports_threefry(data):
    _, _, _, jsp, tsp = data
    key_j, key_t = jax.random.PRNGKey(0), prng.PRNGKey(0)
    ids = torch.arange(0, 200, 3)
    for band in (0, 7):
        _eq(simlsh.phi_rows(key_t, band, ids, 8),
            jsim.phi_rows(key_j, jnp.asarray(band), jnp.asarray(_np(ids)), 8))
    sigs, S = simlsh.encode(tsp, simlsh.SimLSHConfig(**LSH), key_t,
                            return_accumulators=True)
    want, want_S = jsim.encode(jsp, jsim.SimLSHConfig(**LSH), key_j,
                               return_accumulators=True)
    np.testing.assert_allclose(_np(S), np.asarray(want_S), rtol=1e-4,
                               atol=1e-3)
    differ = _np(sigs) != np.asarray(want)
    near0 = (np.abs(np.asarray(want_S)) < 1e-5).any(axis=2)
    assert not np.any(differ & ~near0)
    assert differ.sum() <= 0.001 * differ.size


def test_band_candidates_keep_stable_ties():
    sig = torch.tensor([5, 1, 5, 1, 5, 0, 5, 5, 2], dtype=torch.int32)
    for cap in (1, 2, 4, 5):
        _eq(topk.band_candidates(sig, band_cap=cap),
            jtopk.band_candidates(jnp.asarray(_np(sig)), band_cap=cap))


def test_topk_frequent_ties_and_fill():
    """Equal counts keep the lower id first (`lax.top_k`); deficit rows
    get the random fill, self excluded."""
    S = topk.SENTINEL
    cands = np.array([[3, 1, 3, 1, 2, 2, S, S],      # three-way tie
                      [0, 0, 0, 4, 4, S, S, S],      # self id 1 absent
                      [2, 2, S, S, S, S, S, S],      # only self: all fill
                      [S, S, S, S, S, S, S, S],
                      [1, 0, 2, 3, 1, 0, 2, 3]], np.int32)
    for seed in (0, 9):
        got = topk.topk_frequent(torch.tensor(cands), prng.PRNGKey(seed),
                                 K=3)
        want = jtopk.topk_frequent(jnp.asarray(cands),
                                   jax.random.PRNGKey(seed), K=3)
        _eq(got, want)


def test_topk_from_signatures_equals_reference(data):
    spec = data[0]
    rng = np.random.default_rng(2)
    sigs = rng.integers(0, 6, (10, spec.N)).astype(np.int32)  # big buckets
    for K, cap in ((4, 16), (12, 3)):
        got = topk.topk_from_signatures(torch.tensor(sigs), prng.PRNGKey(1),
                                        K=K, band_cap=cap)
        want = jtopk.topk_from_signatures(jnp.asarray(sigs),
                                          jax.random.PRNGKey(1), K=K,
                                          band_cap=cap)
        _eq(got, want)
    with pytest.raises(TypeError, match="int32"):
        topk.topk_from_signatures(torch.tensor(sigs).long(), prng.PRNGKey(1),
                                  K=4, band_cap=16)
