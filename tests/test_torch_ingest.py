"""Port vs JAX package: the serving side of online ingestion —
`RecsysService.ingest` / `ingest_online_update` and the index's ingest
helpers (`lookup_items`, `lookup_signatures`, `signatures_of`,
`needs_rebuild`, `rebuild`).

Both services run with ``background_rebuild=False`` (the synchronous
rebuild; `tests/test_torch_service_resil.py` holds the background one)
and the JAX package's Pallas kernels in interpret mode; the port's runs
on the CPU (its kernels' plain versions).  From identical state, after each ingest, the tail
contents and every index array must be equal, served ids bit-exact and
scores within 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import model as jmodel
from repro.core import online as jonline
from repro.core import simlsh as jsim
from repro.core import topk as jtopk
from repro.core.sgd import Hyper as JHyper
from repro.data import sparse as jsparse
from repro.data import synthetic as jsyn
from repro.serve import RecsysService as JService
from repro.serve import ServeConfig as JConfig
from repro.serve import build_index as jbuild
from repro.serve import index as jindex
from repro_torch.resil import PoisonBatchError, faults
from repro_torch.resil.faults import FaultSpec, InjectedFault
from repro_torch.serve import (RecsysService, ServeConfig, build_index,
                               insert)
from repro_torch.serve import index as tindex
from test_torch_online import _delta, _port_state
from test_torch_serve_index import LSH, planted_catalog

SENTINEL = 2 ** 31 - 1
INDEX_ARRAYS = ("sorted_sigs", "sorted_ids", "bucket_lo", "bucket_hi",
                "slot_of", "tail_sigs", "tail_ids")
KW = dict(topn=10, micro_batch=32, C=128, n_seeds=8, cap=8, n_popular=16,
          tile_b=8, band_budget=256)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _services(params, sp, sigs, n_base, tail_cap, kw=KW):
    """Both packages' services over the first ``n_base`` items' index."""
    jp, tp = params
    jsp, tsp = sp
    jsvc = JService(jp, jbuild(jnp.asarray(sigs[:, :n_base]),
                               tail_cap=tail_cap), jsp,
                    JConfig(impl="pallas", interpret=True,
                            background_rebuild=False, **kw))
    tsvc = RecsysService(tp, build_index(torch.tensor(sigs[:, :n_base]),
                                         tail_cap=tail_cap, device="cpu"),
                         tsp, ServeConfig(background_rebuild=False, **kw),
                         device="cpu")
    return jsvc, tsvc


def _serve(svc, users):
    svc.submit(users)
    svc.flush()
    res = svc.take_results()
    return (np.concatenate([r[1] for r in res]),
            np.concatenate([r[2] for r in res]))


def assert_same_index(tidx, jidx):
    assert (tidx.n_base, tidx.tail_cap, tidx.tail_fill) == \
        (jidx.n_base, jidx.tail_cap, jidx.tail_fill)
    for f in INDEX_ARRAYS:
        np.testing.assert_array_equal(_np(getattr(tidx, f)),
                                      np.asarray(getattr(jidx, f)), f)


def assert_same_answers(jsvc, tsvc, users):
    js, ji = _serve(jsvc, users)
    ts, ti = _serve(tsvc, users)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-5)
    return ti


@pytest.fixture(scope="module")
def world():
    """A planted catalog (N = 2,000) in both packages, its signatures
    encoded once by the JAX package."""
    from repro_torch import convert
    U, V, bh, rows, cols, vals, M = planted_catalog(2000)
    N = V.shape[0]
    z = np.zeros((N, 1), np.float32)
    jp = jmodel.Params(U=jnp.asarray(U), V=jnp.asarray(V),
                       b=jnp.zeros((M,), jnp.float32), bh=jnp.asarray(bh),
                       W=jnp.asarray(z), C=jnp.asarray(z),
                       mu=jnp.asarray(3.0, jnp.float32))
    jsp = jsparse.from_coo(rows, cols, vals, (M, N))
    sigs = np.asarray(jsim.encode(jsp, jsim.SimLSHConfig(**LSH),
                                  jax.random.PRNGKey(0)))
    tp = convert.params_from_numpy(U, V, np.zeros(M), bh, z, z, 3.0,
                                   device="cpu")
    tsp = convert.sparse_from_numpy(np.asarray(jsp.rows),
                                    np.asarray(jsp.cols),
                                    np.asarray(jsp.vals), (M, N),
                                    device="cpu")
    users = np.random.default_rng(5).integers(0, M, 64).astype(np.int32)
    return (jp, tp), (jsp, tsp), sigs, users


def test_ingest_insert_then_overflow_rebuild_match_jax(world):
    """1,900 items indexed; 20 more go to the tail (insert), then 80 more
    overflow the 32-slot tail and the index is rebuilt from all 2,000."""
    params, sp, sigs, users = world
    jsvc, tsvc = _services(params, sp, sigs, 1900, 32)
    jsvc.warmup()
    tsvc.warmup()
    ids = np.arange(1900, 1920, dtype=np.int32)
    jsvc.ingest(jnp.asarray(sigs[:, 1900:1920]), jnp.asarray(ids))
    tsvc.ingest(torch.tensor(sigs[:, 1900:1920]), torch.tensor(ids))
    assert tsvc.index.tail_fill == 20 and tsvc.index.n_items == 1920
    assert_same_index(tsvc.index, jsvc.index)
    items = assert_same_answers(jsvc, tsvc, users)
    assert ((items >= 1900) & (items < 1920)).any()    # tail items served
    st = tsvc.stats()
    assert st["ingest_to_servable_s"] > 0 and st["quarantined"] == 0
    assert tsvc.obs.counter("serve.ingests") == 1
    assert tsvc.obs.counter("serve.ingested_items") == 20

    ids2 = np.arange(1920, 2000, dtype=np.int32)
    assert tindex.needs_rebuild(tsvc.index, 80)
    jsvc.ingest(jnp.asarray(sigs[:, 1920:]), jnp.asarray(ids2),
                full_sigs=jnp.asarray(sigs))
    tsvc.ingest(sigs[:, 1920:], ids2, full_sigs=torch.tensor(sigs))
    assert tsvc.index.tail_fill == 0 and tsvc.index.n_base == 2000
    assert_same_index(tsvc.index, jsvc.index)
    assert_same_index(tsvc.index, build_index(torch.tensor(sigs),
                                              tail_cap=32, device="cpu"))
    assert len(tsvc.obs.span_durations("serve.ingest.rebuild")) == 1
    assert len(tsvc.obs.span_durations("serve.ingest.warmup")) == 2
    assert_same_answers(jsvc, tsvc, users)
    assert tsvc.obs.counter("serve.ingested_items") == 100


def test_ingest_overflow_needs_full_sigs(world):
    params, sp, sigs, _ = world
    _, tsvc = _services(params, sp, sigs, 1990, 4)
    with pytest.raises(ValueError, match="full_sigs"):
        tsvc.ingest(sigs[:, 1990:], np.arange(1990, 2000, dtype=np.int32))


@pytest.mark.parametrize("poison", ["float_sigs", "duplicate_ids",
                                    "negative_ids", "wrong_bands"])
def test_ingest_quarantines_poison_batches(world, poison):
    params, sp, sigs, _ = world
    _, tsvc = _services(params, sp, sigs, 1900, 32)
    s, i = sigs[:, 1900:1904], np.arange(1900, 1904, dtype=np.int32)
    s, i = dict(float_sigs=(s.astype(np.float32), i),
                duplicate_ids=(s, np.asarray([1900, 1901, 1900, 1903])),
                negative_ids=(s, i - 5000),
                wrong_bands=(s[:4], i))[poison]
    before = tsvc.index
    with pytest.raises(PoisonBatchError):
        tsvc.ingest(s, i)
    assert tsvc.index is before and tsvc.stats()["quarantined"] == 1
    assert tsvc.obs.counter("serve.ingests") == 0


def test_ingest_fires_its_fault_site_before_touching_the_index(world):
    params, sp, sigs, _ = world
    _, tsvc = _services(params, sp, sigs, 1900, 32)
    before = tsvc.index
    with faults.injected({"serve.ingest": FaultSpec(at_calls=(0,))}):
        with pytest.raises(InjectedFault):
            tsvc.ingest(sigs[:, 1900:1902], np.asarray([1900, 1901]))
        tsvc.ingest(sigs[:, 1900:1902], np.asarray([1900, 1901]))
    assert before.tail_fill == 0 and tsvc.index.tail_fill == 2


def test_service_ingest_serves_new_items(world):
    """`tests/test_serve.py::test_service_ingest_serves_new_items` on the
    port: a clone of item 0's signature, ingested as a new item, joins
    item 0's buckets."""
    (_, tp), (_, tsp), sigs, _ = world
    svc = RecsysService(tp, build_index(torch.tensor(sigs), tail_cap=8,
                                        device="cpu"), tsp,
                        ServeConfig(topn=5, micro_batch=8, C=48, n_seeds=4,
                                    cap=8, n_popular=0), device="cpu")
    svc.ingest(torch.tensor(sigs[:, :1]), torch.tensor([2000],
                                                       dtype=torch.int32))
    assert svc.index.n_items == 2001
    cand = tindex.lookup_items(svc.index, torch.tensor([0], dtype=torch.int32),
                               cap=8)
    assert 2000 in cand[0].tolist()
    # and the clone's own probe (a tail-resident query) finds item 0
    cand = tindex.lookup_items(svc.index, torch.tensor([2000]), cap=8)
    assert 0 in cand[0].tolist()


# --------------------------------------------------- index ingest helpers

@pytest.fixture(scope="module")
def indexes(world):
    """Both packages' index of the first 1,990 items, 6 of the rest and 4
    clones of base items in the tail."""
    _, _, sigs, _ = world
    src = np.asarray([1990, 1991, 1992, 1993, 1994, 1995, 3, 700, 701, 1500])
    ids = np.arange(1990, 2000, dtype=np.int32)
    j = jindex.insert(jbuild(jnp.asarray(sigs[:, :1990]), tail_cap=16),
                      jnp.asarray(sigs[:, src]), jnp.asarray(ids))
    t = insert(build_index(torch.tensor(sigs[:, :1990]), tail_cap=16,
                           device="cpu"), torch.tensor(sigs[:, src]),
               torch.tensor(ids))
    return j, t, sigs


@pytest.mark.parametrize("include_tail,assume_base",
                         [(True, False), (False, False), (True, True),
                          (False, True)])
@pytest.mark.parametrize("cap", [4, 8])
def test_lookup_items_matches_jax(indexes, include_tail, assume_base, cap):
    j, t, _ = indexes
    ids = np.concatenate([np.arange(0, 1990, 97), [1990, 1995, 1999],
                          [SENTINEL, -4, 5000]]).astype(np.int32)
    if assume_base:
        ids = ids[(ids >= 0) & (ids < 1990)]
    want = jindex.lookup_items(j, jnp.asarray(ids), cap=cap,
                               include_tail=include_tail,
                               assume_base=assume_base)
    got = tindex.lookup_items(t, torch.tensor(ids), cap=cap,
                              include_tail=include_tail,
                              assume_base=assume_base)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("n_probe", [1, 3])
def test_lookup_signatures_matches_jax(indexes, n_probe):
    j, t, sigs = indexes
    q = sigs[:, np.r_[0:1990:61, 1990:2000]].T.copy()       # [B, q]
    q[0] = 12345
    want = jindex.lookup_signatures(j, jnp.asarray(q), cap=4,
                                    n_probe=n_probe)
    got = tindex.lookup_signatures(t, torch.tensor(q), cap=4,
                                   n_probe=n_probe)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_signatures_of_needs_rebuild_and_rebuild_match_jax(indexes):
    j, t, sigs = indexes
    np.testing.assert_array_equal(_np(tindex.signatures_of(t)),
                                  np.asarray(jindex.signatures_of(j)))
    np.testing.assert_array_equal(_np(tindex.signatures_of(t)),
                                  sigs[:, :1990])
    for n in (0, 6, 7):
        assert tindex.needs_rebuild(t, n) == jindex.needs_rebuild(j, n)
    assert_same_index(tindex.rebuild(t, torch.tensor(sigs)),
                      jindex.rebuild(j, jnp.asarray(sigs)))


def test_tail_matches_matches_jax(indexes):
    j, t, sigs = indexes
    qsig = sigs[:, [1990, 3, 0, 1500]]                        # [q, B]
    for b in (0, 5):
        want = jindex._tail_matches(j, j.tail_sigs[b], jnp.asarray(qsig[b]),
                                    width=4)
        got = tindex._tail_matches(t, t.tail_sigs[b], torch.tensor(qsig[b]),
                                   width=4)
        np.testing.assert_array_equal(_np(got), np.asarray(want))


# ------------------------------------------ the online-update handoff

SMALL_KW = dict(topn=5, micro_batch=16, C=48, n_seeds=4, cap=8, n_popular=8,
                tile_b=8, band_budget=256)


@pytest.fixture(scope="module")
def online_world():
    """`tests/test_online.py::small_state` with a 16-slot index, and two
    JAX online updates (+20 users and +12 items each) that both services
    adopt, carried to the port through numpy."""
    spec = dataclasses.replace(jsyn.MOVIELENS_LIKE, M=300, N=80, nnz=6000)
    rows, cols, vals, _ = jsyn.generate(spec, seed=0)
    sp = jsparse.from_coo(rows, cols, vals, (spec.M, spec.N))
    cfg = jsim.SimLSHConfig(G=8, p=1, q=6)
    key = jax.random.PRNGKey(0)
    sigs, S = jsim.encode(sp, cfg, key, return_accumulators=True)
    JK = jtopk.topk_from_signatures(sigs, jax.random.PRNGKey(1), K=8,
                                    band_cap=cfg.band_cap)
    params = jmodel.init_from_data(jax.random.PRNGKey(2), sp, 16, 8)
    st0 = jonline.OnlineState(params=params, S=S, JK=JK, sp=sp, M=spec.M,
                              N=spec.N, hash_key=key)
    states = [st0]
    for k in range(2):
        st = states[-1]
        M2, N2 = st.M + 20, st.N + 12
        nr, nc, nv = _delta(st, M2, N2, n=600, seed=20 + k)
        states.append(jonline.online_update(
            st, jnp.asarray(nr), jnp.asarray(nc), jnp.asarray(nv), cfg,
            JHyper(), jax.random.PRNGKey(30 + k), M_new=M2, N_new=N2, K=8,
            epochs=1))
    return states, np.asarray(sigs)


def test_ingest_online_update_matches_jax(online_world):
    states, sigs = online_world
    st0 = states[0]
    tst0 = _port_state(st0, np.asarray(st0.hash_key))
    jsvc = JService(st0.params, jbuild(jnp.asarray(sigs), tail_cap=16),
                    st0.sp, JConfig(impl="pallas", interpret=True,
                                    background_rebuild=False, **SMALL_KW))
    tsvc = RecsysService(tst0.params, build_index(torch.tensor(sigs),
                                                  tail_cap=16, device="cpu"),
                         tst0.sp, ServeConfig(background_rebuild=False,
                                              **SMALL_KW), device="cpu")
    rng = np.random.default_rng(3)
    for k, (prev, st) in enumerate(zip(states, states[1:])):
        tst = _port_state(st, np.asarray(st.hash_key))
        jsvc.ingest_online_update(st, prev.N)
        tsvc.ingest_online_update(tst, prev.N)
        np.testing.assert_array_equal(_np(tsvc.planes.row),
                                      np.asarray(jsvc.planes.row))
        np.testing.assert_array_equal(_np(tsvc.planes.col),
                                      np.asarray(jsvc.planes.col))
        np.testing.assert_array_equal(_np(tsvc.popular),
                                      np.asarray(jsvc.popular))
        assert tsvc.sp.shape == (st.M, st.N)
        assert_same_index(tsvc.index, jsvc.index)
        new_sigs = _np(tindex._sig_of_items(
            tsvc.index, torch.arange(prev.N, st.N)))
        np.testing.assert_array_equal(
            new_sigs, np.asarray(jsim.pack_bits(st.S >= 0))[:, prev.N:])
        assert tsvc.index.tail_fill == (12 if k == 0 else 0)   # 2nd: rebuild
        users = np.concatenate([rng.integers(0, prev.M, 24),
                                np.arange(prev.M, st.M)]).astype(np.int32)
        assert_same_answers(jsvc, tsvc, users)
        st_ = tsvc.stats()
        assert st_["ingest_to_servable_s"] > 0 and st_["model_age_s"] >= 0


def test_ingest_online_update_quarantines_nan_accumulators(online_world):
    states, sigs = online_world
    st0, st1 = states[0], states[1]
    tst0 = _port_state(st0, np.asarray(st0.hash_key))
    tsvc = RecsysService(tst0.params, build_index(torch.tensor(sigs),
                                                  tail_cap=16, device="cpu"),
                         tst0.sp, ServeConfig(**SMALL_KW), device="cpu")
    bad = _port_state(st1, np.asarray(st1.hash_key))
    bad.S[2, st0.N + 3, 1] = float("nan")
    before = (tsvc.index, tsvc.planes, tsvc.params)
    with pytest.raises(PoisonBatchError, match=f"column {st0.N + 3}"):
        tsvc.ingest_online_update(bad, st0.N)
    assert all(a is b for a, b in zip((tsvc.index, tsvc.planes,
                                        tsvc.params), before))
    assert tsvc.stats()["quarantined"] == 1
    _, items = _serve(tsvc, np.arange(10, dtype=np.int32))
    assert items.shape == (10, 5) and (items < st0.N).all()
