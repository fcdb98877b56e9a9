"""Port vs JAX package, end to end: `RecsysService` on the kernel path.

From one planted catalog (N = 2,000) both services serve the same users
from identical state: the JAX package's `RecsysService` with the Pallas
kernels in interpret mode, the port's on the CPU (its kernels' plain
versions).  Top-10 ids must be equal and scores within 1e-5.  The rest
pins the service's request plane, the exact `full_topn` (tie order
included) and the knobs left to later slices.
"""
import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import RecsysService as JService
from repro.serve import ServeConfig as JConfig
from repro.serve import full_topn as jfull_topn
from repro.serve import insert as jinsert
from repro.serve import popular_shortlist as jpopular
from repro_torch.kernels.candidate_score import kernel as score_kernel
from repro_torch.kernels.lsh_retrieve import kernel as lsh_kernel
from repro_torch.kernels.lsh_retrieve.ops import retrieve_candidates
from repro_torch.resil import PoisonBatchError
from repro_torch.serve import (RecsysService, ServeConfig, full_topn, insert,
                               popular_shortlist, recommend_walked_kernel)
from repro_torch.serve.index import signatures_of
from test_torch_serve_index import planted_state

SENTINEL = 2 ** 31 - 1
KW = dict(topn=10, micro_batch=32, C=128, n_seeds=8, cap=8, n_popular=16,
          tile_b=8, band_budget=256)


@pytest.fixture(scope="module")
def state():
    return planted_state(tail_cap=32)


def _with_tail(state):
    """Both indexes with six cloned items resident in the tail."""
    js, ts = state
    src = np.asarray([1, 60, 333, 1200, 1500, 1999])
    ids = np.arange(2000, 2006, dtype=np.int32)
    sigs = np.asarray(js["sigs"])[:, src]
    return (jinsert(js["index"], jnp.asarray(sigs), jnp.asarray(ids)),
            insert(ts["index"], torch.tensor(sigs), torch.tensor(ids)))


def _serve(svc, users):
    svc.warmup()
    svc.submit(users)
    svc.flush()
    res = svc.take_results()
    return (np.concatenate([r[0] for r in res]),
            np.concatenate([r[1] for r in res]),
            np.concatenate([r[2] for r in res]))


@pytest.mark.parametrize("tail", [False, True])
def test_service_top10_equals_jax_kernel_path(state, tail):
    js, ts = state
    jidx, tidx = _with_tail(state) if tail else (js["index"], ts["index"])
    users = np.random.default_rng(7).integers(0, js["sp"].M, 70).astype(
        np.int32)
    jsvc = JService(js["params"], jidx, js["sp"],
                    JConfig(impl="pallas", interpret=True, **KW))
    tsvc = RecsysService(ts["params"], tidx, ts["sp"], ServeConfig(**KW),
                         device="cpu")
    ju, jscore, jitems = _serve(jsvc, users)
    tu, tscore, titems = _serve(tsvc, users)
    np.testing.assert_array_equal(tu, users)
    np.testing.assert_array_equal(titems, jitems)
    np.testing.assert_allclose(tscore, jscore, rtol=1e-5, atol=1e-5)
    assert (titems != SENTINEL).all()
    if tail:       # the tail was walked: tail items are among candidates
        cand = retrieve_candidates(
            tidx, ts["sp"], torch.tensor(users), n_seeds=8, cap=8, C=128,
            popular=tsvc.popular, tail_scan=True)
        assert ((cand >= 2000) & (cand != SENTINEL)).any()


def test_full_mode_matches_jax(state):
    js, ts = state
    users = np.arange(0, 1280, 97, dtype=np.int32)
    s_w, i_w = jfull_topn(js["params"], jnp.asarray(users), topn=10)
    s, i = full_topn(ts["params"], torch.tensor(users), topn=10)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_w), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_w))
    svc = RecsysService(ts["params"], ts["index"], ts["sp"],
                        ServeConfig(mode="full", **KW), device="cpu")
    _, s2, i2 = _serve(svc, users)
    np.testing.assert_array_equal(i2, i.numpy())


def test_popular_shortlist_breaks_ties_like_top_k(state):
    js, ts = state
    bh = np.round(np.asarray(js["params"].bh), 1)      # many equal offsets
    jp = dataclasses.replace(js["params"], bh=jnp.asarray(bh))
    tp = dataclasses.replace(ts["params"], bh=torch.tensor(bh))
    np.testing.assert_array_equal(popular_shortlist(tp, 64).numpy(),
                                  np.asarray(jpopular(jp, 64)))


def test_recall_against_exact_scoring(state):
    """Candidate retrieval finds most of the exact top-10 on the planted
    catalog (the JAX package's walk path gets the same answer, above)."""
    _, ts = state
    users = np.arange(0, 1280, 5, dtype=np.int32)
    svc = RecsysService(ts["params"], ts["index"], ts["sp"],
                        ServeConfig(**KW), device="cpu")
    _, _, got = _serve(svc, users)
    _, want = full_topn(ts["params"], torch.tensor(users), topn=10)
    hits = sum(len(set(g) & set(w)) for g, w in zip(got, want.numpy()))
    assert hits / got.size > 0.5


def test_ref_and_auto_agree_and_launch_nothing_on_cpu(state):
    _, ts = state
    svc = RecsysService(ts["params"], ts["index"], ts["sp"],
                        ServeConfig(**KW), device="cpu")
    users = torch.arange(40, dtype=torch.int32)
    before = (lsh_kernel.LAUNCHES, score_kernel.LAUNCHES)
    kw = dict(n_seeds=8, cap=8, C=128, window=64, tail_scan=False, topn=10,
              tile_b=8)
    a = recommend_walked_kernel(svc.planes, svc.index, svc.sp, users,
                                svc.popular, svc._flat_ids(), impl="auto",
                                **kw)
    b = recommend_walked_kernel(svc.planes, svc.index, svc.sp, users,
                                svc.popular, svc._flat_ids(), impl="ref",
                                **kw)
    assert torch.equal(a[1], b[1]) and torch.equal(a[0], b[0])
    assert (lsh_kernel.LAUNCHES, score_kernel.LAUNCHES) == before


def test_request_plane_order_padding_and_stats(state):
    _, ts = state
    cfg = dataclasses.replace(ServeConfig(**KW), micro_batch=16)
    svc = RecsysService(ts["params"], ts["index"], ts["sp"], cfg,
                        device="cpu")
    chunks = [np.arange(5), np.arange(100, 130), np.asarray([7])]
    for c in chunks:
        svc.submit(c)
    assert svc.stats()["queue"] == 4            # 36 submitted, 2 flushed
    assert svc.flush_some(0) == 0
    svc.flush()
    res = svc.take_results()
    assert [r[0].shape[0] for r in res] == [16, 16, 4]
    np.testing.assert_array_equal(np.concatenate([r[0] for r in res]),
                                  np.concatenate(chunks))
    for u, s, i in res:
        assert s.shape == i.shape == (u.shape[0], 10)
    st = svc.stats()
    assert (st["batches"], st["users"], st["queue"]) == (3, 36, 0)
    assert st["qps"] > 0 and st["p99_ms"] >= st["p50_ms"] > 0
    assert st["device"] == "cpu" and svc.take_results() == []


def test_flush_some_leaves_the_rest_queued(state):
    _, ts = state
    cfg = dataclasses.replace(ServeConfig(**KW), micro_batch=8)
    svc = RecsysService(ts["params"], ts["index"], ts["sp"], cfg,
                        device="cpu")
    svc.submit(np.arange(20))           # dispatches 2 micro-batches
    assert svc.stats()["queue"] == 4
    assert svc.flush_some(0) == 0       # syncs what is in flight only
    assert [r[0].shape[0] for r in svc.take_results()] == [8, 8]
    assert svc.flush_some(3) == 1       # the padded remainder
    assert svc.stats()["queue"] == 0
    assert [r[0].shape[0] for r in svc.take_results()] == [4]


@pytest.mark.parametrize("knob", [dict(shards=2), dict(shards="auto"),
                                  dict(band_budget=0), dict(shards=1),
                                  dict(shards=4)])
def test_later_slice_knobs_raise(knob):
    with pytest.raises(NotImplementedError, match="later slice"):
        ServeConfig(**knob)


@pytest.mark.parametrize("method", ["ingest", "ingest_online_update",
                                    "request_rebuild"])
def test_ingest_and_rebuild_raise(state, method):
    """The two ingest entry points refuse a poisoned input before touching
    anything (`tests/test_torch_ingest.py` holds them against the JAX
    package); `request_rebuild` hands the signatures to the background
    rebuilder, and the validated index swaps in at the next flush
    (`tests/test_torch_service_resil.py` holds it against the JAX
    package)."""
    _, ts = state
    svc = RecsysService(ts["params"], ts["index"], ts["sp"],
                        ServeConfig(**KW), device="cpu")
    if method == "request_rebuild":
        before = svc.index
        svc.request_rebuild(signatures_of(before))
        assert svc.stats()["index_stale"]
        svc._rebuilder.join(60)
        svc.flush()                       # the swap lands at a loop edge
        assert svc.index is not before and not svc.stats()["index_stale"]
        assert svc.obs.counter("serve.rebuild.swaps") == 1
        for f in ("sorted_sigs", "sorted_ids", "bucket_lo", "bucket_hi"):
            assert torch.equal(getattr(svc.index, f), getattr(before, f))
        return
    poison = dict(
        ingest=(None, None),
        ingest_online_update=(SimpleNamespace(
            S=np.full((10, 2001, 16), np.nan, np.float32), N=2001), 2000))
    before = svc.index
    with pytest.raises(PoisonBatchError):
        getattr(svc, method)(*poison[method])
    assert svc.index is before and svc.stats()["quarantined"] == 1


def test_full_topn_breaks_ties_like_top_k(state):
    """Equal scores keep the lower item id first, as `lax.top_k`: items
    500–999 get zero V rows and equal b̂, so every user scores them alike
    (ROADMAP's repro of the tie fault, where `torch.topk` returned
    505, 503, 504, …)."""
    js, ts = state
    V = np.asarray(js["params"].V).copy()
    bh = np.asarray(js["params"].bh).copy()
    V[500:1000] = 0.0
    bh[500:1000] = 50.0
    jp = dataclasses.replace(js["params"], V=jnp.asarray(V),
                             bh=jnp.asarray(bh))
    tp = dataclasses.replace(ts["params"], V=torch.tensor(V),
                             bh=torch.tensor(bh))
    users = np.arange(0, 1280, 61, dtype=np.int32)
    for topn in (10, 37):
        s_w, i_w = jfull_topn(jp, jnp.asarray(users), topn=topn)
        s, i = full_topn(tp, torch.tensor(users), topn=topn)
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_w))
        np.testing.assert_allclose(s.numpy(), np.asarray(s_w), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(i.numpy()[:, :10],
                                      np.broadcast_to(np.arange(500, 510),
                                                      (len(users), 10)))


def test_config_validates_mode_and_impl():
    with pytest.raises(ValueError):
        ServeConfig(mode="sharded")
    with pytest.raises(ValueError):
        ServeConfig(impl="pallas")


def test_service_defaults_to_the_card(state, monkeypatch):
    _, ts = state
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RecsysService(ts["params"], ts["index"], ts["sp"], ServeConfig(**KW))
