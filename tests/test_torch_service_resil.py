"""Port vs JAX package: the serving side of the resilience layer —
`RecsysService`'s shedding, degraded answers, `fallback_full`,
quarantine and background rebuild (`tests/test_resil.py`'s service
cases), each run on both services from `test_resil.py::serving`'s state.

The JAX package's service runs its Pallas kernels in interpret mode (the
kernel walk path the port ports); the port's runs on the CPU (its
kernels' plain versions).  Each case installs the same fault plan in each
package's own `faults` module.  The counters must be equal, the served
item ids exact and the scores within 1e-5; a background rebuild must
swap in the same index, and a failed or corrupt one must never be served
by either.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.resil as jresil
from repro.core import model as jmodel
from repro.core import simlsh as jsim
from repro.data import sparse as jsparse
from repro.resil import faults as jfaults
from repro.serve import RecsysService as JService
from repro.serve import ServeConfig as JConfig
from repro.serve import build_index as jbuild
from repro_torch import convert
from repro_torch.kernels import KernelError, KernelValueError
from repro_torch.resil import PoisonBatchError, faults, validate_index
from repro_torch.resil.faults import FaultSpec
from repro_torch.serve import RecsysService, ServeConfig, build_index

SENTINEL = 2 ** 31 - 1
INDEX_ARRAYS = ("sorted_sigs", "sorted_ids", "bucket_lo", "bucket_hi",
                "slot_of", "tail_sigs", "tail_ids")
COUNTERS = ("users", "batches", "shed", "degraded", "dropped", "fallbacks",
            "quarantined", "ingest_rejected", "index_stale", "queue")
KW = dict(topn=5, micro_batch=8, C=32, n_seeds=4, cap=8, n_popular=16)


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    faults.uninstall()
    jfaults.uninstall()


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def serving():
    """`tests/test_resil.py::serving` in both packages: the LAST user has
    no interactions (the zero-candidate edge case) and the tail holds 8,
    so an ingest of 12 overflows it."""
    rng = np.random.default_rng(3)
    M, N = 96, 64
    rows = np.repeat(np.arange(M - 1), 4).astype(np.int32)
    cols = rng.integers(0, N, rows.shape[0]).astype(np.int32)
    vals = rng.integers(1, 6, rows.shape[0]).astype(np.float32)
    jsp = jsparse.from_coo(rows, cols, vals, (M, N))
    sigs = np.asarray(jsim.encode(jsp, jsim.SimLSHConfig(G=8, p=2, q=8),
                                  jax.random.PRNGKey(0)))
    jp = jmodel.init_from_data(jax.random.PRNGKey(1), jsp, 16, 8)
    tp = convert.params_from_numpy(
        **{f: np.asarray(getattr(jp, f)) for f in ("U", "V", "b", "bh", "W",
                                                   "C", "mu")},
        device="cpu")
    tsp = convert.sparse_from_numpy(np.asarray(jsp.rows),
                                    np.asarray(jsp.cols),
                                    np.asarray(jsp.vals), (M, N),
                                    device="cpu")
    return (jp, tp), (jsp, tsp), sigs


def _services(serving, **kw):
    """(JAX service, port service), both warmed up."""
    (jp, tp), (jsp, tsp), sigs = serving
    cfg = dict(KW, **kw)
    jsvc = JService(jp, jbuild(jnp.asarray(sigs), tail_cap=8), jsp,
                    JConfig(impl="pallas", interpret=True, **cfg))
    tsvc = RecsysService(tp, build_index(torch.tensor(sigs), tail_cap=8,
                                         device="cpu"), tsp,
                         ServeConfig(**cfg), device="cpu")
    return jsvc.warmup(), tsvc.warmup()


def _drive(svc, fault_module, plan, users):
    with fault_module.injected(plan):
        svc.submit(users)
        svc.flush()
    return svc.take_results(), svc.stats()


def _assert_same_results(tres, jres):
    assert [r[0].shape[0] for r in tres] == [r[0].shape[0] for r in jres]
    for (tu, ts, ti), (ju, js, ji) in zip(tres, jres):
        np.testing.assert_array_equal(tu, np.asarray(ju))
        np.testing.assert_array_equal(ti, np.asarray(ji))
        np.testing.assert_allclose(ts, np.asarray(js), rtol=1e-5, atol=1e-5)


def _assert_same_counters(tst, jst):
    assert {k: tst[k] for k in COUNTERS} == {k: jst[k] for k in COUNTERS}


def _both(serving, users, *, plan=None, **kw):
    """Run one traffic burst through both services under the same fault
    plan (``plan``: {site: kwargs of FaultSpec}); counters and answers
    must agree.  → (port results, port stats, port service)."""
    jsvc, tsvc = _services(serving, **kw)
    plan = plan or {}
    jres, jst = _drive(jsvc, jfaults, {k: jresil.FaultSpec(**v)
                                       for k, v in plan.items()}, users)
    tres, tst = _drive(tsvc, faults, {k: FaultSpec(**v)
                                      for k, v in plan.items()}, users)
    _assert_same_counters(tst, jst)
    _assert_same_results(tres, jres)
    return tres, tst, tsvc


def test_service_overload_sheds_in_submission_order(serving):
    res, st, svc = _both(serving, np.arange(30, dtype=np.int32),
                         max_pending=12)
    assert st["shed"] == 18 and st["degraded"] == 18 and st["users"] == 30
    assert np.concatenate([r[0] for r in res]).tolist() == list(range(30))
    # degraded rows answer with the popularity shortlist, bias-scored
    pop = svc.popular.numpy()[:5]
    np.testing.assert_array_equal(res[0][2][0], pop)
    p = svc.params
    np.testing.assert_allclose(res[0][1][0], float(p.mu) + p.b[0].item()
                               + p.bh.numpy()[pop], rtol=1e-6)


def test_service_deadline_shedding_under_stall(serving):
    """Flush 0 stalls 0.5 s at dispatch while users 8–15 wait in the
    queue; by flush 1 they are past the 0.25 s deadline and are shed."""
    res, st, _ = _both(serving, np.arange(16, dtype=np.int32),
                       plan={"serve.flush": dict(kind="stall", stall_s=0.5,
                                                 at_calls=(0,))},
                       deadline_s=0.25)
    assert st["shed"] == 8 and st["degraded"] == 8
    assert np.concatenate([r[0] for r in res]).tolist() == list(range(16))


def test_service_drops_when_no_popular_fallback(serving):
    res, st, _ = _both(serving, np.arange(12, dtype=np.int32), n_popular=0,
                       max_pending=4)
    assert st["dropped"] == 8 and st["degraded"] == 0
    assert sum(r[0].shape[0] for r in res) == 4


def test_service_zero_candidate_user_serves_sentinels(serving):
    lonely = serving[1][1].M - 1    # no interactions → no seeds
    (res,), _, _ = _both(serving, np.full(8, lonely, np.int32), n_popular=0)
    users, _, items = res
    assert users.shape == (8,) and items.shape == (8, 5)
    assert (items == SENTINEL).all()


def test_service_popular_fallback_covers_zero_candidate_user(serving):
    lonely = serving[1][1].M - 1
    (res,), _, svc = _both(serving, np.full(8, lonely, np.int32))
    got = set(res[2][0].tolist()) - {SENTINEL}
    assert got and got <= set(svc.popular.tolist())


def test_service_flush_failure_falls_back_to_exact_full_scoring(serving):
    (res,), st, svc = _both(serving, np.arange(8, dtype=np.int32),
                            plan={"serve.flush": dict(at_calls=(0,))},
                            n_popular=0, topn=3)
    assert st["fallbacks"] == 1
    users, _, items = res
    p = svc.params
    dense = (float(p.mu) + p.b.numpy()[users][:, None] + p.bh.numpy()[None]
             + p.U.numpy()[users] @ p.V.numpy().T)
    np.testing.assert_array_equal(items[:, 0], np.argmax(dense, axis=1))


@pytest.mark.parametrize("wrapper,error", [
    ("lsh_retrieve.kernel.lsh_retrieve_topc", KernelError),
    ("candidate_score.kernel.score_topn", KernelValueError)])
def test_service_kernel_error_is_never_answered_by_the_fallback(
        serving, monkeypatch, wrapper, error):
    """A kernel that fails to launch, or a wrapper that refuses its
    operands, raises through the flush: `full_topn` answers injected
    faults and errors outside the kernels, never a failing kernel."""
    _, svc = _services(serving, n_popular=0)
    module, name = wrapper.rsplit(".", 1)

    def fail(*args, **kwargs):
        raise error(f"{name}: CUDA launch failed with error 719")

    monkeypatch.setattr(f"repro_torch.kernels.{module}.{name}", fail)
    with pytest.raises(error, match="719"):
        svc.submit(np.arange(8, dtype=np.int32))    # a whole micro-batch
    assert svc.stats()["fallbacks"] == 0


def test_service_quarantines_poison_ingest(serving):
    _, (_, tsp), sigs = serving
    jsvc, tsvc = _services(serving)
    N = tsp.N
    for svc in (jsvc, tsvc):
        with pytest.raises(Exception, match="int32") as e:
            svc.ingest(np.zeros((8, 1), np.float32), np.array([N]))
        assert type(e.value).__name__ == "PoisonBatchError"
        with pytest.raises(Exception, match="negative"):
            svc.ingest(sigs[:, :1], np.array([-1]))
        with pytest.raises(Exception, match="duplicate"):
            svc.ingest(sigs[:, :2], np.array([N, N]))
        assert svc.index.n_items == N, "quarantined batches touch no state"
    _assert_same_counters(tsvc.stats(), jsvc.stats())
    assert tsvc.stats()["quarantined"] == 3
    with pytest.raises(PoisonBatchError):      # the port's own exception
        tsvc.ingest(sigs[:, :1], np.array([-1]))


def _overflow(serving, svc, jax_side):
    """Ingest 12 items (clones of items 0–11) into the 8-slot tail: the
    overflow hands the full signatures to the background rebuilder."""
    _, (_, tsp), sigs = serving
    full = np.concatenate([sigs, sigs[:, :12]], axis=1)
    ids = np.arange(tsp.N, tsp.N + 12, dtype=np.int32)
    if jax_side:
        svc.ingest(jnp.asarray(sigs[:, :12]), jnp.asarray(ids),
                   full_sigs=jnp.asarray(full))
    else:
        svc.ingest(torch.tensor(sigs[:, :12]), torch.tensor(ids),
                   full_sigs=torch.tensor(full))
    return full


def _poll_until_settled(svc, rounds=6):
    for _ in range(rounds):
        svc._rebuilder.join(60)
        svc.flush()


def test_service_background_rebuild_swap_and_rollback(serving):
    N = serving[1][1].N
    users = np.arange(8, dtype=np.int32)
    # failure path first: every build dies → bounded retries → rollback
    jsvc, tsvc = _services(serving)
    for svc, mod, spec, jax_side in (
            (jsvc, jfaults, jresil.FaultSpec, True),
            (tsvc, faults, FaultSpec, False)):
        with mod.injected({"serve.rebuild": spec(at_calls=(0, 1, 2))}):
            _overflow(serving, svc, jax_side)
            assert svc.stats()["index_stale"]
            _poll_until_settled(svc)
        assert svc.index.n_items == N, "a failed rebuild must never swap in"
        assert svc.obs.counter("serve.rebuild.gave_up") == 1
        assert svc.obs.counter("serve.rebuild.retries") == 2
        assert svc._rebuilder.failures == 3
    _assert_same_counters(tsvc.stats(), jsvc.stats())
    # the services still answer, alike (index v, stale catalog)
    jres, _ = _drive(jsvc, jfaults, {}, users)
    tres, _ = _drive(tsvc, faults, {}, users)
    _assert_same_results(tres, jres)

    # success path: same overflow, no faults → validated v+1 swaps in
    jsvc, tsvc = _services(serving)
    for svc, jax_side in ((jsvc, True), (tsvc, False)):
        full = _overflow(serving, svc, jax_side)
        assert svc.stats()["index_stale"] and svc.index.n_items == N
        svc._rebuilder.join(60)
        svc.submit(users)                 # the swap lands at a loop edge
        svc.flush()
        assert svc.index.n_items == N + 12
        assert not svc.stats()["index_stale"]
        assert svc.obs.counter("serve.rebuild.swaps") == 1
        assert svc.stats()["ingest_to_servable_s"] > 0
    for f in INDEX_ARRAYS:
        np.testing.assert_array_equal(_np(getattr(tsvc.index, f)),
                                      np.asarray(getattr(jsvc.index, f)), f)
    np.testing.assert_array_equal(
        _np(build_index(torch.tensor(full), tail_cap=8,
                        device="cpu").sorted_ids), _np(tsvc.index.sorted_ids))
    _assert_same_counters(tsvc.stats(), jsvc.stats())
    _assert_same_results(tsvc.take_results(), jsvc.take_results())
    jres, _ = _drive(jsvc, jfaults, {}, np.arange(40, 64, dtype=np.int32))
    tres, _ = _drive(tsvc, faults, {}, np.arange(40, 64, dtype=np.int32))
    _assert_same_results(tres, jres)


def test_service_corrupt_rebuild_is_rejected_by_validation(serving):
    N = serving[1][1].N

    def corrupt_jax(idx):
        bad = dataclasses.replace(
            idx, sorted_ids=idx.sorted_ids.at[0, 0].set(idx.sorted_ids[0, 1]))
        object.__setattr__(bad, "_tail_host", 0)
        return bad

    def corrupt_port(idx):
        ids = idx.sorted_ids.clone()
        ids[0, 0] = ids[0, 1]
        return dataclasses.replace(idx, sorted_ids=ids)

    jsvc, tsvc = _services(serving)
    for svc, mod, spec, mutate, jax_side in (
            (jsvc, jfaults, jresil.FaultSpec, corrupt_jax, True),
            (tsvc, faults, FaultSpec, corrupt_port, False)):
        with mod.injected({"serve.rebuild.index": spec(
                kind="corrupt", mutate=mutate, at_calls=(0, 1, 2))}):
            _overflow(serving, svc, jax_side)
            _poll_until_settled(svc)
        assert svc.index.n_items == N, \
            "a corrupt build must be caught by the validation gate"
        assert svc._rebuilder.failures == 3
    assert validate_index(tsvc.index) == []
    _assert_same_counters(tsvc.stats(), jsvc.stats())
    assert tsvc.obs.counter("serve.rebuild.gave_up") == 1
    jres, _ = _drive(jsvc, jfaults, {}, np.arange(16, dtype=np.int32))
    tres, _ = _drive(tsvc, faults, {}, np.arange(16, dtype=np.int32))
    _assert_same_results(tres, jres)
