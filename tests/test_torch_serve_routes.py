"""Port vs JAX package: the service's routes beyond the kernel walk path,
on the CPU.

From one planted catalog (N = 2,000) with its J^K both services serve
the same users flush by flush:

* ``band_budget=0`` (the legacy pool + dedup oracle) against the JAX
  service with ``band_budget=0, impl="ref"``;
* ``impl="ref"`` with ``band_budget > 0`` (the plain walk path, the JAX
  package's CPU default) against the JAX service with ``impl="ref"``;
* the default configuration (``impl="auto"``) against the JAX package's
  default: on the CPU both resolve to the plain walk path, and
  ``interpret`` resolves as the JAX package's `interpret_mode`;
* small-catalog routing (`route_decision`, ``route_full_below``) and
  ``stats()["route"]``;
* `profile_flush`'s span names on each of its four branches, its staged
  answer equal to the fused flush's;
* a legacy service adopting two online updates (J^K swapped), and
  `OnlineLoop.build_service` with ``band_budget=0``.

Served ids must be equal and scores within 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topk as jtopk
from repro.loop import OnlineLoop as JOnlineLoop
from repro.serve import RecsysService as JService
from repro.serve import ServeConfig as JConfig
from repro.serve import build_index as jbuild
from repro.serve import full_topn as jfull_topn
from repro.serve import insert as jinsert
from repro_torch import obs
from repro_torch.kernels import KernelError
from repro_torch.kernels.candidate_score import kernel as score_kernel
from repro_torch.kernels.lsh_retrieve import kernel as lsh_kernel
from repro_torch.loop import OnlineLoop
from repro_torch.serve import (RecsysService, ServeConfig, build_index,
                               insert)
from test_torch_ingest import _port_state as _ingest_port_state
from test_torch_ingest import online_world  # noqa: F401  (a fixture)
from test_torch_loop import online_state  # noqa: F401  (a fixture)
from test_torch_serve_index import planted_state

SENTINEL = 2 ** 31 - 1
KW = dict(topn=10, micro_batch=32, C=128, n_seeds=8, cap=8, n_popular=16,
          tile_b=8, band_budget=256)
JREF = dict(impl="ref", background_rebuild=False)


@pytest.fixture(scope="module")
def state():
    js, ts = planted_state(tail_cap=32)
    JK = np.array(jtopk.topk_from_signatures(
        js["sigs"], jax.random.fold_in(jax.random.PRNGKey(0), 1), K=16,
        band_cap=16))
    src = np.asarray([1, 60, 333, 1200, 1500, 1999])
    ids = np.arange(2000, 2006, dtype=np.int32)
    sigs = np.asarray(js["sigs"])[:, src]
    tail = (jinsert(js["index"], jnp.asarray(sigs), jnp.asarray(ids)),
            insert(ts["index"], torch.tensor(sigs), torch.tensor(ids)))
    users = np.random.default_rng(7).integers(0, js["sp"].M, 90).astype(
        np.int32)
    return js, ts, JK, tail, users


def _services(state, tail, jkw, tkw, jk=True):
    js, ts, JK, tails, _ = state
    jidx, tidx = tails if tail else (js["index"], ts["index"])
    jsvc = JService(js["params"], jidx, js["sp"], JConfig(**jkw),
                    JK=jnp.asarray(JK) if jk else None)
    tsvc = RecsysService(ts["params"], tidx, ts["sp"], ServeConfig(**tkw),
                         JK=torch.from_numpy(JK) if jk else None,
                         device="cpu")
    return jsvc, tsvc


def _flushes(svc, users):
    """Each flush's (users, scores, items), after a warm-up."""
    svc.warmup()
    svc.submit(users)
    svc.flush()
    return svc.take_results()


def _assert_same_flushes(jsvc, tsvc, users):
    jres, tres = _flushes(jsvc, users), _flushes(tsvc, users)
    assert len(jres) == len(tres) == -(-len(users) // jsvc.cfg.micro_batch)
    for (ju, js_, ji), (tu, ts_, ti) in zip(jres, tres):
        np.testing.assert_array_equal(tu, ju)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(ts_, js_, rtol=1e-5, atol=1e-5)
    assert tsvc.stats()["fallbacks"] == 0
    return np.concatenate([r[2] for r in tres])


@pytest.mark.parametrize("knob,tail", [
    ({}, False), ({}, True), (dict(use_jk=False), False),
    (dict(fold_mates=False), True), (dict(pool_width=96), False),
    (dict(n_popular=0, C=64), True)])
def test_legacy_service_equals_jax(state, knob, tail):
    kw = dict(KW, band_budget=0, **knob)
    jsvc, tsvc = _services(state, tail, dict(kw, **JREF),
                           dict(kw, background_rebuild=False))
    assert (tsvc.JK is None) == (not kw.get("use_jk", True))
    before = (lsh_kernel.LAUNCHES, score_kernel.LAUNCHES)
    _assert_same_flushes(jsvc, tsvc, state[4])
    assert (lsh_kernel.LAUNCHES, score_kernel.LAUNCHES) == before


@pytest.mark.parametrize("tail,budget", [(False, 256), (True, 256),
                                         (False, 64)])
def test_ref_service_runs_the_plain_walk_like_jax(state, tail, budget):
    """``impl="ref"`` routes to `recommend_walked` in both packages.  At
    budget 64 the walk truncates, so its answers differ from the kernel
    walk's (``impl="cuda"``: whole windows, C = 128) — what the port
    answered before it routed ``impl="ref"`` as the JAX package does."""
    kw = dict(KW, band_budget=budget)
    jsvc, tsvc = _services(state, tail, dict(kw, **JREF),
                           dict(kw, impl="ref", background_rebuild=False))
    items = _assert_same_flushes(jsvc, tsvc, state[4])
    if budget == 64:
        _, kern = _services(state, tail, dict(kw, **JREF),
                            dict(kw, impl="cuda", background_rebuild=False))
        other = np.concatenate([r[2] for r in _flushes(kern, state[4])])
        assert (other != items).any()


@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("budget", [64, 256])
def test_default_service_equals_the_default_jax_service(state, tail, budget):
    """A default-config service (``impl="auto"``, ``interpret=None``)
    answers flush for flush like the JAX package's default service on
    the CPU: both resolve to the plain walk `recommend_walked`, which
    launches no kernel.  At budget 64 the walk truncates, so the kernel
    walk (``impl="cuda"``) answers otherwise."""
    kw = dict(KW, band_budget=budget, background_rebuild=False)
    jsvc, tsvc = _services(state, tail, kw, kw)
    assert jsvc.cfg.scorer_impl() == "ref"
    assert tsvc.cfg.scorer_impl(tsvc.device) == "ref"
    before = (lsh_kernel.LAUNCHES, score_kernel.LAUNCHES)
    items = _assert_same_flushes(jsvc, tsvc, state[4])
    assert (lsh_kernel.LAUNCHES, score_kernel.LAUNCHES) == before
    if budget == 64:
        _, kern = _services(state, tail, kw, dict(kw, impl="cuda"))
        other = np.concatenate([r[2] for r in _flushes(kern, state[4])])
        assert (other != items).any()


@pytest.mark.parametrize("impl,interpret,device,want", [
    ("auto", None, "cpu", ("ref", True, "ref")),
    ("auto", None, "cuda", ("cuda", False, "cuda")),
    ("auto", True, "cuda", ("cuda", True, "ref")),
    ("auto", False, "cpu", ("ref", False, "ref")),
    ("cuda", None, "cpu", ("cuda", True, "auto")),
    ("cuda", True, "cpu", ("cuda", True, "auto")),
    ("cuda", False, "cpu", ("cuda", False, "cuda")),
    ("cuda", None, "cuda", ("cuda", False, "cuda")),
    ("ref", None, "cuda", ("ref", False, "ref")),
    ("ref", True, "cpu", ("ref", True, "ref")),
])
def test_impl_and_interpret_resolve_like_jax(impl, interpret, device, want):
    """``scorer_impl`` / ``interpret_mode`` are the JAX package's, with the
    device in place of the backend (``cuda`` ↔ ``pallas``); ``kernel_impl``
    maps the JAX pair onto the ops' ``impl``: the kernels only for the
    kernel path outside interpret mode, which on the CPU goes through
    the wrappers (``"auto"``: their plain versions for CPU tensors)."""
    cfg = ServeConfig(impl=impl, interpret=interpret)
    dev = torch.device(device)
    got = (cfg.scorer_impl(dev), cfg.interpret_mode(dev), cfg.kernel_impl(dev))
    assert got == want
    if device == "cpu":
        jcfg = JConfig(impl={"cuda": "pallas"}.get(impl, impl),
                       interpret=interpret)
        assert ({"pallas": "cuda"}.get(jcfg.scorer_impl(), "ref"),
                jcfg.interpret_mode()) == got[:2]


def test_interpret_runs_the_kernel_walk_plain_and_matches_jax(state):
    """``impl="cuda"`` on the CPU is the kernel walk through its kernels'
    plain versions, as the JAX ``impl="pallas"`` runs in interpret mode
    there; ``interpret=True`` asks for it explicitly.  Both equal the
    JAX interpret-mode service, and neither launches a kernel."""
    kw = dict(KW, background_rebuild=False)
    jsvc, tsvc = _services(state, True, dict(kw, impl="pallas",
                                             interpret=True),
                           dict(kw, impl="cuda"))
    _, tsvc2 = _services(state, True, dict(kw, **JREF),
                         dict(kw, impl="cuda", interpret=True))
    before = (lsh_kernel.LAUNCHES, score_kernel.LAUNCHES)
    items = _assert_same_flushes(jsvc, tsvc, state[4])
    np.testing.assert_array_equal(
        np.concatenate([r[2] for r in _flushes(tsvc2, state[4])]), items)
    assert (lsh_kernel.LAUNCHES, score_kernel.LAUNCHES) == before


def test_legacy_impl_cuda_on_the_cpu_raises_through_the_flush(state):
    """``impl="cuda", interpret=False`` asks for the kernels themselves:
    on the CPU the scorer's wrapper refuses, and the flush raises."""
    _, tsvc = _services(state, False, dict(KW, **JREF),
                        dict(KW, band_budget=0, impl="cuda",
                             interpret=False))
    with pytest.raises(KernelError, match="CUDA device"):
        tsvc.submit(np.arange(KW["micro_batch"], dtype=np.int32))
    assert tsvc.stats()["fallbacks"] == 0


@pytest.mark.parametrize("mode,route,C", [
    ("candidate", 0, 48), ("candidate", -1, 48), ("candidate", 10, 48),
    ("candidate", 2000, 128), ("candidate", 1999, 128),
    ("candidate", -1, 16), ("full", -1, 48)])
def test_route_decision_matches_jax(state, mode, route, C):
    """`tests/test_lsh_retrieve.py::test_route_decision_and_full_fallback`
    on both packages: the auto threshold is 48·C, the verdict is reported
    even when routing is off, and a routed service answers as the exact
    `full_topn`."""
    js, ts, _, _, users = state
    kw = dict(KW, mode=mode, C=C, n_popular=0, route_full_below=route)
    jsvc, tsvc = _services(state, False, dict(kw, **JREF), kw)
    rd = tsvc.route_decision()
    assert rd == jsvc.route_decision()
    assert rd["enabled"] == (route != 0) and rd["n_items"] == 2000
    if rd["enabled"] and rd["decision"] == "full":
        res = _flushes(tsvc, users[:32])[0]
        s_f, i_f = jfull_topn(js["params"], jnp.asarray(users[:32]),
                              topn=10)
        np.testing.assert_array_equal(res[2], np.asarray(i_f))
        np.testing.assert_allclose(res[1], np.asarray(s_f), rtol=1e-5,
                                   atol=1e-5)
    st = tsvc.stats()
    assert st["route"] == rd and st["shards"] == 1


BRANCHES = {
    "full": (dict(mode="full"), dict(mode="full")),
    "plain walk": (dict(impl="ref"), dict(impl="ref")),
    "kernel walk": (dict(impl="pallas", interpret=True), dict(impl="cuda")),
    "legacy": (dict(band_budget=0, impl="ref"), dict(band_budget=0)),
}


@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("branch", list(BRANCHES))
def test_profile_flush_spans_and_staged_answer(state, branch, tail):
    """`tests/test_obs.py`'s profile cases on each branch: the port's span
    names are the JAX service's, each child span lies inside its parent
    in the Chrome trace, and the staged answer equals the fused flush's."""
    jknob, tknob = BRANCHES[branch]
    jsvc, tsvc = _services(state, tail, dict(KW, background_rebuild=False,
                                             **jknob),
                           dict(KW, background_rebuild=False, **tknob))
    users = state[4][:KW["micro_batch"]]
    _, fused_s, fused_i = _flushes(tsvc, users)[0]
    jsvc.warmup()
    want = jsvc.profile_flush(users)
    got = tsvc.profile_flush(users)
    assert sorted(got) == sorted(want)
    assert all(v > 0 for v in got.values())
    s, i = tsvc.profiled
    np.testing.assert_array_equal(i.numpy(), fused_i)
    np.testing.assert_allclose(s.numpy(), fused_s, rtol=1e-5, atol=1e-5)
    evs = {}
    for e in obs.chrome_trace(tsvc.obs)["traceEvents"]:
        if e["ph"] == "X" and e["name"] in got:
            evs[e["name"]] = e      # the last of each name: profile_flush's
    inside = lambda a, b: (b["ts"] <= a["ts"]
                           and a["ts"] + a["dur"] <= b["ts"] + b["dur"])
    for name in got:
        parent = name.rsplit(".", 1)[0]
        if parent in got:
            assert inside(evs[name], evs[parent]), name


def test_legacy_service_adopts_online_updates_like_jax(online_world):
    """`tests/test_torch_ingest.py`'s online hand-off on the legacy path:
    after each update the service's J^K is the state's, and both
    services answer alike (new users and items included)."""
    states, sigs = online_world
    kw = dict(topn=5, micro_batch=16, C=48, n_seeds=4, cap=8, n_popular=8,
              tile_b=8, band_budget=0, background_rebuild=False)
    st0 = states[0]
    tst0 = _ingest_port_state(st0, np.asarray(st0.hash_key))
    jsvc = JService(st0.params, jbuild(jnp.asarray(sigs), tail_cap=16),
                    st0.sp, JConfig(impl="ref", **kw), JK=st0.JK)
    tsvc = RecsysService(tst0.params, build_index(torch.tensor(sigs),
                                                  tail_cap=16, device="cpu"),
                         tst0.sp, ServeConfig(**kw), JK=tst0.JK,
                         device="cpu")
    rng = np.random.default_rng(3)
    for prev, st in zip(states, states[1:]):
        tst = _ingest_port_state(st, np.asarray(st.hash_key))
        jsvc.ingest_online_update(st, prev.N)
        tsvc.ingest_online_update(tst, prev.N)
        np.testing.assert_array_equal(tsvc.JK.numpy(), np.asarray(st.JK))
        assert tsvc.JK.shape[0] == st.N
        users = np.concatenate([rng.integers(0, prev.M, 24),
                                np.arange(prev.M, st.M)]).astype(np.int32)
        _assert_same_flushes(jsvc, tsvc, users)


def test_loop_build_service_on_the_legacy_path_matches_jax(online_state):
    """`OnlineLoop.build_service` hands the state's J^K to the service
    (`loop/supervisor.py`), as the JAX loop does."""
    jst, tst, _, _ = online_state
    kw = dict(topn=5, micro_batch=8, C=32, n_seeds=4, cap=8, n_popular=16,
              band_budget=0, background_rebuild=False)
    jsvc = JOnlineLoop.build_service(jst, JConfig(impl="ref", **kw),
                                     tail_cap=16)
    tsvc = OnlineLoop.build_service(tst, ServeConfig(**kw), tail_cap=16)
    np.testing.assert_array_equal(tsvc.JK.numpy(), np.asarray(jst.JK))
    users = np.random.default_rng(1).integers(0, jst.M, 40).astype(np.int32)
    _assert_same_flushes(jsvc, tsvc, users)
    off = OnlineLoop.build_service(
        tst, ServeConfig(**dict(kw, use_jk=False)), tail_cap=16)
    assert off.JK is None


def test_config_takes_every_jax_field_but_two():
    """The port's `ServeConfig` has every field of the JAX package's, with
    the same defaults (the name is from before the sharded tier brought
    ``shard_budget`` and the routing repair brought ``interpret``)."""
    j = {f.name: f.default for f in dataclasses.fields(JConfig)}
    t = {f.name: f.default for f in dataclasses.fields(ServeConfig)}
    assert set(t) == set(j)
    assert t == j
    assert ServeConfig(band_budget=0).resolved_pool_width() == 0
    assert ServeConfig(pool_width=96).resolved_pool_width() == 96
