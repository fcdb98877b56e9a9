"""Port vs JAX package: the always-on `OnlineLoop`
(`repro_torch/loop/supervisor.py`), on the CPU.

* Every case of `tests/test_loop.py` on the port, at its size
  (`MOVIELENS_LIKE` reshaped to M = 80, N = 40, 1,200 ratings; G = 4,
  p = 1, q = 4; F = 8, K = 4); the sharded refusal on a real two-shard
  service over two logical CPU devices.
* The loop cases of `tests/test_resil.py` on the port at that file's
  size (M = 120, N = 50, 2,000 ratings; G = 8, p = 1, q = 6; F = 16,
  K = 8), with the port as its own oracle, **bit-exact**: a kill at
  ``loop.slice`` call 3, ``loop.ckpt`` call 1 and ``loop.drift`` call 1
  recovers to the uninterrupted arm's state at that seq; the recovered
  service sheds but answers everyone; the slice guard rolls back the
  whole slice.
* Parity: the JAX loop and the port's loop from one `OnlineState`
  (`convert.online_state_from_numpy`) on `test_resil.py`'s 6-slice
  schedule.  After every slice: ids (Ω̂), J^K of the columns both
  states held before the slice, M and N exact; the parameters within
  `test_torch_online.py`'s PATH_TOL (rtol / atol 1e-5); S within
  rtol 1e-4 / atol 1e-3 with signature bits equal wherever
  |S| ≥ 1e-3 (the near-zero rule); `updater.seq`; each WAL entry's meta
  and arrays (the ΔΩ triples, their keys, ``mkey``) bit-equal; the
  loop's counters equal; the drift probe's RMSE within 1e-5,
  each probe at least 1e-3 (relative) away from its trip threshold, and
  the same trip decisions.  Served top-N are held against the port's own
  plain versions on the state each flush served from.
* Across packages: a JAX loop killed at ``loop.ckpt`` recovers in the
  port's `OnlineLoop.recover` to within the tolerances above of the JAX
  reference at that seq; a port loop's directory recovers in the JAX
  `OnlineLoop.recover` to within them of the port's reference.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.resil as jresil
from repro.core import model as jmodel
from repro.core import online as jonline
from repro.core import simlsh as jsim
from repro.core import topk as jtopk
from repro.core.sgd import Hyper as JHyper
from repro.data import sparse as jsparse
from repro.data import synthetic as jsyn
from repro.loop import LoopConfig as JLoopConfig
from repro.loop import OnlineLoop as JOnlineLoop
from repro.resil import faults as jfaults
from repro.resil import wal as jwal
from repro.serve.service import ServeConfig as JServeConfig
from repro_torch import convert, prng
from repro_torch.core import simlsh
from repro_torch.core.sgd import Hyper
from repro_torch.kernels.candidate_score.ref import assert_topn_close
from repro_torch.launch.mesh import LOGICAL_DEVICES
from repro_torch.loop import LoopConfig, OnlineLoop
from repro_torch.resil import GuardConfig, OnlineUpdater, faults, wal
from repro_torch.resil.faults import FaultPlan, FaultSpec, InjectedFault
from repro_torch.serve import (ServeConfig, ShardedIngestUnsupported,
                               recommend_walked_kernel)

PATH_TOL = dict(rtol=1e-5, atol=1e-5)
S_TOL = dict(rtol=1e-4, atol=1e-3)
FIELDS = ("U", "V", "b", "bh", "W", "C", "mu")

SERVE = ServeConfig(topn=5, micro_batch=8, C=16, n_seeds=2, cap=4,
                    n_popular=8)
CFG = LoopConfig(serve_flushes=1, micro_epochs=1, micro_batch=256,
                 deltas_per_slice=2, backpressure_queue=2, max_lag=1,
                 ckpt_every=0, drift_every=0, watchdog_s=0.0,
                 freeze_slices=2, tail_cap=8, seed=0)
# `tests/test_resil.py`'s loop configuration
LOOP_SERVE = ServeConfig(topn=5, micro_batch=8, C=32, n_seeds=4, cap=8,
                         n_popular=16)
LOOP_CFG = LoopConfig(serve_flushes=2, micro_epochs=1, micro_batch=512,
                      deltas_per_slice=2, max_lag=2, ckpt_every=2,
                      drift_every=2, drift_window=4, tail_cap=16, seed=0)


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    faults.uninstall()
    jfaults.uninstall()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _both_states(M, N, nnz, lsh_kw, F, K):
    """The JAX package's `OnlineState` at this size (its tests' recipe),
    the port's copy of it, and each package's lsh config."""
    spec = dataclasses.replace(jsyn.MOVIELENS_LIKE, M=M, N=N, nnz=nnz)
    rows, cols, vals, _ = jsyn.generate(spec, seed=0)
    sp = jsparse.from_coo(rows, cols, vals, (M, N))
    jcfg = jsim.SimLSHConfig(**lsh_kw)
    key = jax.random.PRNGKey(0)
    sigs, S = jsim.encode(sp, jcfg, key, return_accumulators=True)
    JK = jtopk.topk_from_signatures(sigs, jax.random.PRNGKey(1), K=K,
                                    band_cap=jcfg.band_cap)
    params = jmodel.init_from_data(jax.random.PRNGKey(2), sp, F, K)
    jst = jonline.OnlineState(params=params, S=S, JK=JK, sp=sp, M=M, N=N,
                              hash_key=key)
    return jst, _port_state(jst), jcfg, simlsh.SimLSHConfig(**lsh_kw)


def _port_state(jst):
    p = jst.params
    return convert.online_state_from_numpy(
        {f: np.asarray(getattr(p, f)) for f in FIELDS}, np.asarray(jst.S),
        np.asarray(jst.JK), (np.asarray(jst.sp.rows), np.asarray(jst.sp.cols),
                             np.asarray(jst.sp.vals)),
        np.asarray(jst.hash_key), jst.M, jst.N, device="cpu")


@pytest.fixture(scope="module")
def tiny_state():
    """`tests/test_loop.py::tiny_state`, in both packages."""
    return _both_states(80, 40, 1200, dict(G=4, p=1, q=4), 8, 4)


@pytest.fixture(scope="module")
def online_state():
    """`tests/test_resil.py::online_state`, in both packages."""
    return _both_states(120, 50, 2000, dict(G=8, p=1, q=6), 16, 8)


def _delta(st, M_new, N_new, seed, n):
    """The JAX tests' `_delta`: fresh ΔΩ disjoint from ``st.sp``."""
    rng = np.random.default_rng(seed)
    nr = rng.integers(0, M_new, n).astype(np.int32)
    nc = rng.integers(0, N_new, n).astype(np.int32)
    pair = np.unique(nr.astype(np.int64) * N_new + nc)
    old = set((_np(st.sp.rows).astype(np.int64) * N_new
               + _np(st.sp.cols)).tolist())
    pair = np.asarray([p for p in pair.tolist() if p not in old])
    return ((pair // N_new).astype(np.int32),
            (pair % N_new).astype(np.int32),
            rng.uniform(1, 5, pair.shape[0]).astype(np.float32))


def _assert_states_bit_identical(a, b):
    ta, tb = wal.state_tree(a), wal.state_tree(b)
    for k in ta:
        xa, xb = _np(ta[k]), _np(tb[k])
        assert xa.dtype == xb.dtype and np.array_equal(xa, xb), k


def _assert_states_close(tst, jst, old_N):
    """The port's state against the JAX package's at the parity
    tolerances (module docstring); J^K exact on the first ``old_N``
    columns."""
    assert (tst.M, tst.N) == (jst.M, jst.N)
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(_np(getattr(tst.sp, f)),
                                      np.asarray(getattr(jst.sp, f)), f)
    np.testing.assert_array_equal(_np(tst.JK)[:old_N],
                                  np.asarray(jst.JK)[:old_N])
    for f in FIELDS:
        np.testing.assert_allclose(_np(getattr(tst.params, f)),
                                   np.asarray(getattr(jst.params, f)),
                                   err_msg=f, **PATH_TOL)
    S_t, S_j = _np(tst.S), np.asarray(jst.S)
    np.testing.assert_allclose(S_t, S_j, **S_TOL)
    diff = (S_t >= 0) != (S_j >= 0)
    assert not (diff & (np.abs(S_j) >= 1e-3)).any(), \
        "a signature bit differs where |S| >= 1e-3"
    np.testing.assert_array_equal(wal.key_words(tst.hash_key),
                                  np.asarray(jst.hash_key))


# ------------------------------------------------- tests/test_loop.py cases

def _loop(tmp_path, tiny_state, cfg=CFG, **up_kw):
    _, st0, _, lsh = tiny_state
    up = OnlineUpdater(st0, lsh, Hyper(), root=str(tmp_path), K=4,
                       epochs=1, batch=256, **up_kw)
    svc = OnlineLoop.build_service(st0, SERVE, tail_cap=cfg.tail_cap)
    return OnlineLoop(up, svc, cfg)


def _offer(loop, seed, grow=(4, 2)):
    M, N = loop.state.M + grow[0], loop.state.N + grow[1]
    nr, nc, nv = _delta(loop.state, M, N, seed=seed, n=120)
    loop.offer_delta(nr, nc, nv, prng.PRNGKey(seed), M_new=M, N_new=N)
    return M, N


def test_loop_trains_and_publishes_on_lag(tiny_state, tmp_path):
    loop = _loop(tmp_path, tiny_state)
    M, N = _offer(loop, seed=10)
    loop.svc.submit(np.arange(8, dtype=np.int32))
    loop.run_slice()
    # max_lag=1: the slice's mutation was published within the slice
    assert int(loop.obs.counter("loop.publishes")) == 1
    assert int(loop.svc.params.U.shape[0]) == M
    assert int(loop.svc.params.V.shape[0]) == N
    assert int(loop.obs.counter("online.micro_epochs")) == 1
    assert loop.updater.seq == 1 and loop.slice_count == 1
    assert loop.staleness_s() == 0.0
    st = loop.svc.stats()
    assert st["users"] == 8 and st["dropped"] == 0
    assert loop.svc.params.U.device.type == "cpu"


def test_loop_backpressure_steals_micro_epoch_budget(tiny_state, tmp_path):
    loop = _loop(tmp_path, tiny_state)
    for i in range(3):                      # depth 3 ≥ backpressure_queue 2
        _offer(loop, seed=20 + i)
    loop.run_slice()
    # the slice drained ΔΩ (deltas_per_slice=2) but skipped training
    assert int(loop.obs.counter("online.micro_epochs")) == 0
    assert int(loop.obs.counter("online.updates")) == 2
    loop.run_slice()                        # queue is shallow again → train
    assert int(loop.obs.counter("online.micro_epochs")) == 1


def test_loop_degrades_to_frozen_serving_on_fault(tiny_state, tmp_path):
    loop = _loop(tmp_path, tiny_state)
    loop.svc.submit(np.arange(8, dtype=np.int32))
    with faults.injected({"loop.slice": FaultSpec(at_calls=(1,))}):
        loop.run(3, degrade=True)           # slice 1 dies → freeze
    assert int(loop.obs.counter("loop.slice_failures")) == 1
    assert int(loop.obs.counter("loop.freezes")) == 1
    assert loop.slice_count == 2            # the failed slice didn't count
    st = loop.svc.stats()
    assert st["users"] == 8 and st["dropped"] == 0
    # the freeze expires and training resumes
    _offer(loop, seed=30)
    loop.run(3, degrade=True)
    assert int(loop.obs.counter("online.micro_epochs")) >= 1


def test_loop_without_degrade_propagates_the_fault(tiny_state, tmp_path):
    loop = _loop(tmp_path, tiny_state)
    with faults.injected({"loop.slice": FaultSpec(at_calls=(0,))}):
        with pytest.raises(InjectedFault):
            loop.run(2, degrade=False)
    assert loop.slice_count == 0
    assert int(loop.obs.counter("loop.slice_failures")) == 0


def test_loop_watchdog_trips_on_stalled_slice(tiny_state, tmp_path):
    cfg = dataclasses.replace(CFG, watchdog_s=0.005)
    loop = _loop(tmp_path, tiny_state, cfg=cfg)
    with faults.injected({"loop.slice": FaultSpec(
            kind="stall", stall_s=0.05, at_calls=(0,))}):
        loop.run_slice()
    assert int(loop.obs.counter("loop.watchdog_trips")) == 1
    assert loop._frozen > 0


def test_loop_quarantines_poison_delta_before_logging(tiny_state, tmp_path):
    loop = _loop(tmp_path, tiny_state)
    st0 = loop.state
    nr = np.array([1, 2], np.int32)
    loop.offer_delta(nr, nr, np.array([np.nan, 1.0], np.float32),
                     prng.PRNGKey(0), M_new=st0.M, N_new=st0.N)
    loop.run_slice()
    assert int(loop.obs.counter("loop.quarantined")) == 1
    assert loop.state.M == st0.M            # the poison never applied …
    entries = loop.updater.wal.entries(after=0)
    assert all(e.meta["n_deltas"] == 0 for e in entries)  # … nor logged


def test_flush_some_bounds_dispatches(tiny_state, tmp_path):
    loop = _loop(tmp_path, tiny_state)
    svc = loop.svc
    svc.submit(np.arange(4, dtype=np.int32))   # below micro_batch: queued
    assert svc.stats()["queue"] == 4
    assert svc.flush_some(2) == 1              # one padded partial dispatch
    assert svc.flush_some(2) == 0              # nothing left pending
    assert svc.stats()["queue"] == 0
    assert svc.stats()["users"] == 4


def test_loop_refuses_sharded_service_and_typed_ingest_error(
        tiny_state, tmp_path, monkeypatch):
    loop = _loop(tmp_path, tiny_state)
    st0 = loop.state
    monkeypatch.setenv(LOGICAL_DEVICES, "2")
    svc = OnlineLoop.build_service(st0, dataclasses.replace(SERVE, shards=2),
                                   tail_cap=0)
    assert svc.stats()["shards"] == 2
    with pytest.raises(ValueError, match="single-device"):
        OnlineLoop(loop.updater, svc, CFG)
    with pytest.raises(ShardedIngestUnsupported):
        svc.ingest_online_update(st0, N_old=st0.N)
    with pytest.raises(ShardedIngestUnsupported):
        svc.request_rebuild(simlsh.pack_bits(st0.S >= 0))
    assert svc.stats()["ingest_rejected"] == 2


def test_online_updater_recover_refuses_loop_entries(tiny_state, tmp_path):
    _, st0, _, lsh = tiny_state
    loop = _loop(tmp_path, tiny_state)
    _offer(loop, seed=40)
    loop.run_slice()                        # writes one kind="slice" entry
    with pytest.raises(ValueError, match="OnlineLoop.recover"):
        OnlineUpdater.recover(str(tmp_path), lsh, Hyper(), K=4, epochs=1,
                              batch=256, base_state=st0)


def test_loop_checkpoint_carries_cursors(tiny_state, tmp_path):
    cfg = dataclasses.replace(CFG, ckpt_every=1)
    loop = _loop(tmp_path, tiny_state, cfg=cfg)
    _offer(loop, seed=50)
    loop.run_slice()
    assert int(loop.obs.counter("loop.ckpts")) == 1
    assert loop.updater.wal.seqs() == []    # pruned up to the cut
    _, _, _, lsh = tiny_state
    rec = OnlineLoop.recover(str(tmp_path), lsh, Hyper(), SERVE, K=4,
                             epochs=1, batch=256, cfg=cfg, device="cpu")
    assert rec.slice_count == 1 and rec._micro == 1
    _assert_states_bit_identical(rec.state, loop.state)
    assert rec.state.params.U.device.type == "cpu"
    assert len(rec.obs.span_durations("loop.recover.restore")) == 1
    assert len(rec.obs.span_durations("loop.recover.service")) == 1


def test_loop_recover_refuses_mismatched_static_args(tiny_state, tmp_path):
    _, st0, _, lsh = tiny_state
    loop = _loop(tmp_path, tiny_state)
    _offer(loop, seed=60)
    loop.run_slice()
    with pytest.raises(ValueError, match="static arguments"):
        OnlineLoop.recover(str(tmp_path), lsh, Hyper(), SERVE, K=4,
                           epochs=2, batch=256, cfg=CFG, base_state=st0)
    with pytest.raises(FileNotFoundError, match="base_state"):
        OnlineLoop.recover(str(tmp_path), lsh, Hyper(), SERVE, K=4,
                           epochs=1, batch=256, cfg=CFG, device="cpu")


# ----------------------------------------- tests/test_resil.py loop cases

def _resil_loop(root, online_state, cfg=LOOP_CFG):
    _, st0, _, lsh = online_state
    up = OnlineUpdater(st0, lsh, Hyper(), root=str(root), K=8, epochs=1,
                       batch=512)
    svc = OnlineLoop.build_service(st0, LOOP_SERVE, tail_cap=cfg.tail_cap)
    return OnlineLoop(up, svc, cfg, holdout=_holdout(st0))


def _holdout(st):
    return tuple(_np(a)[:200] for a in (st.sp.rows, st.sp.cols, st.sp.vals))


def _drive_loop(loop, n_slices, kill_site=None, kill_call=0, jax_side=False,
                on_slice=None):
    """`tests/test_resil.py::_drive_loop` for either package: a
    deterministic slice schedule (fixed seeds for traffic, ΔΩ and keys),
    so a killed arm replays the reference arm's stream exactly.
    ``on_slice(s, loop)`` runs before each slice.  → (killed,
    {seq: state after the slice})."""
    fx = jfaults if jax_side else faults
    M, N = loop.state.M, loop.state.N
    snaps = {}
    plan = None
    if kill_site:
        spec = (jresil.FaultSpec if jax_side else FaultSpec)(
            at_calls=(kill_call,))
        plan = fx.install((jresil.FaultPlan if jax_side else FaultPlan)(
            {kill_site: spec}))
    fault = jresil.InjectedFault if jax_side else InjectedFault
    try:
        for s in range(n_slices):
            rng = np.random.default_rng(500 + s)
            loop.svc.submit(rng.integers(0, M, 16).astype(np.int32))
            if s % 2 == 0:
                M, N = M + 4, N + 2
                nr, nc, nv = _delta(loop.state, M, N, seed=1000 + s, n=250)
                key = jax.random.PRNGKey(70 + s)
                loop.offer_delta(nr, nc, nv,
                                 np.asarray(key) if jax_side
                                 else convert.key_from_numpy(key),
                                 M_new=M, N_new=N)
            if on_slice is not None:
                on_slice(s, loop)
            try:
                loop.run_slice()
            except fault:
                return True, snaps
            snaps[loop.updater.seq] = loop.state
        return False, snaps
    finally:
        if plan is not None:
            fx.uninstall()


@pytest.fixture(scope="module")
def loop_reference(online_state, tmp_path_factory):
    """The port's uninterrupted 6-slice arm every kill scenario is
    compared against: state snapshots keyed by WAL seq."""
    loop = _resil_loop(tmp_path_factory.mktemp("loop-ref"), online_state)
    killed, snaps = _drive_loop(loop, 6)
    assert not killed and loop.updater.seq >= 3
    return snaps


@pytest.mark.parametrize("site,call", [
    ("loop.slice", 3),     # between slices, before anything runs
    ("loop.ckpt", 1),      # before the 2nd durable cut — resume = 1st
                           # checkpoint + unpruned WAL suffix
    ("loop.drift", 1),     # mid-slice, after train, before the probe
])
def test_loop_kill_at_site_recovers_bit_identical(online_state,
                                                  loop_reference, tmp_path,
                                                  site, call):
    _, st0, _, lsh = online_state
    loop = _resil_loop(tmp_path, online_state)
    killed, _ = _drive_loop(loop, 6, kill_site=site, kill_call=call)
    assert killed, f"fault at {site} never fired"
    del loop                                # the killed process

    rec = OnlineLoop.recover(str(tmp_path), lsh, Hyper(), LOOP_SERVE, K=8,
                             epochs=1, batch=512, cfg=LOOP_CFG,
                             base_state=st0)
    assert rec.updater.seq in loop_reference, \
        (site, rec.updater.seq, sorted(loop_reference))
    _assert_states_bit_identical(rec.state, loop_reference[rec.updater.seq])
    # the recovered loop keeps going: serve + train a fresh slice
    rec.svc.submit(np.arange(16, dtype=np.int32))
    rec.run_slice()
    st = rec.svc.stats()
    assert st["users"] >= 16 and st["dropped"] == 0


def test_loop_recover_reuses_the_micro_schedule(online_state, tmp_path,
                                                monkeypatch):
    """WAL replay builds the micro schedule once for each change of Ω̂
    (an entry with a ΔΩ, or the first), as the live loop does, and the
    recovered loop's next slice without a ΔΩ builds none."""
    from repro_torch.loop import supervisor
    _, st0, _, lsh = online_state
    loop = _resil_loop(tmp_path, online_state)
    killed, _ = _drive_loop(loop, 6, kill_site="loop.drift", kill_call=1)
    assert killed
    del loop
    built = []
    real = supervisor.build_micro_schedule
    monkeypatch.setattr(supervisor, "build_micro_schedule",
                        lambda *a, **k: built.append(1) or real(*a, **k))
    rec = OnlineLoop.recover(str(tmp_path), lsh, Hyper(), LOOP_SERVE, K=8,
                             epochs=1, batch=512, cfg=LOOP_CFG,
                             base_state=st0)
    entries = list(rec.updater.wal.entries(after=rec.updater._ckpt_seq))
    assert len(entries) >= 2
    want = sum(1 for i, e in enumerate(entries)
               if i == 0 or e.meta["n_deltas"])
    assert len(built) == want < len(entries)
    assert rec._sched.sp is rec.state.sp
    rec.svc.submit(np.arange(16, dtype=np.int32))
    rec.run_slice()
    assert len(built) == want


def test_loop_recovered_service_sheds_but_answers_everyone(online_state,
                                                           tmp_path):
    """After a kill + recover, an overload burst degrades (popularity
    answers) — it never drops: shed ≠ lost survives the crash."""
    _, st0, _, lsh = online_state
    loop = _resil_loop(tmp_path, online_state)
    killed, _ = _drive_loop(loop, 6, kill_site="loop.ckpt", kill_call=1)
    assert killed
    serve = dataclasses.replace(LOOP_SERVE, max_pending=12)
    rec = OnlineLoop.recover(str(tmp_path), lsh, Hyper(), serve, K=8,
                             epochs=1, batch=512, cfg=LOOP_CFG,
                             base_state=st0)
    rec.svc.submit(np.arange(30, dtype=np.int32))   # burst 30 > bound 12
    rec.run_slice()
    rec.svc.flush()
    st = rec.svc.stats()
    assert st["users"] == 30 and st["degraded"] > 0 and st["dropped"] == 0


def test_loop_slice_guard_rolls_back_whole_slice(online_state, tmp_path):
    """A diverging micro-epoch rejects the *slice's* WAL entry: the state
    is exactly pre-slice, and replay re-trips to the same rejection."""
    _, st0, _, lsh = online_state
    up = OnlineUpdater(st0, lsh, Hyper(), root=str(tmp_path), K=8, epochs=1,
                       batch=512, guard=GuardConfig(max_ratio=1e-9))
    svc = OnlineLoop.build_service(st0, LOOP_SERVE,
                                   tail_cap=LOOP_CFG.tail_cap)
    loop = OnlineLoop(up, svc, LOOP_CFG)
    pre = loop.state
    loop.run_slice()                        # micro-epoch trips the guard
    assert int(loop.obs.counter("loop.guard_trips")) == 1
    assert loop.state is pre, "rollback must restore the pre-slice state"
    assert loop.updater.seq == 1            # the entry is logged regardless
    rec = OnlineLoop.recover(str(tmp_path), lsh, Hyper(), LOOP_SERVE, K=8,
                             epochs=1, batch=512, cfg=LOOP_CFG,
                             guard=GuardConfig(max_ratio=1e-9),
                             base_state=st0)
    assert rec.updater.seq == 1             # replay re-trips, stays rejected
    _assert_states_bit_identical(rec.state, pre)


# ------------------------------------------------ parity with the JAX loop

JLOOP_SERVE = JServeConfig(topn=5, micro_batch=8, C=32, n_seeds=4, cap=8,
                           n_popular=16)
COUNTERS = ("loop.publishes", "loop.ckpts", "loop.drift_rebuilds",
            "loop.slices_trained", "loop.guard_trips", "loop.quarantined",
            "loop.slice_failures", "online.updates", "online.micro_epochs",
            "resil.wal.appends", "resil.guard_trips")


def _jax_loop(root, online_state, cfg):
    jst0, _, jcfg, _ = online_state
    up = jwal.OnlineUpdater(jst0, jcfg, JHyper(), root=str(root), K=8,
                            epochs=1, batch=512)
    svc = JOnlineLoop.build_service(jst0, JLOOP_SERVE, tail_cap=cfg.tail_cap)
    hold = tuple(np.asarray(a)[:200] for a in (jst0.sp.rows, jst0.sp.cols,
                                               jst0.sp.vals))
    return JOnlineLoop(up, svc, JLoopConfig(**dataclasses.asdict(cfg)),
                       holdout=hold)


class _Probe:
    """Reads each slice's drift probe (the ``loop.drift_rmse`` gauge, and
    the trip counter) and the state the service served from."""

    def __init__(self):
        self.rmse, self.trips, self.served = [], [], []

    def before(self, s, loop):
        svc = loop.svc
        self.served.append((svc.planes, svc.index, svc.sp, svc.popular,
                            svc._flat_ids()))

    def after(self, loop):
        self.rmse.append(loop.obs.gauge("loop.drift_rmse", float("nan")))
        self.trips.append(int(loop.obs.counter("loop.drift_rebuilds")))


def _step_both(jloop, tloop, n_slices):
    """Drive both loops slice by slice on `_drive_loop`'s schedule; →
    per-slice snapshots of each: (state, seq, counters, drift rmse,
    trips, WAL entries), and the port's served results with the state
    each flush served from."""
    out, served = [], []
    probes = {True: _Probe(), False: _Probe()}
    shape = {True: (jloop.state.M, jloop.state.N),
             False: (tloop.state.M, tloop.state.N)}
    for s in range(n_slices):
        row = []
        for lp, jax_side in ((jloop, True), (tloop, False)):
            probe = probes[jax_side]
            M, N = shape[jax_side]
            rng = np.random.default_rng(500 + s)
            lp.svc.submit(rng.integers(0, M, 16).astype(np.int32))
            if s % 2 == 0:
                M, N = M + 4, N + 2
                nr, nc, nv = _delta(lp.state, M, N, seed=1000 + s, n=250)
                key = jax.random.PRNGKey(70 + s)
                lp.offer_delta(nr, nc, nv, np.asarray(key) if jax_side
                               else convert.key_from_numpy(key),
                               M_new=M, N_new=N)
                shape[jax_side] = (M, N)
            if not jax_side:
                probe.before(s, lp)
            lp.run_slice()
            if lp.svc._rebuilder is not None:
                lp.svc._rebuilder.join(60)
            probe.after(lp)
            if not jax_side:
                served.append((probe.served[-1], lp.svc.take_results()))
            row.append(dict(
                state=lp.state, seq=lp.updater.seq,
                counters={c: int(lp.obs.counter(c)) for c in COUNTERS},
                rmse=probe.rmse[-1], trips=probe.trips[-1],
                entries={e.seq: e for e in lp.updater.wal.entries(after=0)}))
        out.append(row)
    return out, served


@pytest.mark.parametrize("drift_tol", [0.10, -0.5],
                         ids=["no-trip", "trip-every-probe"])
def test_loop_matches_jax_slice_by_slice(online_state, tmp_path, drift_tol):
    """Six slices of `tests/test_resil.py`'s schedule in both packages
    from one state.  ``drift_tol = -0.5`` makes every probe past the
    first two trip (a publish and a background rebuild), far from the
    threshold in both packages."""
    cfg = dataclasses.replace(LOOP_CFG, drift_tol=drift_tol)
    jloop = _jax_loop(tmp_path / "jax", online_state, cfg)
    tloop = _resil_loop(tmp_path / "port", online_state, cfg=cfg)
    rows, served = _step_both(jloop, tloop, 6)
    prev_N = online_state[1].N
    window = []
    for s, (j, t) in enumerate(rows):
        _assert_states_close(t["state"], j["state"], prev_N)
        prev_N = t["state"].N
        assert t["seq"] == j["seq"], s
        assert t["counters"] == j["counters"], (s, t["counters"],
                                                j["counters"])
        assert t["trips"] == j["trips"], s
        if (s + 1) % cfg.drift_every == 0:
            assert abs(t["rmse"] - j["rmse"]) <= 1e-5, (s, t["rmse"],
                                                        j["rmse"])
            tripped = False
            if len(window) >= 2:           # away from the trip's edge
                edge = min(window) * (1.0 + cfg.drift_tol)
                assert abs(j["rmse"] - edge) >= 1e-3 * edge, (s, j["rmse"],
                                                             edge)
                tripped = j["rmse"] > edge
            window = (window + [j["rmse"]])[-cfg.drift_window:]
            if tripped:
                window = []
        assert sorted(t["entries"]) == sorted(j["entries"]), s
        for q, je in j["entries"].items():
            te = t["entries"][q]
            assert te.meta == je.meta, (s, q)
            assert sorted(te.arrays) == sorted(je.arrays), (s, q)
            for k, a in je.arrays.items():
                b = te.arrays[k]
                assert a.dtype == b.dtype and np.array_equal(a, b), (q, k)
    assert rows[-1][1]["counters"]["loop.drift_rebuilds"] == (
        1 if drift_tol < 0 else 0)
    # every flush the port served equals its plain versions on the state
    # it served from
    n_checked = 0
    for (planes, index, sp, popular, flat), results in served:
        for users, scores, items in results:
            ids = torch.from_numpy(users)
            s_ref, i_ref = recommend_walked_kernel(
                planes, index, sp, ids, popular, flat,
                n_seeds=LOOP_SERVE.n_seeds, cap=LOOP_SERVE.cap,
                C=LOOP_SERVE.C, window=LOOP_SERVE.seed_window,
                tail_scan=index.tail_fill > 0, topn=LOOP_SERVE.topn,
                tile_b=LOOP_SERVE.tile_b, impl="ref")
            assert_topn_close(torch.from_numpy(scores),
                              torch.from_numpy(items), s_ref, i_ref)
            n_checked += 1
    assert n_checked >= 6


@pytest.fixture(scope="module")
def jax_loop_reference(online_state, tmp_path_factory):
    """The JAX package's uninterrupted 6-slice arm."""
    loop = _jax_loop(tmp_path_factory.mktemp("jloop-ref"), online_state,
                     LOOP_CFG)
    killed, snaps = _drive_loop(loop, 6, jax_side=True)
    assert not killed
    return snaps


def test_jax_loop_killed_at_ckpt_recovers_in_the_port(online_state,
                                                      jax_loop_reference,
                                                      tmp_path):
    jst0, st0, _, lsh = online_state
    jloop = _jax_loop(tmp_path, online_state, LOOP_CFG)
    killed, _ = _drive_loop(jloop, 6, kill_site="loop.ckpt", kill_call=1,
                            jax_side=True)
    assert killed
    del jloop
    rec = OnlineLoop.recover(str(tmp_path), lsh, Hyper(), LOOP_SERVE, K=8,
                             epochs=1, batch=512, cfg=LOOP_CFG,
                             base_state=st0)
    assert rec.updater.seq in jax_loop_reference
    want = jax_loop_reference[rec.updater.seq]
    _assert_states_close(rec.state, want, st0.N)
    assert int(rec.obs.counter("resil.wal.replayed")) >= 1
    assert rec.slice_count == 4            # the checkpoint's cursor + replay
    rec.svc.submit(np.arange(16, dtype=np.int32))
    rec.run_slice()
    assert rec.svc.stats()["dropped"] == 0


def test_port_loop_recovers_in_jax(online_state, loop_reference, tmp_path):
    jst0, _, jcfg, _ = online_state
    loop = _resil_loop(tmp_path, online_state)
    killed, _ = _drive_loop(loop, 6, kill_site="loop.ckpt", kill_call=1)
    assert killed
    del loop
    rec = JOnlineLoop.recover(str(tmp_path), jcfg, JHyper(), JLOOP_SERVE,
                              K=8, epochs=1, batch=512,
                              cfg=JLoopConfig(**dataclasses.asdict(LOOP_CFG)),
                              base_state=jst0)
    assert rec.updater.seq in loop_reference
    _assert_states_close(loop_reference[rec.updater.seq], rec.state, jst0.N)
    assert rec.slice_count == 4 and rec._micro > 0


def test_loop_recover_replays_plain_updater_entries_too(online_state,
                                                        tmp_path):
    """A direct `updater.update()` between slices shares the loop's seq
    space; `recover` replays it through `online_update` beside the slice
    entries, to the same bits."""
    _, st0, _, lsh = online_state
    cfg = dataclasses.replace(LOOP_CFG, ckpt_every=0)
    loop = _resil_loop(tmp_path, online_state, cfg=cfg)
    loop.run_slice()
    M, N = loop.state.M + 3, loop.state.N + 1
    loop.updater.update(*_delta(loop.state, M, N, seed=7, n=200),
                        prng.PRNGKey(8), M_new=M, N_new=N)
    loop.run_slice()
    kinds = [e.meta.get("kind") for e in loop.updater.wal.entries(after=0)]
    assert kinds == ["slice", None, "slice"]
    rec = OnlineLoop.recover(str(tmp_path), lsh, Hyper(), LOOP_SERVE, K=8,
                             epochs=1, batch=512, cfg=cfg, base_state=st0)
    assert rec.updater.seq == loop.updater.seq == 3
    _assert_states_bit_identical(rec.state, loop.state)


def test_service_answers_a_user_past_the_published_rows_like_jax(
        online_state):
    """The loop's serve phase meets users that training has grown but not
    yet published.  The JAX package's gathers clamp such an id to the
    last row; the port's plain scorer and `full_topn` do the same (the
    CUDA scorer clamps too)."""
    from repro.serve import service as jservice
    from repro_torch.kernels.candidate_score.ref import score_topn_ref
    from repro_torch.serve import full_topn
    jst0, st0, _, _ = online_state
    users = np.array([0, st0.M - 1, st0.M, st0.M + 7], np.int32)
    s, i = full_topn(st0.params, torch.from_numpy(users), topn=5)
    js, ji = jservice.full_topn(jst0.params, jax.numpy.asarray(users),
                                topn=5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(i[2], i[1]) and torch.equal(i[3], i[1])
    svc = OnlineLoop.build_service(st0, LOOP_SERVE, tail_cap=16)
    cand = torch.arange(32, dtype=torch.int32).repeat(4, 1)
    p = svc.planes
    got = score_topn_ref(p.row, p.mu, p.col, torch.from_numpy(users), cand,
                         topn=5)
    last = score_topn_ref(p.row, p.mu, p.col,
                          torch.full((4,), st0.M - 1, dtype=torch.int32),
                          cand, topn=5)
    assert torch.equal(got[1][2:], last[1][2:])
    assert torch.equal(got[0][2:], last[0][2:])
    svc.submit(users)
    svc.flush()
    assert svc.stats()["users"] == 4 and svc.stats()["fallbacks"] == 0
