"""Port vs JAX package: the resilience layer's core — the deterministic
scatter-add (`core/scatter.py`), the background `IndexRebuilder`
(`resil/rebuild.py`) and the write-ahead log with its crash-safe
`OnlineUpdater` (`resil/wal.py`), on the CPU.

* `index_add_det_` on the CPU is ``index_add_`` bit for bit (1-D, 2-D,
  column-slice views, all ids colliding), and ``index_add_`` adds in
  index order — the order the card's kernel reproduces;
* the rebuilder validates before it hands over, never hands over a
  failed or corrupt build, and the latest submission wins — the worker
  is held on a `threading.Event`, never timed by a sleep;
* on `tests/test_resil.py::online_state`'s shapes (M = 120, N = 50,
  2,000 ratings; G = 8, p = 1, q = 6; F = 16, K = 8) the port's crash →
  recover → replay is bit-identical to an uninterrupted port run, poison
  is refused before logging, a divergence rollback is replay-stable and
  mismatched static arguments are refused;
* across packages, a WAL plus checkpoint that one package's
  `OnlineUpdater` wrote is recovered by the other: parameters within
  `test_torch_online.py`'s PATH_TOL (rtol / atol 1e-5) of the writer's
  own recovery, S within rtol 1e-4 / atol 1e-3, signature bits equal.
"""
import dataclasses
import os
import threading

import jax
import jax.numpy as jnp
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
from repro.resil import faults as jfaults
from repro.resil import wal as jwal
from repro.train import checkpoint as jckpt
from repro_torch import convert, prng
from repro_torch.core import online, scatter, simlsh
from repro_torch.core.sgd import Hyper
from repro_torch.resil import (DivergenceError, GuardConfig, IndexRebuilder,
                               IndexValidationError, OnlineUpdater,
                               PoisonBatchError, WriteAheadLog, faults,
                               validate_index, wal)
from repro_torch.resil.faults import FaultSpec, InjectedFault
from repro_torch.train import checkpoint

PATH_TOL = dict(rtol=1e-5, atol=1e-5)
S_TOL = dict(rtol=1e-4, atol=1e-3)
FIELDS = ("U", "V", "b", "bh", "W", "C", "mu")


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    faults.uninstall()
    jfaults.uninstall()


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------- scatter

def _scatter_case(kind, rng):
    if kind == "1-D":
        return torch.zeros(40), rng.integers(0, 40, 300), (300,)
    if kind == "2-D":
        return torch.zeros(40, 7), rng.integers(0, 40, 300), (300, 7)
    if kind == "column slice":
        return torch.zeros(40, 9)[:, 2:7], rng.integers(0, 40, 300), (300, 5)
    if kind == "one column of a plane":
        return torch.zeros(40, 9)[:, 4], rng.integers(0, 40, 300), (300,)
    return torch.zeros(3, 4), np.full(500, 1), (500, 4)      # all collide


@pytest.mark.parametrize("kind", ["1-D", "2-D", "column slice",
                                  "one column of a plane", "all colliding"])
def test_index_add_det_on_cpu_is_index_add(kind):
    rng = np.random.default_rng(0)
    dst, idx, shape = _scatter_case(kind, rng)
    # values whose float32 sum depends on the order of the additions
    src = torch.tensor((rng.normal(size=shape)
                        * 10.0 ** rng.integers(-4, 5, shape)).astype(
                            np.float32))
    dst.copy_(torch.tensor(rng.normal(size=dst.shape).astype(np.float32)))
    idx = torch.tensor(idx)
    want = dst.clone().index_add_(0, idx, src)
    base = dst.clone()
    got = scatter.index_add_det_(dst, idx, src)
    assert got is dst and torch.equal(got, want)
    out = scatter.index_add_det(base, idx, src)      # out of place
    assert torch.equal(out, want) and not torch.equal(base, want)
    assert scatter.segment_plan(idx) is None         # no sort on the CPU


def test_index_add_adds_in_index_order():
    """The order the card's segment_add kernel reproduces: ``index_add_``
    on the CPU equals a Python loop ``dst[idx[i]] += src[i]`` in float32,
    on sums whose rounding depends on the order."""
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 5, 400)
    src = (rng.normal(size=(400, 3)) * 10.0 ** rng.integers(-6, 7, (400, 3))
           ).astype(np.float32)
    want = np.zeros((5, 3), np.float32)
    for i, k in enumerate(idx):
        want[k] += src[i]
    got = scatter.index_add_det_(torch.zeros(5, 3), torch.tensor(idx),
                                 torch.tensor(src))
    np.testing.assert_array_equal(got.numpy(), want)
    shuffled = np.zeros((5, 3), np.float32)
    for i in rng.permutation(400):
        shuffled[idx[i]] += src[i]
    assert not np.array_equal(shuffled, want), "the order must matter here"


def test_index_add_det_refuses_other_devices_and_shapes():
    """Meta tensors take `index_add_`'s shape-only branch (a dry run
    counts through the scatter); a device that is neither the CPU, meta
    nor the card is refused (a stand-in: no such device exists here)."""
    out = scatter.index_add_det_(torch.zeros(3, device="meta"),
                                 torch.zeros(1, dtype=torch.long,
                                             device="meta"),
                                 torch.zeros(1, device="meta"))
    assert out.shape == (3,) and out.device.type == "meta"

    class OnXpu:
        device = torch.device("xpu")

    with pytest.raises(ValueError, match="unsupported device"):
        scatter.index_add_det_(OnXpu(), torch.zeros(1, dtype=torch.long),
                               torch.zeros(1))


# ---------------------------------------------------------------- rebuild

@pytest.fixture(scope="module")
def small_sigs():
    """`tests/test_resil.py::small_index`'s signatures (the JAX package's
    encode), as a tensor."""
    rng = np.random.default_rng(0)
    rows = np.repeat(np.arange(60), 4).astype(np.int32)
    cols = rng.integers(0, 40, 240).astype(np.int32)
    vals = rng.integers(1, 6, 240).astype(np.float32)
    sp = jsparse.from_coo(rows, cols, vals, (60, 40))
    sigs = jsim.encode(sp, jsim.SimLSHConfig(G=8, p=2, q=8),
                       jax.random.PRNGKey(0))
    return torch.tensor(np.asarray(sigs))


def _corrupt(idx):
    ids = idx.sorted_ids.clone()
    ids[0, 0] = ids[0, 1]
    return dataclasses.replace(idx, sorted_ids=ids)


def test_rebuilder_validates_then_swaps_like_jax(small_sigs):
    rb = IndexRebuilder()
    assert rb.submit(small_sigs, tail_cap=8)
    rb.join(60)
    status, idx, err = rb.take()
    assert status == "ready" and err is None
    assert idx.n_base == small_sigs.shape[1] and idx.tail_fill == 0
    assert idx.device.type == "cpu" and validate_index(idx) == []
    assert rb.take()[0] == "idle"                 # handed over exactly once
    assert (rb.builds, rb.failures, rb.swaps_ready) == (1, 0, 1)
    jrb = jresil.IndexRebuilder()
    jrb.submit(jnp.asarray(small_sigs.numpy()), tail_cap=8)
    jrb.join(60)
    _, jidx, _ = jrb.take()
    for f in ("sorted_sigs", "sorted_ids", "bucket_lo", "bucket_hi",
              "slot_of", "tail_sigs", "tail_ids"):
        np.testing.assert_array_equal(_np(getattr(idx, f)),
                                      np.asarray(getattr(jidx, f)), f)


def test_rebuilder_failed_build_is_never_handed_over(small_sigs):
    rb = IndexRebuilder()
    with faults.injected({"serve.rebuild": FaultSpec(at_calls=(0,))}):
        rb.submit(small_sigs, tail_cap=8)
        rb.join(60)
    status, idx, err = rb.take()
    assert status == "failed" and idx is None
    assert isinstance(err, InjectedFault) and rb.failures == 1
    assert rb.status() == "idle"


def test_rebuilder_rejects_corrupt_build(small_sigs):
    rb = IndexRebuilder()
    with faults.injected({"serve.rebuild.index": FaultSpec(
            kind="corrupt", mutate=_corrupt, at_calls=(0,))}):
        rb.submit(small_sigs, tail_cap=8)
        rb.join(60)
    status, idx, err = rb.take()
    assert status == "failed" and idx is None
    assert isinstance(err, IndexValidationError)
    assert "permutation" in str(err)


def test_rebuilder_latest_submission_wins(small_sigs):
    """The first build is held inside the worker on an Event, so the two
    later submissions are staged while it runs, whatever the machine's
    load; only the newest is built next."""
    gate, entered = threading.Event(), threading.Event()

    def hold(idx):
        entered.set()
        assert gate.wait(60)
        return idx

    rb = IndexRebuilder()
    with faults.injected({"serve.rebuild.index": FaultSpec(
            kind="corrupt", mutate=hold, at_calls=(0,))}):
        assert rb.submit(small_sigs, tail_cap=8)
        assert entered.wait(60)
        assert rb.status() == "building"
        assert rb.take() == ("building", None, None)
        assert not rb.submit(small_sigs[:, :10], tail_cap=8)
        assert not rb.submit(small_sigs[:, :20], tail_cap=8)
        gate.set()
        rb.join(60)
        status, idx, _ = rb.take()       # first build + restart of staged
        assert status == "ready" and idx.n_base == small_sigs.shape[1]
        rb.join(60)
    status, idx, _ = rb.take()
    assert status == "ready" and idx.n_base == 20   # latest staged won
    assert rb.builds == 2


def test_rebuilder_records_spans_and_counters(small_sigs):
    from repro_torch import obs
    reg = obs.Registry(enabled=True)
    rb = IndexRebuilder(reg)
    rb.submit(small_sigs, tail_cap=8)
    rb.join(60)
    rb.take()
    with faults.injected({"serve.rebuild": FaultSpec(at_calls=(0,))}):
        rb.submit(small_sigs, tail_cap=8)
        rb.join(60)
    assert rb.take()[0] == "failed"
    assert reg.counter("serve.rebuild.built") == 1
    assert reg.counter("serve.rebuild.failed") == 1
    assert len(reg.span_durations("serve.rebuild.bg")) == 2
    assert len(reg.span_durations("serve.rebuild.bg.validate")) == 1
    assert reg.gauge("serve.rebuild.last_build_s", -1.0) >= 0


# ---------------------------------------------------------------- WAL

@pytest.fixture(scope="module")
def online_state():
    """`tests/test_resil.py::online_state` in both packages: the JAX
    package's state, the port's copy of it, and the lsh config of each."""
    spec = dataclasses.replace(jsyn.MOVIELENS_LIKE, M=120, N=50, nnz=2000)
    rows, cols, vals, _ = jsyn.generate(spec, seed=0)
    sp = jsparse.from_coo(rows, cols, vals, (spec.M, spec.N))
    cfg = jsim.SimLSHConfig(G=8, p=1, q=6)
    key = jax.random.PRNGKey(0)
    sigs, S = jsim.encode(sp, cfg, key, return_accumulators=True)
    JK = jtopk.topk_from_signatures(sigs, jax.random.PRNGKey(1), K=8,
                                    band_cap=cfg.band_cap)
    params = jmodel.init_from_data(jax.random.PRNGKey(2), sp, 16, 8)
    jst = jonline.OnlineState(params=params, S=S, JK=JK, sp=sp, M=spec.M,
                              N=spec.N, hash_key=key)
    p = jst.params
    tst = convert.online_state_from_numpy(
        {f: np.asarray(getattr(p, f)) for f in FIELDS}, np.asarray(S),
        np.asarray(JK), (np.asarray(sp.rows), np.asarray(sp.cols),
                         np.asarray(sp.vals)), np.asarray(key), spec.M,
        spec.N, device="cpu")
    return jst, tst, cfg, simlsh.SimLSHConfig(**dataclasses.asdict(cfg))


def _delta(st, M_new, N_new, seed, n=250):
    """`tests/test_resil.py::_delta`: fresh ΔΩ triples disjoint from
    ``st.sp``, as numpy."""
    rng = np.random.default_rng(seed)
    nr = rng.integers(0, M_new, n).astype(np.int32)
    nc = rng.integers(0, N_new, n).astype(np.int32)
    pair = np.unique(nr.astype(np.int64) * N_new + nc)
    old = set((_np(st.sp.rows).astype(np.int64) * N_new
               + _np(st.sp.cols)).tolist())
    pair = np.asarray([p for p in pair.tolist() if p not in old])
    nr = (pair // N_new).astype(np.int32)
    nc = (pair % N_new).astype(np.int32)
    nv = rng.uniform(1, 5, nr.shape[0]).astype(np.float32)
    return nr, nc, nv


def _assert_states_bit_identical(a, b):
    ta, tb = wal.state_tree(a), wal.state_tree(b)
    for k in ta:
        xa, xb = _np(ta[k]), _np(tb[k])
        assert xa.dtype == xb.dtype and np.array_equal(xa, xb), k


def _run(up, st, n, seed0, crash_at=None, key0=50):
    """Apply ``n`` grown deltas through ``up``; the delta at index
    ``crash_at`` raises at ``online.update`` (after it was logged).  →
    (state before the crashed delta, its inputs)."""
    M, N = st.M, st.N
    for i in range(n):
        M, N = M + 6, N + 3
        d = _delta(up.state, M, N, seed=seed0 + i)
        key = prng.PRNGKey(key0 + i)
        if i == crash_at:
            pre = up.state
            with faults.injected({"online.update": FaultSpec(at_calls=(0,))}):
                with pytest.raises(InjectedFault):
                    up.update(*d, key, M_new=M, N_new=N)
            return pre, (d, key, M, N)
        up.update(*d, key, M_new=M, N_new=N)
    return up.state, None


def test_wal_crash_mid_ingest_replays_bit_identical(online_state, tmp_path):
    _, st0, _, lsh = online_state
    hp = Hyper()
    kw = dict(K=8, epochs=1, ckpt_every=2)
    up = OnlineUpdater(st0, lsh, hp, root=str(tmp_path / "crash"), **kw)
    pre, (d, key, M2, N2) = _run(up, st0, 3, 100, crash_at=2)
    assert up.seq == 2 and up.state is pre        # logged, not applied
    assert checkpoint.latest_step(str(tmp_path / "crash" / "ckpt")) == 2
    assert up.wal.seqs() == [3]                   # 1, 2 pruned by the cut
    rec = OnlineUpdater.recover(str(tmp_path / "crash"), lsh, hp,
                                device="cpu", **kw)
    assert rec.seq == 3
    whole = OnlineUpdater(st0, lsh, hp, root=str(tmp_path / "whole"), **kw)
    _run(whole, st0, 3, 100)
    _assert_states_bit_identical(rec.state, whole.state)
    ref = online.online_update(pre, *d, lsh, hp, key, M_new=M2, N_new=N2,
                               K=8, epochs=1)
    _assert_states_bit_identical(rec.state, ref)
    assert rec.state.params.U.device.type == "cpu"
    assert int(rec.obs.counter("resil.wal.replayed")) == 1


def test_wal_refuses_poison_before_logging(online_state, tmp_path):
    _, st0, _, lsh = online_state
    up = OnlineUpdater(st0, lsh, Hyper(), root=str(tmp_path), K=8, epochs=1)
    nr = np.array([1, 2], np.int32)
    with pytest.raises(PoisonBatchError):
        up.update(nr, nr, np.array([np.nan, 1.0], np.float32),
                  prng.PRNGKey(0), M_new=st0.M, N_new=st0.N)
    assert up.wal.seqs() == []      # the redo log never saw the batch
    assert up.seq == 0 and up.state is st0


def test_wal_append_fault_logs_nothing(online_state, tmp_path):
    _, st0, _, lsh = online_state
    up = OnlineUpdater(st0, lsh, Hyper(), root=str(tmp_path), K=8, epochs=1)
    d = _delta(st0, st0.M + 6, st0.N + 3, seed=5)
    with faults.injected({"wal.append": FaultSpec(at_calls=(0,))}):
        with pytest.raises(InjectedFault):
            up.update(*d, prng.PRNGKey(0), M_new=st0.M + 6,
                      N_new=st0.N + 3)
    assert up.wal.seqs() == [] and up.seq == 0 and up.state is st0
    assert not os.listdir(up.wal.directory)


def test_wal_divergence_rollback_is_replay_stable(online_state, tmp_path):
    _, st0, _, lsh = online_state
    hp = Hyper()
    guard = GuardConfig(max_ratio=1e-9)   # trips on any real update
    up = OnlineUpdater(st0, lsh, hp, root=str(tmp_path), K=8, epochs=1,
                       guard=guard)
    M2, N2 = st0.M + 6, st0.N + 3
    with pytest.raises(DivergenceError):
        up.update(*_delta(st0, M2, N2, seed=5), prng.PRNGKey(0), M_new=M2,
                  N_new=N2)
    assert up.state is st0          # rollback = keep what you had
    assert up.seq == 1              # but the entry is logged
    rec = OnlineUpdater.recover(str(tmp_path), lsh, hp, K=8, epochs=1,
                                base_state=st0, guard=guard)
    assert rec.seq == 1             # replay re-trips and stays rejected
    _assert_states_bit_identical(rec.state, st0)
    assert int(rec.obs.counter("resil.guard_trips")) == 1


def test_wal_recover_refuses_mismatched_static_args(online_state, tmp_path):
    _, st0, _, lsh = online_state
    hp = Hyper()
    up = OnlineUpdater(st0, lsh, hp, root=str(tmp_path), K=8, epochs=1,
                       ckpt_every=100)
    M2, N2 = st0.M + 6, st0.N + 3
    up.update(*_delta(st0, M2, N2, seed=9), prng.PRNGKey(0), M_new=M2,
              N_new=N2)
    for kw in (dict(K=8, epochs=2), dict(K=4, epochs=1)):
        with pytest.raises(ValueError, match="static arguments"):
            OnlineUpdater.recover(str(tmp_path), lsh, hp, base_state=st0,
                                  **kw)
    with pytest.raises(ValueError, match="static arguments"):
        OnlineUpdater.recover(str(tmp_path), dataclasses.replace(lsh, q=5),
                              hp, K=8, epochs=1, base_state=st0)
    with pytest.raises(FileNotFoundError, match="base_state"):
        OnlineUpdater.recover(str(tmp_path), lsh, hp, K=8, epochs=1)


def test_wal_recover_refuses_loop_entries(online_state, tmp_path):
    _, st0, _, lsh = online_state
    log = WriteAheadLog(str(tmp_path / "wal"))
    log.append(1, dict(rows=np.zeros(1, np.int32)), dict(kind="slice"))
    with pytest.raises(ValueError, match="'slice' entry"):
        OnlineUpdater.recover(str(tmp_path), lsh, Hyper(), K=8, epochs=1,
                              base_state=st0)


def test_write_ahead_log_appends_atomically(tmp_path):
    log = WriteAheadLog(str(tmp_path))
    a = dict(rows=np.arange(3, dtype=np.int32),
             key=np.array([0, 7], np.uint32))
    log.append(1, a, dict(M_new=4, seq=1))
    log.append(2, a, dict(M_new=5, seq=2))
    with pytest.raises(ValueError, match="already exists"):
        log.append(2, a, {})
    open(os.path.join(str(tmp_path), ".tmp-000000000009-1"), "wb").close()
    assert log.seqs() == [1, 2] and log.last_seq() == 2
    e = log.entries(after=1)[0]
    assert e.seq == 2 and e.meta == dict(M_new=5, seq=2)
    np.testing.assert_array_equal(e.arrays["rows"], a["rows"])
    assert e.arrays["key"].dtype == np.uint32
    assert log.prune(1) == 1 and log.seqs() == [2]
    assert not [f for f in os.listdir(str(tmp_path)) if f.startswith(".tmp")]


def _jax_state_as_port(jst):
    p = jst.params
    return convert.online_state_from_numpy(
        {f: np.asarray(getattr(p, f)) for f in FIELDS}, np.asarray(jst.S),
        np.asarray(jst.JK), (np.asarray(jst.sp.rows), np.asarray(jst.sp.cols),
                             np.asarray(jst.sp.vals)),
        np.asarray(jst.hash_key), jst.M, jst.N, device="cpu")


def _assert_states_close(tst, jst):
    for f in FIELDS:
        np.testing.assert_allclose(_np(getattr(tst.params, f)),
                                   np.asarray(getattr(jst.params, f)),
                                   err_msg=f, **PATH_TOL)
    np.testing.assert_allclose(_np(tst.S), np.asarray(jst.S), **S_TOL)
    np.testing.assert_array_equal(
        _np(simlsh.pack_bits(tst.S >= 0)),
        np.asarray(jsim.pack_bits(jst.S >= 0)))
    for a, b in ((tst.JK, jst.JK), (tst.sp.rows, jst.sp.rows),
                 (tst.sp.cols, jst.sp.cols), (tst.sp.vals, jst.sp.vals)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    np.testing.assert_array_equal(wal.key_words(tst.hash_key),
                                  np.asarray(jst.hash_key))
    assert (tst.M, tst.N) == (jst.M, jst.N)


def test_jax_written_wal_recovers_in_the_port(online_state, tmp_path):
    """The JAX `OnlineUpdater` checkpoints after 2 updates and crashes on
    the 3rd after logging it; the port's `recover` restores that
    checkpoint and replays the entry through its own `online_update`."""
    jst0, _, jcfg, lsh = online_state
    hp, jhp = Hyper(), JHyper()
    root = str(tmp_path)
    up = jwal.OnlineUpdater(jst0, jcfg, jhp, root=root, K=8, epochs=1,
                            ckpt_every=2)
    M, N = jst0.M, jst0.N
    for i in range(3):
        M, N = M + 6, N + 3
        d = _delta(up.state, M, N, seed=300 + i)
        if i < 2:
            up.update(*d, jax.random.PRNGKey(60 + i), M_new=M, N_new=N)
            continue
        with jfaults.injected({"online.update":
                               jresil.FaultSpec(at_calls=(0,))}):
            with pytest.raises(jresil.InjectedFault):
                up.update(*d, jax.random.PRNGKey(60 + i), M_new=M, N_new=N)
    # the checkpoint alone restores bit for bit in the port
    tree, step = checkpoint.restore(os.path.join(root, "ckpt"),
                                    wal._template())
    assert step == 2
    _assert_states_bit_identical(wal.state_from_tree(tree, "cpu"),
                                 _jax_state_as_port(up.state))
    want = jwal.OnlineUpdater.recover(root, jcfg, jhp, K=8, epochs=1,
                                      ckpt_every=2)
    got = OnlineUpdater.recover(root, lsh, hp, K=8, epochs=1, ckpt_every=2,
                                device="cpu")
    assert got.seq == want.seq == 3
    _assert_states_close(got.state, want.state)


def test_port_written_wal_recovers_in_jax(online_state, tmp_path):
    """The reverse: the port writes the log and the checkpoint, the JAX
    package recovers from them."""
    jst0, st0, jcfg, lsh = online_state
    root = str(tmp_path)
    up = OnlineUpdater(st0, lsh, Hyper(), root=root, K=8, epochs=1,
                       ckpt_every=2)
    _run(up, st0, 3, 400, crash_at=2, key0=70)
    tree, step = jckpt.restore(os.path.join(root, "ckpt"), jwal._template())
    assert step == 2 and np.asarray(tree["hash_key"]).dtype == np.uint32
    want = OnlineUpdater.recover(root, lsh, Hyper(), K=8, epochs=1,
                                 ckpt_every=2, device="cpu")
    got = jwal.OnlineUpdater.recover(root, jcfg, JHyper(), K=8, epochs=1,
                                     ckpt_every=2)
    assert got.seq == want.seq == 3
    _assert_states_close(want.state, got.state)


def test_state_tree_round_trips_through_a_checkpoint(online_state,
                                                     tmp_path):
    _, st0, _, _ = online_state
    tree = wal.state_tree(st0)
    assert sorted(tree) == sorted(wal._template())
    assert tree["hash_key"].dtype == np.uint32
    checkpoint.save(str(tmp_path), tree, step=5, sync=True)
    back, step = checkpoint.restore(str(tmp_path), wal._template())
    assert step == 5
    _assert_states_bit_identical(wal.state_from_tree(back, "cpu"), st0)
    no_key = dataclasses.replace(st0, hash_key=None)
    with pytest.raises(ValueError, match="hash_key"):
        wal.state_tree(no_key)
