"""Port vs JAX package: online learning, paper Alg. 4 (`core/online.py`)
and its prerequisites, on the CPU at the JAX package's own test size
(`tests/test_online.py::small_state`: `MOVIELENS_LIKE` reshaped to
M = 300, N = 80, 6,000 ratings; G = 8, p = 1, q = 6; F = 16, K = 8).

Both packages start from one state, carried across as numpy
(`convert.online_state_from_numpy`), and get the same ΔΩ.  Tolerances:

* `update_accumulators`: S within rtol 1e-4 / atol 1e-3 and signature
  bits equal except where |S| < 1e-3 — the JAX package's own rule for
  incremental against fresh signatures (`test_online.py`);
* `merge_coo`, `assemble(lookup_sp=…)`, J^K, the merged Ω̂ and the
  micro-epoch schedule: bit-exact;
* `grow_params`: old slices bit-exact, new U/V rows within 1e-6 (the
  port's `prng.normal` is within a few ulp of `jax.random.normal`);
* `masked_culsh_step`, `online_update`, `micro_epoch`: new slices within
  rtol 1e-5 / atol 1e-6 (1e-5 for the multi-step paths), old slices
  bit-identical to the input;
* `check_divergence` and the `validate` checks: the same problem strings
  and the same refusals as the JAX package's, but for one declared
  difference: `validate_index`'s recall smoke probes each item in the
  window centred on its own slot, so it accepts a correct index whose
  buckets hold more than 4 items, which the JAX smoke (a bucket's
  first 4 slots) refuses; on buckets of at most 4 the verdicts are equal.
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
from repro.resil import guard as jguard
from repro.resil import validate as jvalidate
from repro_torch import convert, prng
from repro_torch.core import model, online, simlsh
from repro_torch.core.sgd import Hyper
from repro_torch.data import sparse
from repro_torch.resil import (DivergenceError, PoisonBatchError,
                               check_accumulators, check_delta,
                               check_divergence, check_ids,
                               check_ingest_batch, validate_index)
from repro_torch.serve import build_index, insert
from repro_torch.serve.index import rebuild
from repro_torch.train import trainer

STEP_TOL = dict(rtol=1e-5, atol=1e-6)
PATH_TOL = dict(rtol=1e-5, atol=1e-5)
FIELDS = ("U", "V", "b", "bh", "W", "C")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _port_state(jst, key_words):
    p = jst.params
    return convert.online_state_from_numpy(
        {f: np.asarray(getattr(p, f)) for f in FIELDS + ("mu",)},
        np.asarray(jst.S), np.asarray(jst.JK),
        (np.asarray(jst.sp.rows), np.asarray(jst.sp.cols),
         np.asarray(jst.sp.vals)), key_words, jst.M, jst.N, device="cpu")


@pytest.fixture(scope="module")
def states():
    """The JAX package's `small_state` and the port's copy of it."""
    spec = dataclasses.replace(jsyn.MOVIELENS_LIKE, M=300, N=80, nnz=6000)
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
    return jst, _port_state(jst, np.asarray(key)), cfg


def _cfg(jcfg):
    return simlsh.SimLSHConfig(**dataclasses.asdict(jcfg))


def _delta(st, M_new, N_new, n=800, seed=3):
    """Fresh ΔΩ triples in the grown id space, disjoint from st.sp (the
    JAX package's `test_online._delta`), as numpy."""
    rng = np.random.default_rng(seed)
    nr = rng.integers(0, M_new, n).astype(np.int32)
    nc = rng.integers(0, N_new, n).astype(np.int32)
    pair = np.unique(nr.astype(np.int64) * N_new + nc)
    old = set((np.asarray(st.sp.rows).astype(np.int64) * N_new
               + np.asarray(st.sp.cols)).tolist())
    pair = np.asarray([p for p in pair.tolist() if p not in old])
    nr, nc = (pair // N_new).astype(np.int32), (pair % N_new).astype(np.int32)
    nv = rng.uniform(1, 5, nr.shape[0]).astype(np.float32)
    return nr, nc, nv


def _new_cols_delta(st, N2, seed=11):
    """ΔΩ over old rows whose columns are all new (the JAX package's
    `test_online_update_then_fresh_topk_for_new_columns`)."""
    nr, nc, nv = _delta(st, st.M, N2, seed=seed)
    nc = np.where(nc < st.N, (nc % 10) + st.N, nc).astype(np.int32)
    pair = np.unique(nr.astype(np.int64) * N2 + nc)
    nr = (pair // N2).astype(np.int32)
    nc = (pair % N2).astype(np.int32)
    return nr, nc, nv[:nr.shape[0]]


def assert_signature_rule(S, sigs, S_want, sigs_want, bits):
    """S within rtol 1e-4 / atol 1e-3 of ``S_want``; signature bits equal
    wherever |S_want| ≥ 1e-3.  → the number of bits that differ."""
    S, sigs, S_want, sigs_want = map(_np, (S, sigs, S_want, sigs_want))
    np.testing.assert_allclose(S, S_want, rtol=1e-4, atol=1e-3)
    tiny = np.abs(S_want) < 1e-3
    flips = 0
    for b in range(bits):
        diff = ((sigs >> b) & 1) != ((sigs_want >> b) & 1)
        assert not (diff & ~tiny[..., b]).any(), f"bit {b} differs"
        flips += int(diff.sum())
    return flips


def _assert_old_frozen(p_new, p_old, M, N):
    for f in FIELDS:
        n = M if f in ("U", "b") else N
        assert torch.equal(getattr(p_new, f)[:n], getattr(p_old, f)), f


def _assert_params_close(tp, jp, tol):
    for f in FIELDS:
        np.testing.assert_allclose(_np(getattr(tp, f)),
                                   np.asarray(getattr(jp, f)), **tol,
                                   err_msg=f)


# --------------------------------------------------------- prerequisites

def test_update_accumulators_matches_jax(states):
    jst, tst, jcfg = states
    N2 = jst.N + 12
    nr, nc, nv = _delta(jst, jst.M + 40, N2)
    S_j, sig_j = jsim.update_accumulators(jst.S, jnp.asarray(nr),
                                          jnp.asarray(nc), jnp.asarray(nv),
                                          jcfg, jst.hash_key, N2)
    S_t, sig_t = simlsh.update_accumulators(tst.S, nr, nc, nv, _cfg(jcfg),
                                            tst.hash_key, N2)
    assert S_t.shape == (jcfg.q, N2, jcfg.sig_bits)
    assert sig_t.dtype == torch.int32 and sig_t.shape == (jcfg.q, N2)
    assert_signature_rule(S_t, sig_t, S_j, sig_j, jcfg.sig_bits)


def test_update_accumulators_matches_fresh_encode(states):
    """Alg. 4 incremental hashing ≡ a fresh encode of the merged matrix
    (same key), on the port alone."""
    _, tst, jcfg = states
    cfg = _cfg(jcfg)
    M2, N2 = tst.M + 40, tst.N + 12
    nr, nc, nv = _delta(tst, M2, N2)
    S2, sigs_inc = simlsh.update_accumulators(tst.S, nr, nc, nv, cfg,
                                              tst.hash_key, N2)
    merged = sparse.from_coo(
        torch.cat([tst.sp.rows, torch.tensor(nr)]),
        torch.cat([tst.sp.cols, torch.tensor(nc)]),
        torch.cat([tst.sp.vals, torch.tensor(nv)]), (M2, N2), device="cpu")
    sigs_fresh, S_fresh = simlsh.encode(merged, cfg, tst.hash_key,
                                        return_accumulators=True)
    assert_signature_rule(S2, sigs_inc, S_fresh, sigs_fresh, cfg.sig_bits)


def test_merge_coo_matches_jax_with_growth_and_ties(states):
    jst, tst, _ = states
    M2, N2 = jst.M + 40, jst.N + 12
    nr, nc, nv = _delta(jst, M2, N2)
    # two entries that repeat observed keys: equal keys land old-first
    nr = np.concatenate([nr, np.asarray(jst.sp.rows[:2])]).astype(np.int32)
    nc = np.concatenate([nc, np.asarray(jst.sp.cols[:2])]).astype(np.int32)
    nv = np.concatenate([nv, [9.0, 8.0]]).astype(np.float32)
    want = jsparse.merge_coo(jst.sp, nr, nc, nv, (M2, N2))
    got = sparse.merge_coo(tst.sp, torch.tensor(nr), nc, nv, (M2, N2))
    assert got.shape == want.shape == (M2, N2)
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      np.asarray(getattr(want, f)))
    assert got.rows.dtype == torch.int32 and got.vals.dtype == torch.float32
    k = int(np.flatnonzero(_np(got.vals) == 9.0)[0])
    assert _np(got.vals)[k - 1] == np.asarray(jst.sp.vals)[0]   # old first


def test_grow_params_matches_jax(states):
    jst, tst, _ = states
    M2, N2 = jst.M + 40, jst.N + 12
    jp = jonline.grow_params(jst.params, M2, N2, jax.random.PRNGKey(9))
    tp = online.grow_params(tst.params, M2, N2,
                            convert.key_from_numpy(jax.random.PRNGKey(9)))
    _assert_old_frozen(tp, tst.params, jst.M, jst.N)
    for f in FIELDS:
        assert getattr(tp, f).shape == getattr(jp, f).shape
        np.testing.assert_allclose(_np(getattr(tp, f)),
                                   np.asarray(getattr(jp, f)), rtol=0,
                                   atol=1e-6, err_msg=f)
    assert tp.U.data_ptr() != tst.params.U.data_ptr()


def test_assemble_with_lookup_sp_matches_jax(states):
    jst, tst, _ = states
    M2, N2 = jst.M + 40, jst.N
    nr, nc, nv = _delta(jst, M2, N2)
    jd = jsparse.from_coo(nr, nc, nv, (M2, N2))
    td = sparse.from_coo(nr, nc, nv, (M2, N2), device="cpu")
    jall = jsparse.merge_coo(jst.sp, nr, nc, nv, (M2, N2))
    tall = sparse.merge_coo(tst.sp, nr, nc, nv, (M2, N2))
    idx = np.random.default_rng(0).permutation(len(nr))[:64].astype(np.int32)
    valid = np.arange(64) < 60
    jb = jmodel.assemble(jd, jst.JK, jnp.asarray(idx), jnp.asarray(valid),
                         lookup_sp=jall)
    tb = model.assemble(td, tst.JK, torch.tensor(idx), torch.tensor(valid),
                        lookup_sp=tall)
    for f in dataclasses.fields(tb):
        np.testing.assert_array_equal(_np(getattr(tb, f.name)),
                                      np.asarray(getattr(jb, f.name)),
                                      err_msg=f.name)
    assert float(tb.expl.sum()) > 0       # neighbour ratings found in Ω̂
    plain = model.assemble(td, tst.JK, torch.tensor(idx), torch.tensor(valid))
    assert not torch.equal(plain.expl, tb.expl)


def _step_inputs(jst, tst, seed=3):
    M2, N2 = jst.M + 40, jst.N + 12
    nr, nc, nv = _delta(jst, M2, N2, seed=seed)
    kg = jax.random.PRNGKey(9)
    jp = jonline.grow_params(jst.params, M2, N2, kg)
    tp = online.grow_params(tst.params, M2, N2, convert.key_from_numpy(kg))
    # the same starting point on both sides (the draws differ by ulps)
    tp = convert.params_from_numpy(
        **{f: np.asarray(getattr(jp, f)) for f in FIELDS + ("mu",)},
        device="cpu")
    jall = jsparse.merge_coo(jst.sp, nr, nc, nv, (M2, N2))
    tall = sparse.merge_coo(tst.sp, nr, nc, nv, (M2, N2))
    JK_j = jnp.concatenate([jst.JK, jnp.zeros((12, 8), jnp.int32)])
    JK_t = torch.cat([tst.JK, torch.zeros((12, 8), dtype=torch.int32)])
    jd = jsparse.from_coo(nr, nc, nv, (M2, N2))
    td = sparse.from_coo(nr, nc, nv, (M2, N2), device="cpu")
    n = len(nr)
    idx = np.arange(n, dtype=np.int32)
    valid = np.ones(n, bool)
    valid[-5:] = False
    jb = jmodel.assemble(jd, JK_j, jnp.asarray(idx), jnp.asarray(valid),
                         lookup_sp=jall)
    tb = model.assemble(td, JK_t, torch.tensor(idx), torch.tensor(valid),
                        lookup_sp=tall)
    return jp, tp, jb, tb


def test_masked_culsh_step_matches_jax_and_freezes_old(states):
    jst, tst, _ = states
    jp, tp, jb, tb = _step_inputs(jst, tst)
    before = dataclasses.replace(tp, **{f: getattr(tp, f).clone()
                                        for f in FIELDS})
    want = jonline.masked_culsh_step(jp, jb, JHyper(), jnp.float32(0.8),
                                     jst.M, jst.N)
    got = online.masked_culsh_step(tp, tb, Hyper(), torch.tensor(0.8),
                                   tst.M, tst.N)
    _assert_params_close(got, want, STEP_TOL)
    _assert_old_frozen(got, dataclasses.replace(
        before, **{f: getattr(before, f)[:tst.M if f in ("U", "b") else tst.N]
                   for f in FIELDS}), tst.M, tst.N)
    assert not torch.equal(got.U[tst.M:], before.U[tst.M:])   # new moved


def test_masked_culsh_step_keeps_old_rows_under_nonfinite_deltas(states):
    """An inf rating makes every delta of its sample non-finite; the old
    rows it touches must still not change (no 0·inf = NaN)."""
    jst, tst, _ = states
    _, tp, _, tb = _step_inputs(jst, tst)
    k = int(torch.nonzero((tb.i < tst.M) & (tb.j >= tst.N)
                          & (tb.valid > 0)).flatten()[0])
    r = tb.r.clone()
    r[k] = float("inf")
    bt = dataclasses.replace(tb, r=r)
    before = {f: getattr(tp, f).clone() for f in FIELDS}
    online.masked_culsh_step(tp, bt, Hyper(), torch.tensor(1.0), tst.M,
                             tst.N)
    for f in FIELDS:
        n = tst.M if f in ("U", "b") else tst.N
        assert torch.equal(getattr(tp, f)[:n], before[f][:n]), f
    assert not torch.isfinite(tp.bh[int(tb.j[k])])    # the new column took it


# ------------------------------------------------------------ Alg. 4

def _both_updates(jst, tst, jcfg, delta, M2, N2, key=9, epochs=2):
    nr, nc, nv = delta
    want = jonline.online_update(jst, jnp.asarray(nr), jnp.asarray(nc),
                                 jnp.asarray(nv), jcfg, JHyper(),
                                 jax.random.PRNGKey(key), M_new=M2,
                                 N_new=N2, K=8, epochs=epochs)
    got = online.online_update(tst, nr, nc, nv, _cfg(jcfg), Hyper(),
                               convert.key_from_numpy(
                                   jax.random.PRNGKey(key)),
                               M_new=M2, N_new=N2, K=8, epochs=epochs)
    return want, got


def test_online_update_matches_jax(states):
    jst, tst, jcfg = states
    M2, N2 = jst.M + 40, jst.N + 12
    want, got = _both_updates(jst, tst, jcfg, _delta(jst, M2, N2), M2, N2)
    assert (got.M, got.N) == (want.M, want.N) == (M2, N2)
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(_np(getattr(got.sp, f)),
                                      np.asarray(getattr(want.sp, f)))
    np.testing.assert_array_equal(_np(got.JK), np.asarray(want.JK))
    assert_signature_rule(got.S, simlsh.pack_bits(got.S >= 0), want.S,
                          jsim.pack_bits(want.S >= 0), jcfg.sig_bits)
    _assert_params_close(got.params, want.params, PATH_TOL)
    _assert_old_frozen(got.params, tst.params, tst.M, tst.N)
    assert set(got.stats) == set(want.stats)
    assert got.stats["delta_nnz"] == want.stats["delta_nnz"]
    assert got.stats["merged_nnz"] == want.stats["merged_nnz"]


def test_online_update_freezes_old_parameters(states):
    """`tests/test_online.py`'s contract, on the port."""
    _, st, jcfg = states
    M2, N2 = st.M + 40, st.N + 12
    nr, nc, nv = _delta(st, M2, N2)
    key = prng.PRNGKey(9)
    st2 = online.online_update(st, nr, nc, nv, _cfg(jcfg), Hyper(), key,
                               M_new=M2, N_new=N2, K=8, epochs=2)
    _assert_old_frozen(st2.params, st.params, st.M, st.N)
    assert torch.equal(st2.JK[:st.N], st.JK)
    assert st2.JK.shape == (N2, 8)
    k_grow, _, _ = prng.split(key, 3)
    p_init = online.grow_params(st.params, M2, N2, k_grow)
    assert not torch.equal(st2.params.U[st.M:], p_init.U[st.M:])
    assert not torch.equal(st2.params.V[st.N:], p_init.V[st.N:])


def test_online_update_then_fresh_topk_for_new_columns(states):
    """`tests/test_online.py`'s second contract, on the port, beside the
    JAX package's result for the same ΔΩ."""
    jst, st, jcfg = states
    M2, N2 = st.M, st.N + 10
    delta = _new_cols_delta(st, N2)
    want, st2 = _both_updates(jst, st, jcfg, delta, M2, N2, key=5, epochs=1)
    assert st2.S.shape == (jcfg.q, N2, jcfg.sig_bits)
    assert st2.sp.nnz == st.sp.nnz + int(delta[0].shape[0])
    assert int(st2.JK[st.N:].max()) < N2
    np.testing.assert_array_equal(_np(st2.JK), np.asarray(want.JK))
    _assert_params_close(st2.params, want.params, PATH_TOL)


def test_online_update_records_spans_and_counters(states):
    from repro_torch import obs
    _, st, jcfg = states
    M2, N2 = st.M + 5, st.N + 3
    reg = obs.Registry(enabled=True)
    st2 = online.online_update(st, *_delta(st, M2, N2, n=200), _cfg(jcfg),
                               Hyper(), prng.PRNGKey(1), M_new=M2, N_new=N2,
                               K=8, epochs=1, registry=reg)
    for name in ("update", "resign", "merge", "topk", "train"):
        assert len(reg.span_durations(f"online.{name}")) == 1
        assert st2.stats[f"{name}_seconds"] == \
            reg.span_durations(f"online.{name}")[-1]
    assert reg.counter("online.updates") == 1
    assert reg.counter("online.delta_nnz") == st2.stats["delta_nnz"]
    assert reg.counter("online.guard_trips") == 0


def test_online_update_refuses_poison_before_touching_state(states):
    _, st, jcfg = states
    M2, N2 = st.M + 5, st.N + 3
    nr, nc, nv = _delta(st, M2, N2, n=200)
    nv = nv.copy()
    nv[3] = np.nan
    reg_S, reg_U = st.S.clone(), st.params.U.clone()
    with pytest.raises(PoisonBatchError, match="non-finite"):
        online.online_update(st, nr, nc, nv, _cfg(jcfg), Hyper(),
                             prng.PRNGKey(1), M_new=M2, N_new=N2, K=8)
    with pytest.raises(PoisonBatchError, match="shrink"):
        online.online_update(st, nr, nc, nv, _cfg(jcfg), Hyper(),
                             prng.PRNGKey(1), M_new=st.M - 1, N_new=N2, K=8)
    with pytest.raises(ValueError, match="hash_key"):
        online.online_update(dataclasses.replace(st, hash_key=None), nr, nc,
                             nv, _cfg(jcfg), Hyper(), prng.PRNGKey(1),
                             M_new=M2, N_new=N2, K=8)
    assert torch.equal(st.S, reg_S) and torch.equal(st.params.U, reg_U)


def test_online_update_guard_trips_on_blown_up_rates(states):
    from repro_torch import obs
    _, st, jcfg = states
    M2, N2 = st.M + 20, st.N + 6
    hot = Hyper(**{f.name: getattr(Hyper(), f.name) * 1e4
                   for f in dataclasses.fields(Hyper) if f.name[:2] == "a_"})
    reg = obs.Registry(enabled=True)
    with pytest.raises(DivergenceError, match="rolled back"):
        online.online_update(st, *_delta(st, M2, N2), _cfg(jcfg), hot,
                             prng.PRNGKey(2), M_new=M2, N_new=N2, K=8,
                             epochs=2, registry=reg)
    assert reg.counter("online.guard_trips") == 1
    assert reg.counter("online.updates") == 0


# ---------------------------------------------------------- micro-epoch

def test_micro_schedule_and_epoch_match_jax(states):
    jst, tst, jcfg = states
    M2, N2 = jst.M + 40, jst.N + 12
    jst2, tst2 = _both_updates(jst, tst, jcfg, _delta(jst, M2, N2), M2, N2)
    # both micro-epochs from the JAX package's updated state
    tst2 = dataclasses.replace(
        _port_state(jst2, np.asarray(jst2.hash_key)), stats=tst2.stats)
    js = jonline.build_micro_schedule(jst2.sp, jst2.JK, batch=256)
    ts = online.build_micro_schedule(tst2.sp, tst2.JK, batch=256)
    for f in dataclasses.fields(ts.sched):
        a, b = getattr(ts.sched, f.name), getattr(js.sched, f.name)
        if isinstance(a, tuple) and a and isinstance(a[0], np.ndarray):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, np.asarray(y), f.name)
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          f.name)
    want = jonline.micro_epoch(jst2, JHyper(), jax.random.PRNGKey(4),
                               epoch=1, sched=js)
    before = tst2.params.U.clone()
    got = online.micro_epoch(tst2, Hyper(), convert.key_from_numpy(
        jax.random.PRNGKey(4)), epoch=1, sched=ts)
    _assert_params_close(got.params, want.params, PATH_TOL)
    assert torch.equal(tst2.params.U, before)          # input untouched
    assert got.S is tst2.S and got.JK is tst2.JK and got.sp is tst2.sp
    assert "micro_seconds" in got.stats


def test_micro_epoch_builds_its_schedule_when_stale(states):
    from repro_torch import obs
    _, st, _ = states
    reg = obs.Registry(enabled=True)
    got = online.micro_epoch(st, Hyper(), prng.PRNGKey(4), batch=128,
                             registry=reg)
    assert len(reg.span_durations("online.micro.schedule")) == 1
    assert reg.counter("online.micro_epochs") == 1
    assert not torch.equal(got.params.U, st.params.U)


def test_convert_carries_an_online_state(states):
    jst, tst, _ = states
    np.testing.assert_array_equal(_np(tst.S), np.asarray(jst.S))
    np.testing.assert_array_equal(_np(tst.JK), np.asarray(jst.JK))
    np.testing.assert_array_equal(_np(tst.sp.rows), np.asarray(jst.sp.rows))
    np.testing.assert_array_equal(_np(tst.hash_key),
                                  np.asarray(jst.hash_key).astype(np.int64))
    assert (tst.M, tst.N, tst.sp.shape) == (jst.M, jst.N, jst.sp.shape)


# ------------------------------------------------------------- guard

def _blown(p, M_old, N_old, f, value):
    a = np.array(getattr(p, f), np.float32)
    a[M_old if f in ("U", "b") else N_old:] = value
    return a


@pytest.mark.parametrize("case", ["healthy", "nan_U", "huge_V", "inf_bh",
                                  "huge_W_and_nan_b"])
def test_check_divergence_matches_jax(states, case):
    jst, _, _ = states
    M2, N2 = jst.M + 40, jst.N + 12
    jp = jonline.grow_params(jst.params, M2, N2, jax.random.PRNGKey(9))
    arrays = {f: np.array(getattr(jp, f)) for f in FIELDS + ("mu",)}
    edits = dict(healthy={}, nan_U={"U": np.nan}, huge_V={"V": 500.0},
                 inf_bh={"bh": np.inf}, huge_W_and_nan_b={"W": 7.5,
                                                          "b": np.nan})[case]
    for f, v in edits.items():
        arrays[f] = _blown(jp, jst.M, jst.N, f, v)
    jnew = jmodel.Params(**{f: jnp.asarray(a) for f, a in arrays.items()})
    tnew = convert.params_from_numpy(**arrays, device="cpu")
    told = convert.params_from_numpy(
        **{f: np.asarray(getattr(jst.params, f)) for f in FIELDS + ("mu",)},
        device="cpu")
    want = jguard.check_divergence(jnew, jst.params, M_old=jst.M,
                                   N_old=jst.N)
    got = check_divergence(tnew, told, M_old=jst.M, N_old=jst.N)
    assert got == want
    assert bool(got) == (case != "healthy")


# ---------------------------------------------------------- validate

POISON_IDS = [(np.array([1.0, np.nan]), "NaN"), (np.array([3, -1]), "negative"),
              (np.array([1 << 30]), "2\\^30"), (np.array([1.5]), "fractional"),
              (np.array(["a"]), "integer dtype")]


@pytest.mark.parametrize("ids,match", POISON_IDS)
@pytest.mark.parametrize("as_tensor", [False, True])
def test_check_ids_refuses_like_jax(ids, match, as_tensor):
    with pytest.raises(jvalidate.PoisonBatchError, match=match):
        jvalidate.check_ids(ids, what="t")
    x = (torch.tensor(ids) if as_tensor and ids.dtype.kind != "U" else ids)
    with pytest.raises(PoisonBatchError, match=match):
        check_ids(x, what="t")


def test_check_ids_upper_and_passthrough():
    with pytest.raises(PoisonBatchError, match="out of range"):
        check_ids(np.array([5]), what="t", upper=5)
    assert check_ids(np.array([0, 4], np.int32), what="t").dtype == np.int32
    assert check_ids(torch.tensor([0, 4], dtype=torch.int32),
                     what="t").dtype == np.int32


DELTA_CASES = [
    (dict(vals=np.array([1.0, np.inf], np.float32)), "non-finite"),
    (dict(M_new=4), "shrink"),
    (dict(cols=np.array([1], np.int32)), "equal-length"),
    (dict(rows=np.zeros(0, np.int32), cols=np.zeros(0, np.int32),
          vals=np.ones(0, np.float32)), "empty"),
    (dict(rows=np.array([1, 10], np.int32)), "out of range"),
    (dict(vals=np.array(["a", "b"])), "non-numeric"),
]


@pytest.mark.parametrize("edit,match", DELTA_CASES)
def test_check_delta_refuses_like_jax(edit, match):
    base = dict(rows=np.array([1, 2], np.int32),
                cols=np.array([1, 2], np.int32),
                vals=np.ones(2, np.float32), M_new=10, N_new=10, M_old=8,
                N_old=8)
    kw = dict(base, **edit)
    args = (kw.pop("rows"), kw.pop("cols"), kw.pop("vals"))
    with pytest.raises(jvalidate.PoisonBatchError, match=match):
        jvalidate.check_delta(*args, **kw)
    with pytest.raises(PoisonBatchError, match=match):
        check_delta(*args, **kw)
    with pytest.raises(PoisonBatchError, match=match):
        check_delta(*(torch.tensor(a) if a.dtype.kind != "U" else a
                      for a in args), **kw)


def test_check_delta_accepts_a_clean_batch():
    r = np.array([1, 9], np.int32)
    check_delta(r, r, np.ones(2, np.float32), M_new=10, N_new=10, M_old=8,
                N_old=8)
    check_delta(torch.tensor(r), r, torch.ones(2), M_new=10, N_new=10,
                M_old=8, N_old=8)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_check_accumulators_names_poisoned_column(as_tensor):
    S = np.zeros((2, 6, 4), np.float32)
    S[:, 0, :] = np.nan
    wrap = torch.tensor if as_tensor else (lambda a: a)
    check_accumulators(wrap(S), N_old=5)       # old columns: not our problem
    jvalidate.check_accumulators(S, N_old=5)
    S[0, 4, 1] = np.nan
    for fn, err in ((check_accumulators, PoisonBatchError),
                    (jvalidate.check_accumulators,
                     jvalidate.PoisonBatchError)):
        with pytest.raises(err, match="column 4"):
            fn(wrap(S) if fn is check_accumulators else S, N_old=3)


INGEST_CASES = [
    (lambda s, i: (s.astype(np.float32), i), "float dtype"),
    (lambda s, i: (s.astype(np.int64), i), "int32"),
    (lambda s, i: (s[:3], i), "shape"),
    (lambda s, i: (s, i[:-1]), "mismatch"),
    (lambda s, i: (s, np.concatenate([i[:-1], i[:1]])), "duplicate"),
    (lambda s, i: (s, i - 100), "negative"),
]


@pytest.mark.parametrize("k", range(len(INGEST_CASES)))
def test_check_ingest_batch_refuses_like_jax(k):
    edit, match = INGEST_CASES[k]
    sigs = np.arange(24, dtype=np.int32).reshape(4, 6)
    ids = np.arange(50, 56, dtype=np.int32)
    s, i = edit(sigs, ids)
    with pytest.raises(jvalidate.PoisonBatchError, match=match):
        jvalidate.check_ingest_batch(s, i, q=4)
    with pytest.raises(PoisonBatchError, match=match):
        check_ingest_batch(s, i, q=4)
    with pytest.raises(PoisonBatchError, match=match):
        check_ingest_batch(torch.tensor(s), torch.tensor(i), q=4)
    check_ingest_batch(torch.tensor(sigs), torch.tensor(ids), q=4)


@pytest.fixture(scope="module")
def small_index():
    """`tests/test_resil.py::small_index`, through both packages."""
    from repro.serve import build_index as jbuild
    rng = np.random.default_rng(0)
    rows = np.repeat(np.arange(60), 4).astype(np.int32)
    cols = rng.integers(0, 40, 240).astype(np.int32)
    vals = rng.integers(1, 6, 240).astype(np.float32)
    sp = jsparse.from_coo(rows, cols, vals, (60, 40))
    sigs = np.asarray(jsim.encode(sp, jsim.SimLSHConfig(G=8, p=2, q=8),
                                  jax.random.PRNGKey(0)))
    return (jbuild(jnp.asarray(sigs), tail_cap=8),
            build_index(torch.tensor(sigs), tail_cap=8, device="cpu"))


def _corrupt(index, kind, jax_side):
    if kind == "permutation":
        a = np.array(index.sorted_ids)
        a[0, 0] = a[0, 1]
        name = "sorted_ids"
    elif kind == "bucket":
        a = np.array(index.bucket_hi)
        a[2] = 0
        name = "bucket_hi"
    else:
        a = np.ascontiguousarray(np.array(index.sorted_sigs)[:, ::-1])
        name = "sorted_sigs"
    bad = dataclasses.replace(index, **{
        name: jnp.asarray(a) if jax_side else torch.tensor(a)})
    if jax_side:
        object.__setattr__(bad, "_tail_host", 0)
    return bad


@pytest.mark.parametrize("kind,word", [("permutation", "permutation"),
                                       ("bucket", "bucket"),
                                       ("ascending", "ascending")])
def test_validate_index_catches_the_same_corruptions(small_index, kind, word):
    jidx, tidx = small_index
    assert validate_index(tidx) == jvalidate.validate_index(jidx) == []
    want = jvalidate.validate_index(_corrupt(jidx, kind, True))
    got = validate_index(_corrupt(tidx, kind, False))
    assert got == want and any(word in p for p in got)


def test_validate_index_passes_inserts_and_refuses_bad_dtypes(small_index):
    _, tidx = small_index
    sigs = torch.gather(tidx.sorted_sigs, 1, tidx.slot_of.long())
    grown = insert(tidx, sigs[:, :3], torch.arange(40, 43))
    assert validate_index(grown) == []
    assert validate_index(rebuild(grown, torch.cat([sigs, sigs[:, :3]],
                                                   dim=1))) == []
    bad = dataclasses.replace(tidx, bucket_lo=tidx.bucket_lo.long())
    assert validate_index(bad) == ["bucket_lo: dtype int64 != int32"]


# ------------------------------------------------------- fit API gaps

@pytest.fixture(scope="module")
def fit_data():
    spec = dataclasses.replace(jsyn.MOVIELENS_LIKE, M=120, N=50, nnz=1500)
    rows, cols, vals, _ = jsyn.generate(spec, seed=0)
    tr, te = sparse.train_test_split(np.random.default_rng(0), rows, cols,
                                     vals)
    return spec, tr, te


def _fit(fit_data, **kw):
    spec, tr, te = fit_data
    cfg = trainer.FitConfig(F=8, K=4, epochs=1, cf_batch=32,
                            lsh=simlsh.SimLSHConfig(G=8, p=1, q=4),
                            use_kernels=True, **kw)
    return trainer.fit(tr, te, (spec.M, spec.N), cfg, device="cpu")


def test_fit_kernel_impl_ref_equals_auto_on_cpu(fit_data):
    """The JAX package's ``kernel_impl="ref"`` is accepted and, on the
    CPU, equal to ``"auto"`` (both the plain fused step)."""
    a = _fit(fit_data, kernel_impl="auto")
    r = _fit(fit_data, kernel_impl="ref")
    assert a.history[-1][2] == r.history[-1][2]
    assert torch.equal(a.params.U, r.params.U)
    with pytest.raises(ValueError, match="impl='cuda' needs"):
        _fit(fit_data, kernel_impl="cuda")


def test_fit_kernel_impl_refuses_pallas():
    with pytest.raises(ValueError, match="cuda"):
        trainer.FitConfig(kernel_impl="pallas")


def test_fit_result_compile_seconds_is_zero_on_cpu(fit_data):
    res = _fit(fit_data)
    assert res.compile_seconds == 0.0
    assert res.registry.span_durations("train.compile") == []


def test_fit_state_feeds_online_update(fit_data):
    """`fit`'s accumulators and hash key are Alg. 4's cache: an online
    update of the fitted state re-signs old columns as a fresh encode of
    the merged matrix does."""
    spec, tr, _ = fit_data
    res = _fit(fit_data)
    sp = sparse.from_coo(*tr, (spec.M, spec.N), device="cpu")
    st = online.OnlineState(params=res.params, S=res.S, JK=res.JK, sp=sp,
                            M=spec.M, N=spec.N, hash_key=res.hash_key)
    M2, N2 = spec.M + 10, spec.N + 4
    nr, nc, nv = _delta(st, M2, N2, n=300)
    lsh = simlsh.SimLSHConfig(G=8, p=1, q=4)
    st2 = online.online_update(st, nr, nc, nv, lsh, Hyper(), prng.PRNGKey(3),
                               M_new=M2, N_new=N2, K=4, epochs=1)
    sigs_fresh, S_fresh = simlsh.encode(st2.sp, lsh, res.hash_key,
                                        return_accumulators=True)
    assert_signature_rule(st2.S, simlsh.pack_bits(st2.S >= 0), S_fresh,
                          sigs_fresh, lsh.sig_bits)


def _big_bucket_indexes():
    """4-bit bands over 200 items (~12 items a bucket), in both packages."""
    from repro.serve import build_index as jbuild
    sigs = np.random.default_rng(0).integers(0, 16, (3, 200)).astype(
        np.int32)
    return (jbuild(jnp.asarray(sigs), tail_cap=4),
            build_index(torch.tensor(sigs), tail_cap=4, device="cpu"))


def _largest_bucket(tidx):
    return int((tidx.bucket_hi - tidx.bucket_lo).max())


def test_validate_index_recall_smoke_on_big_buckets_matches_jax():
    """A declared divergence: the JAX package's recall smoke looks for
    each probe item among the first 4 slots of its bucket, so it refuses
    this correct index, whose buckets hold ~12 items; the port probes
    each item in the window centred on its own slot (`lookup_items`) and
    accepts it, at any probe count."""
    jidx, tidx = _big_bucket_indexes()
    assert _largest_bucket(tidx) > 4
    want = jvalidate.validate_index(jidx)
    assert want and "recall smoke" in want[0]
    assert validate_index(tidx) == []
    assert validate_index(tidx, probe=200, seed=3) == []
    assert validate_index(tidx, probe=0) == jvalidate.validate_index(
        jidx, probe=0) == []


def test_validate_index_recall_smoke_keeps_the_jax_verdicts_on_small_buckets(
        small_index):
    """On buckets of at most 4 items the two smokes see the same windows:
    the verdicts equal the reference's, for every probe draw."""
    jidx, tidx = small_index
    assert _largest_bucket(tidx) <= 4
    for probe, seed in ((64, 0), (40, 1), (7, 2)):
        assert validate_index(tidx, probe=probe, seed=seed) == \
            jvalidate.validate_index(jidx, probe=probe, seed=seed) == []


def _corrupt_probe(index, kind, jax_side):
    """slot_of not the inverse of sorted_ids (two items of band 0 swap
    slots), sorted_ids not a permutation, or the first probe item's id
    gone from band 1 (its slot holds another id)."""
    so, si = np.array(index.slot_of), np.array(index.sorted_ids)
    N = si.shape[1]
    if kind == "inverse":
        a, b = si[0, 0], si[0, N - 1]
        so[0, a], so[0, b] = so[0, b], so[0, a]
        edit = dict(slot_of=so)
    elif kind == "permutation":
        si[0, 0] = si[0, 1]
        edit = dict(sorted_ids=si)
    else:
        first = np.random.default_rng(0).choice(N, size=min(64, N),
                                                replace=False)[0]
        s = so[1, first]
        si[1, s] = si[1, s - 1 if s else s + 1]
        edit = dict(sorted_ids=si)
    bad = dataclasses.replace(index, **{
        k: jnp.asarray(v) if jax_side else torch.tensor(v)
        for k, v in edit.items()})
    if jax_side:
        object.__setattr__(bad, "_tail_host", 0)
    return bad


@pytest.mark.parametrize("size", ["small", "big"])
@pytest.mark.parametrize("kind,word", [("inverse", "inverse"),
                                       ("permutation", "permutation"),
                                       ("probe", "permutation")])
def test_validate_index_still_refuses_corrupt_indexes(small_index, size,
                                                      kind, word):
    """Each corruption is refused at both bucket sizes, with the
    reference's own problem list."""
    jidx, tidx = small_index if size == "small" else _big_bucket_indexes()
    got = validate_index(_corrupt_probe(tidx, kind, False))
    want = jvalidate.validate_index(_corrupt_probe(jidx, kind, True))
    assert got and any(word in p for p in got)
    assert got == want