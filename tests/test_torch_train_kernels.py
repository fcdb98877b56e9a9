"""Port vs JAX package: the fused SGD steps of `kernels/mf_sgd` and the
packed/unpacked steps of `core/sgd.py`.

* The plain tile versions (`mf_sgd_step_ref`, `culsh_sgd_step_ref`)
  against the JAX package's refs and its Pallas kernels in interpret
  mode, within rtol 1e-5 / atol 1e-6 (the tolerance of
  `tests/test_kernels.py`), at batch widths 7, 24, 96 and 250, with the
  BCE loss both ways; invalid rows come back unchanged.  The fused
  entries (`kernel.culsh_sgd_batch`, `kernel.mf_sgd_batch`, which on the
  card gather, step and write the planes in one launch) run their plain
  versions on CPU tensors: planes built around the same tiles come back
  with the same rows, and no kernel launches.
* The fused entries (`kernel.culsh_sgd_batch`, `kernel.mf_sgd_batch`)
  and their plain versions (`ref.apply_culsh_sgd_ref`,
  `ref.apply_mf_sgd_ref`: gather → step → delta scatter) against the
  port's packed steps and the JAX package's `apply_*` (ref and Pallas
  interpret), including a batch whose slots' neighbours are the other
  live slots' columns (the stale-b̂ hazard) with non-zero W.
* One epoch's conflict-free tiers through the fused entry
  (`use_kernels`) against the packed steps, and the tiers and the
  leftover batches run as separate `sgd._cf_scan` calls against the
  whole epoch; a plain-MF epoch's tiers through `kernel.mf_sgd_tier`
  against `mf_step_packed`, batch by batch and as a whole epoch.
* The port's packed steps bit-identical to its unpacked steps, on
  conflict-free, collision-scaled and precomputed-scale batches (the
  invariant of `tests/test_schedule.py::test_packed_step_bit_identical`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import model as jmodel
from repro.core import sgd as jsgd
from repro.data import sparse as jsparse
from repro.kernels.mf_sgd import ops as jops
from repro.kernels.mf_sgd.kernel import culsh_sgd_step as jculsh_kernel
from repro.kernels.mf_sgd.kernel import mf_sgd_step as jmf_kernel
from repro.kernels.mf_sgd.ref import culsh_sgd_step_ref as jculsh_ref
from repro.kernels.mf_sgd.ref import mf_sgd_step_ref as jmf_ref
from repro_torch import prng
from repro_torch.core import model, sgd
from repro_torch.data import sparse, synthetic
from repro_torch.kernels import pick
from repro_torch.kernels.mf_sgd import kernel, ops
from repro_torch.kernels.mf_sgd.ref import (apply_culsh_sgd_ref,
                                            apply_mf_sgd_ref,
                                            culsh_sgd_step_ref,
                                            mf_sgd_step_ref)

TOL = dict(rtol=1e-5, atol=1e-6)
WIDTHS = [7, 24, 96, 250]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def culsh_numpy(B, F, K, rng):
    """Packed-plane operands as numpy (`tests/test_kernels.py::
    _culsh_args`): row, col, rnb, bh_nb, expl, r, valid, hp[13]."""
    a = lambda *s: rng.normal(size=s).astype(np.float32)
    expl = rng.integers(0, 2, (B, K)).astype(np.float32)
    valid = rng.integers(0, 2, B).astype(np.float32)
    hp = np.concatenate([np.abs(a(12)) * 0.05, a(1) * 0.1]).astype(
        np.float32)
    return [a(B, F + 1), a(B, F + 2 * K + 1), a(B, K), a(B, K), expl, a(B),
            valid, hp]


@pytest.mark.parametrize("bce", [False, True])
@pytest.mark.parametrize("B", WIDTHS)
def test_culsh_step_plain_matches_jax_ref_and_pallas(B, bce):
    F, K = (128, 64) if B == 7 else (8, 4)
    args = culsh_numpy(B, F, K, np.random.default_rng(B))
    got = culsh_sgd_step_ref(*map(torch.tensor, args), bce=bce)
    jargs = [jnp.asarray(a) for a in args]
    for want in (jculsh_ref(*jargs, bce=bce),
                 jculsh_kernel(*jargs, tile_b=64, interpret=True, bce=bce)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)
    # the fused entry on planes built around the tiles: row s of each
    # plane is tile row s, and slot s's neighbours are extra col rows that
    # hold bh_nb; on CPU tensors it is the plain version, no launch
    row, col, rnb, bh_nb, expl, r, valid, hp = map(torch.tensor, args)
    extra = torch.zeros((B * K, col.shape[1]))
    extra[:, -1] = bh_nb.reshape(-1)
    pp = model.PackedParams(row=row.clone(), col=torch.cat([col, extra]),
                            mu=hp[12], F=F, K=K)
    ids = torch.arange(B, dtype=torch.int32)
    nb = (B + torch.arange(B * K, dtype=torch.int32)).reshape(B, K)
    bt = model.Batch(ids, ids, r, nb, rnb, expl, 1.0 - expl, valid)
    before = kernel.CULSH_LAUNCHES
    kernel.culsh_sgd_batch(pp, bt, hp, bce=bce)
    assert kernel.CULSH_LAUNCHES == before
    np.testing.assert_allclose(_np(pp.row), _np(got[0]), **TOL)
    np.testing.assert_allclose(_np(pp.col[:B]), _np(got[1]), **TOL)
    assert torch.equal(pp.col[B:], extra)
    off = args[6] == 0
    np.testing.assert_array_equal(_np(got[0])[off], args[0][off])
    np.testing.assert_array_equal(_np(got[1])[off], args[1][off])
    np.testing.assert_array_equal(_np(pp.row)[off], args[0][off])
    np.testing.assert_array_equal(_np(pp.col[:B])[off], args[1][off])


@pytest.mark.parametrize("bce", [False, True])
@pytest.mark.parametrize("B", WIDTHS)
def test_mf_step_plain_matches_jax_ref_and_pallas(B, bce):
    rng = np.random.default_rng(B + 1)
    F = 16
    u, v = (rng.normal(size=(B, F)).astype(np.float32) for _ in range(2))
    r = rng.normal(size=B).astype(np.float32)
    valid = rng.integers(0, 2, B).astype(np.float32)
    hp = np.array([0.02, 0.03, 0.01, 0.02], np.float32)
    got = mf_sgd_step_ref(*map(torch.tensor, (u, v, r, valid, hp)), bce=bce)
    jargs = [jnp.asarray(a) for a in (u, v, r, valid)]
    for want in (jmf_ref(*jargs, *hp, bce=bce),
                 jmf_kernel(*jargs, *map(jnp.float32, hp), tile_b=64,
                            interpret=True, bce=bce)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)
    off = valid == 0
    np.testing.assert_array_equal(_np(got[0])[off], u[off])
    np.testing.assert_array_equal(_np(got[2])[off], 0.0)
    # the fused entry on planes built around the tiles (row s of each plane
    # is tile row s; the col plane carries K = 2 neighbour columns, so its
    # rows are wider than F + 1): on CPU tensors it is the plain version,
    # no launch, and only the first F columns change
    K = 2
    row = torch.cat([torch.tensor(u), torch.tensor(r)[:, None]], dim=1)
    col = torch.cat([torch.tensor(v), torch.tensor(
        rng.normal(size=(B, 2 * K + 1)).astype(np.float32))], dim=1)
    pp = model.PackedParams(row=row.clone(), col=col.clone(),
                            mu=torch.tensor(0.0), F=F, K=K)
    ids = torch.arange(B, dtype=torch.int32)
    zk = torch.zeros((B, K))
    bt = model.Batch(ids, ids, torch.tensor(r), torch.zeros(
        (B, K), dtype=torch.int32), zk, zk, 1.0 - zk, torch.tensor(valid))
    before = kernel.MF_LAUNCHES
    kernel.mf_sgd_batch(pp, bt, torch.tensor(hp), bce=bce)
    assert kernel.MF_LAUNCHES == before
    np.testing.assert_allclose(_np(pp.row[:, :F]), _np(got[0]), **TOL)
    np.testing.assert_allclose(_np(pp.col[:, :F]), _np(got[1]), **TOL)
    assert torch.equal(pp.row[:, F:], row[:, F:])
    assert torch.equal(pp.col[:, F:], col[:, F:])
    np.testing.assert_array_equal(_np(pp.row)[off], _np(row)[off])
    np.testing.assert_array_equal(_np(pp.col)[off], _np(col)[off])


# ----------------------------------------------------------- on real batches

@pytest.fixture(scope="module")
def tiny():
    spec = dataclasses.replace(synthetic.MOVIELENS_LIKE, M=300, N=100,
                               nnz=4000)
    rows, cols, vals, _ = synthetic.generate(spec, seed=0)
    return (sparse.from_coo(rows, cols, vals, (spec.M, spec.N),
                            device="cpu"),
            jsparse.from_coo(rows, cols, vals, (spec.M, spec.N)))


def _cf_batch(sp, K, B, seed):
    """A batch with each row/col at most once (`tests/test_schedule.py::
    _conflict_free_batch`) → (JK, idx) as numpy."""
    rng = np.random.default_rng(seed)
    rows, cols = _np(sp.rows), _np(sp.cols)
    take, ri, ci = [], set(), set()
    for t in rng.permutation(sp.nnz):
        if rows[t] not in ri and cols[t] not in ci:
            take.append(t)
            ri.add(rows[t])
            ci.add(cols[t])
        if len(take) == B:
            break
    JK = rng.integers(0, sp.N, (sp.N, K)).astype(np.int32)
    return JK, np.asarray(take, np.int32)


def _both(tsp, jsp, JK, idx, valid, seed, F=8, K=4):
    bt = model.assemble(tsp, torch.tensor(JK), torch.tensor(idx),
                        torch.tensor(valid))
    jbt = jmodel.assemble(jsp, jnp.asarray(JK), jnp.asarray(idx),
                          jnp.asarray(valid))
    p = model.init_from_data(prng.PRNGKey(seed), tsp, F, K)
    p = dataclasses.replace(p, W=torch.randn(tsp.N, K) * 0.1,
                            C=torch.randn(tsp.N, K) * 0.1)
    jp = jmodel.Params(**{f.name: jnp.asarray(_np(getattr(p, f.name)))
                          for f in dataclasses.fields(p)})
    return bt, jbt, p, jp


def _copy(pp):
    return dataclasses.replace(pp, row=pp.row.clone(), col=pp.col.clone())


@pytest.mark.parametrize("B", WIDTHS)
def test_apply_matches_packed_step_and_jax(tiny, B):
    tsp, jsp = tiny
    JK, idx = _cf_batch(tsp, 4, B, seed=B)
    valid = np.ones(len(idx), bool)
    valid[-2:] = False
    bt, jbt, p, jp = _both(tsp, jsp, JK, idx, valid, seed=B)
    hp, d = sgd.Hyper(), sgd.lr_decay(sgd.Hyper(), 2)
    pp = model.pack_params(p)
    want = sgd.culsh_step_packed(_copy(pp), bt, hp, d, conflict_free=True)
    got = apply_culsh_sgd_ref(_copy(pp), bt, ops.culsh_hyper(hp, d, pp.mu))
    jgot = jops.apply_culsh_sgd(jmodel.pack_params(jp), jbt, jsgd.Hyper(),
                                jnp.float32(d), impl="ref")
    for a, b in ((got.row, want.row), (got.col, want.col)):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)
    np.testing.assert_allclose(_np(got.row), np.asarray(jgot.row), **TOL)
    np.testing.assert_allclose(_np(got.col), np.asarray(jgot.col), **TOL)
    want_mf = sgd.mf_step_packed(_copy(pp), bt, hp, d, conflict_free=True)
    hmf = ops.mf_hyper(hp, d, "cpu")
    before = kernel.MF_LAUNCHES
    got_mf = kernel.mf_sgd_batch(_copy(pp), bt, hmf)
    assert kernel.MF_LAUNCHES == before
    plain_mf = apply_mf_sgd_ref(_copy(pp), bt, hmf)
    assert torch.equal(got_mf.row, plain_mf.row)
    assert torch.equal(got_mf.col, plain_mf.col)
    np.testing.assert_allclose(_np(got_mf.row), _np(want_mf.row), **TOL)
    np.testing.assert_allclose(_np(got_mf.col), _np(want_mf.col), **TOL)
    for impl in ("ref", "pallas"):
        jmf = jops.apply_mf_sgd(jmodel.pack_params(jp), jbt, jsgd.Hyper(),
                                jnp.float32(d), impl=impl, tile_b=64,
                                interpret=True)
        np.testing.assert_allclose(_np(got_mf.row), np.asarray(jmf.row),
                                   **TOL)
        np.testing.assert_allclose(_np(got_mf.col), np.asarray(jmf.col),
                                   **TOL)


def _jax_batch(bt):
    return jmodel.Batch(*(jnp.asarray(_np(getattr(bt, f.name)))
                          for f in dataclasses.fields(bt)))


def _fused_vs_references(pp, bt, jp, bce, **rates):
    """The fused entry's CPU path against `culsh_step_packed` and the JAX
    package's `apply_culsh_sgd` (ref and Pallas interpret), with the
    learning ``rates`` of `Hyper` changed → its planes."""
    hp, d = sgd.Hyper(**rates), sgd.lr_decay(sgd.Hyper(), 2)
    before = kernel.CULSH_LAUNCHES
    got = kernel.culsh_sgd_batch(_copy(pp), bt, ops.culsh_hyper(hp, d, pp.mu),
                                 bce=bce)
    assert kernel.CULSH_LAUNCHES == before, "a CPU tensor launched a kernel"
    want = sgd.culsh_step_packed(_copy(pp), bt, hp, d, bce=bce,
                                 conflict_free=True)
    np.testing.assert_allclose(_np(got.row), _np(want.row), **TOL)
    np.testing.assert_allclose(_np(got.col), _np(want.col), **TOL)
    for impl in ("ref", "pallas"):
        jgot = jops.apply_culsh_sgd(jmodel.pack_params(jp), _jax_batch(bt),
                                    jsgd.Hyper(**rates), jnp.float32(d),
                                    impl=impl,
                                    tile_b=64, interpret=True, bce=bce)
        np.testing.assert_allclose(_np(got.row), np.asarray(jgot.row), **TOL)
        np.testing.assert_allclose(_np(got.col), np.asarray(jgot.col), **TOL)
    return got


@pytest.mark.parametrize("bce", [False, True])
@pytest.mark.parametrize("B", WIDTHS)
def test_fused_entry_matches_jax_apply_and_packed_step(tiny, B, bce):
    tsp, jsp = tiny
    JK, idx = _cf_batch(tsp, 4, B, seed=B + 1)
    valid = np.ones(len(idx), bool)
    valid[::5] = False
    bt, _, p, jp = _both(tsp, jsp, JK, idx, valid, seed=B)
    _fused_vs_references(model.pack_params(p), bt, jp, bce)


def test_fused_entry_reads_neighbour_baselines_before_any_write(tiny):
    """Every slot's explicit neighbours are other live slots' columns, and
    W is non-zero: a step that read a b̂ another slot had already updated
    would move W, C and the prediction.  Applying the slots one at a time
    — the stale reading — falls outside the tolerance (b̂ and W at larger
    learning rates make the gap wide), so the comparison can tell."""
    tsp, jsp = tiny
    B, K = 24, 4
    JK, idx = _cf_batch(tsp, K, B, seed=5)
    js = _np(tsp.cols)[idx]
    for s in range(B):                        # J^K[j_s] = the next slots' j
        JK[js[s]] = js[(s + 1 + np.arange(K)) % B]
    bt, _, p, jp = _both(tsp, jsp, JK, idx, np.ones(B, bool), seed=6)
    rng = np.random.default_rng(5)
    bt = dataclasses.replace(
        bt, expl=torch.ones((B, K)), impl=torch.zeros((B, K)),
        rnb=torch.tensor(rng.integers(1, 6, (B, K)), dtype=torch.float32))
    p = dataclasses.replace(
        p, bh=torch.tensor(rng.normal(size=tsp.N), dtype=torch.float32))
    jp = jmodel.Params(**{f.name: jnp.asarray(_np(getattr(p, f.name)))
                          for f in dataclasses.fields(p)})
    pp = model.pack_params(p)
    assert float(pp.col[:, 8:12].abs().min()) > 0     # W (F = 8, K = 4)
    rates = dict(a_bh=0.3, a_w=0.05)
    got = _fused_vs_references(pp, bt, jp, False, **rates)
    hpv = ops.culsh_hyper(sgd.Hyper(**rates), sgd.lr_decay(sgd.Hyper(), 2),
                          pp.mu)
    stale = _copy(pp)
    for s in range(B):
        one = model.Batch(*(getattr(bt, f.name)[s:s + 1]
                            for f in dataclasses.fields(bt)))
        kernel.culsh_sgd_batch(stale, one, hpv)
    assert np.abs(_np(stale.col) - _np(got.col)).max() > 1e-3


def test_epoch_kernel_path_equals_packed_steps_and_parts_make_the_epoch(tiny):
    """One scheduled epoch: the conflict-free tiers through the fused
    entry (``use_kernels``) against the packed steps; and the tiers and
    the leftover batches, each run by its own `sgd._cf_scan` call in the
    epoch's order, equal the whole epoch."""
    tsp, _ = tiny
    K, F = 4, 8
    rng = np.random.default_rng(3)
    JK = torch.tensor(rng.integers(0, tsp.N, (tsp.N, K)), dtype=torch.int32)
    sched = sparse.conflict_free_schedule(
        _np(tsp.rows), _np(tsp.cols), batch=64, tiers=3, tier_shrink=0.5,
        M=tsp.M, N=tsp.N, seed=0)
    assert sched.stats()["nb_cf"] and sched.lo_starts.shape[0]
    sd = model.build_scheduled_data(tsp, JK, sched)
    p = model.init_from_data(prng.PRNGKey(1), tsp, F, K)
    p = dataclasses.replace(p, W=torch.randn(tsp.N, K) * 0.1,
                            C=torch.randn(tsp.N, K) * 0.1)
    pp = model.pack_params(p)
    key, hp = prng.PRNGKey(7), sgd.Hyper()
    run = lambda q, **kw: sgd.train_epoch_scheduled(q, sd, sched, key, 1, hp,
                                                    **kw)
    before = kernel.CULSH_LAUNCHES
    fused = run(_copy(pp), use_kernels=True)
    assert kernel.CULSH_LAUNCHES == before
    packed = run(_copy(pp), use_kernels=False)
    np.testing.assert_allclose(_np(fused.row), _np(packed.row), **TOL)
    np.testing.assert_allclose(_np(fused.col), _np(packed.col), **TOL)
    assert np.abs(_np(fused.col) - _np(pp.col)).max() > 1e-3
    halves, decay = _copy(pp), sgd.lr_decay(hp, 1)
    hpv = ops.culsh_hyper(hp, decay, pp.mu)
    keys = prng.split(key, 2 + len(sched.tier_starts))
    scan = lambda starts, valid, order, **kw: sgd._cf_scan(
        halves, sd, starts[order], torch.as_tensor(valid[order]).float(), hp,
        decay, hpv, mf_only=False, bce=False, **kw)
    for t, (starts, valid) in enumerate(zip(sched.tier_starts,
                                            sched.tier_valid)):
        if len(starts):
            scan(starts, valid,
                 prng.permutation(keys[2 + t], len(starts)).numpy(),
                 width=sched.widths[t], conflict_free=True, use_kernels=True)
    order = prng.permutation(keys[1], len(sched.lo_starts)).numpy()
    scan(sched.lo_starts, sched.lo_valid, order, width=sched.widths[0],
         conflict_free=False, use_kernels=False,
         scales=(torch.as_tensor(sched.lo_scale_i[order]),
                 torch.as_tensor(sched.lo_scale_j[order])))
    assert torch.equal(halves.row, fused.row)
    assert torch.equal(halves.col, fused.col)



def test_mf_epoch_tiers_through_mf_sgd_tier_equal_packed_steps(tiny):
    """A plain-MF (``mf_only``) epoch's conflict-free tiers: each tier's
    step function from `kernel.mf_sgd_tier` (the CPU path, no launch)
    against `mf_step_packed` on the same windows, batch by batch; and the
    whole epoch with ``use_kernels`` against the packed steps."""
    tsp, _ = tiny
    K, F = 4, 8
    JK = torch.zeros((tsp.N, K), dtype=torch.int32)
    sched = sparse.conflict_free_schedule(
        _np(tsp.rows), _np(tsp.cols), batch=64, tiers=3, tier_shrink=0.5,
        M=tsp.M, N=tsp.N, seed=1)
    assert sched.stats()["nb_cf"] and any((~v).any() for v in
                                          sched.tier_valid)
    sd = model.build_scheduled_data(tsp, JK, sched, mf_only=True)
    pp = model.pack_params(model.init_from_data(prng.PRNGKey(4), tsp, F, K))
    hp, decay = sgd.Hyper(), sgd.lr_decay(sgd.Hyper(), 1)
    hmf = ops.mf_hyper(hp, decay, "cpu")
    fused, packed = _copy(pp), _copy(pp)
    before = kernel.MF_LAUNCHES
    for t, (starts, valid) in enumerate(zip(sched.tier_starts,
                                            sched.tier_valid)):
        width = sched.widths[t]
        masks = torch.as_tensor(valid).float()
        step = kernel.mf_sgd_tier(fused, sd, masks, hmf, width=width,
                                  starts=starts)
        for k, s in enumerate(starts.tolist()):
            step(s, k)
            sgd.mf_step_packed(packed, model.slice_batch(sd, s, width,
                                                         masks[k]),
                               hp, decay, conflict_free=True)
            np.testing.assert_allclose(_np(fused.row), _np(packed.row),
                                       **TOL)
            np.testing.assert_allclose(_np(fused.col), _np(packed.col),
                                       **TOL)
    assert kernel.MF_LAUNCHES == before
    assert np.abs(_np(fused.row) - _np(pp.row)).max() > 1e-3
    assert torch.equal(fused.col[:, F:], pp.col[:, F:])
    key = prng.PRNGKey(8)
    run = lambda q, **kw: sgd.train_epoch_scheduled(
        q, sd, sched, key, 1, hp, mf_only=True, **kw)
    whole = run(_copy(pp), use_kernels=True)
    want = run(_copy(pp), use_kernels=False)
    assert kernel.MF_LAUNCHES == before
    np.testing.assert_allclose(_np(whole.row), _np(want.row), **TOL)
    np.testing.assert_allclose(_np(whole.col), _np(want.col), **TOL)

def test_packed_steps_bit_identical_to_unpacked(tiny):
    tsp, jsp = tiny
    hp, d = sgd.Hyper(), torch.tensor(0.9)
    JK, idx = _cf_batch(tsp, 4, 64, seed=11)
    bt, _, p, _ = _both(tsp, jsp, JK, idx, np.ones(len(idx), bool), seed=3)
    pp = model.pack_params(p)
    for f in ("U", "V", "b", "bh", "W", "C"):
        assert torch.equal(getattr(model.unpack_params(pp), f),
                           getattr(p, f)), f
    cases = [(sgd.culsh_step(p, bt, hp, d, conflict_free=True),
              sgd.culsh_step_packed(_copy(pp), bt, hp, d,
                                    conflict_free=True), "cf"),
             (sgd.mf_step(p, bt, hp, d, conflict_free=True),
              sgd.mf_step_packed(_copy(pp), bt, hp, d, conflict_free=True),
              "mf")]
    ridx = np.random.default_rng(5).integers(0, tsp.nnz, 96).astype(np.int32)
    btc = model.assemble(tsp, torch.tensor(JK), torch.tensor(ridx),
                         torch.ones(96))
    cases.append((sgd.culsh_step(p, btc, hp, d),
                  sgd.culsh_step_packed(_copy(pp), btc, hp, d), "scaled"))

    def inv_count(ids):
        _, inv, cnt = np.unique(_np(ids), return_inverse=True,
                                return_counts=True)
        return torch.tensor(np.float32(1.0) / cnt.astype(np.float32)[inv])

    cases.append((sgd.culsh_step(p, btc, hp, d),
                  sgd.culsh_step_packed(_copy(pp), btc, hp, d,
                                        scales=(inv_count(btc.i),
                                                inv_count(btc.j))),
                  "precomputed-scales"))
    cases.append((sgd.mf_step(p, btc, hp, d),
                  sgd.mf_step_packed(_copy(pp), btc, hp, d), "mf-scaled"))
    for want, got_pp, tag in cases:
        got = model.unpack_params(got_pp)
        for f in ("U", "V", "b", "bh", "W", "C"):
            assert torch.equal(getattr(got, f), getattr(want, f)), \
                f"{tag}:{f}"


def test_unpacked_steps_match_jax(tiny):
    tsp, jsp = tiny
    JK, idx = _cf_batch(tsp, 4, 96, seed=7)
    ridx = np.random.default_rng(1).integers(0, tsp.nnz, 80).astype(np.int32)
    for ids, cf in ((idx, True), (ridx, False)):
        bt, jbt, p, jp = _both(tsp, jsp, JK, ids, np.ones(len(ids), bool),
                               seed=2)
        for step, jstep in ((sgd.culsh_step, jsgd.culsh_step),
                            (sgd.mf_step, jsgd.mf_step)):
            for bce in (False, True):
                got = step(p, bt, sgd.Hyper(), torch.tensor(0.7), bce=bce,
                           conflict_free=cf)
                want = jstep(jp, jbt, jsgd.Hyper(), jnp.float32(0.7),
                             bce=bce, conflict_free=cf)
                for f in ("U", "V", "b", "bh", "W", "C"):
                    np.testing.assert_allclose(
                        _np(getattr(got, f)), np.asarray(getattr(want, f)),
                        **TOL, err_msg=f"{step.__name__} cf={cf} {f}")


def test_lr_decay_and_hyper_vectors():
    hp = sgd.Hyper()
    for t in range(4):
        np.testing.assert_array_equal(
            _np(sgd.lr_decay(hp, t)),
            np.asarray(jsgd.lr_decay(jsgd.Hyper(), jnp.asarray(t))))
    d = sgd.lr_decay(hp, 3)
    v = ops.culsh_hyper(hp, d, torch.tensor(3.25))
    assert v.shape == (13,) and float(v[12]) == 3.25
    assert float(v[2]) == float(np.float32(0.02) * _np(d))
    assert ops.mf_hyper(hp, d, "cpu").shape == (4,)


def test_impl_rule():
    ref = lambda: "ref"
    kern = lambda: "kernel"
    assert pick("auto", torch.device("cpu"), kern, ref) is kern
    assert pick("ref", torch.device("cpu"), kern, ref) is ref
    with pytest.raises(ValueError, match="CUDA"):
        pick("cuda", torch.device("cpu"), kern, ref)
    with pytest.raises(ValueError):
        pick("pallas", torch.device("cpu"), kern, ref)
