"""Port vs JAX package: the fit's block-aligned shard tier
(`core/sgd.py::train_epoch_scheduled(shd=, mesh=)`, `train/trainer.py::
fit(FitConfig(shards=D))`), on the CPU at the JAX package's own check
size (`tests/helpers/multidev_checks.py::check_sharded_epoch`: M = 240,
N = 96, D = 4, K = 8, batch 64).

The JAX `shard_map` tier does not run under the installed jax, so the
oracle is the JAX package's single-device replay of the tier
(`_shard_replay`, which its docstring holds bit-equal to the `shard_map`
path): `train_epoch_scheduled(shd=)` with no mesh.  The port's replay
must match it within rtol/atol 1e-5 in every leaf and in RMSE over two
epochs (the JAX check's gate), for CULSH-MF and plain MF, with L2 and
BCE; the port's mesh path on four logical CPU devices
(``REPRO_TORCH_LOGICAL_DEVICES=4``) must match its replay and the JAX
replay the same way.  `fit(FitConfig(shards=4))` is held against the same
schedule, data and epochs composed from the JAX package's single-device
functions (the JAX `fit` clamps to its one device here).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import model as jmodel
from repro.core import sgd as jsgd
from repro.core import simlsh as jsim
from repro.data import sparse as jsparse
from repro.data import synthetic as jsyn
from repro.train import trainer as jtrainer
from repro_torch import convert, prng
from repro_torch.core import model, sgd, simlsh
from repro_torch.data import sparse
from repro_torch.launch import mesh as shard_mesh
from repro_torch.train import trainer

M, N, D, K, F = 240, 96, 4, 8, 8
TOL = dict(rtol=1e-5, atol=1e-5)
LEAVES = ("U", "V", "b", "bh", "W", "C")
LSH = dict(G=8, p=1, q=10, band_cap=16)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    """The JAX check's data, J^K, D = 4 schedule, both packages' data
    layouts, the initial state and a test set."""
    spec = dataclasses.replace(jsyn.MOVIELENS_LIKE, M=M, N=N, nnz=4000)
    rows, cols, vals, _ = jsyn.generate(spec, seed=0)
    jsp = jsparse.from_coo(rows, cols, vals, (M, N))
    tsp = convert.sparse_from_numpy(np.asarray(jsp.rows), np.asarray(jsp.cols),
                                    np.asarray(jsp.vals), (M, N),
                                    device="cpu")
    rng = np.random.default_rng(0)
    JK = rng.integers(0, N, (N, K)).astype(np.int32)
    kw = dict(batch=64, M=M, N=N, shards=D, seed=0)
    jsched = jsparse.conflict_free_schedule(np.asarray(jsp.rows),
                                            np.asarray(jsp.cols), **kw)
    sched = sparse.conflict_free_schedule(tsp.rows.numpy(), tsp.cols.numpy(),
                                          **kw)
    assert sched.shard_starts.size and sched.stats() == jsched.stats()
    p0 = jmodel.init_from_data(jax.random.PRNGKey(0), jsp, F, K)
    test = (rng.integers(0, M, 500).astype(np.int32),
            rng.integers(0, N, 500).astype(np.int32),
            rng.uniform(1, 5, 500).astype(np.float32))
    return dict(jsp=jsp, tsp=tsp, JK=JK, jsched=jsched, sched=sched, p0=p0,
                mu=np.float32(p0.mu), test=test)


def _layouts(w, mf_only):
    jJK, JK = jnp.asarray(w["JK"]), torch.from_numpy(w["JK"])
    return ((jmodel.build_scheduled_data(w["jsp"], jJK, w["jsched"],
                                         mf_only=mf_only),
             jmodel.build_shard_data(w["jsp"], jJK, w["jsched"],
                                     mf_only=mf_only)),
            (model.build_scheduled_data(w["tsp"], JK, w["sched"],
                                        mf_only=mf_only),
             model.build_shard_data(w["tsp"], JK, w["sched"],
                                    mf_only=mf_only)))


def _state(w):
    """(JAX packed planes, port packed planes) of the same remapped
    initial parameters."""
    p0 = jax.tree.map(jnp.copy, w["p0"])      # the JAX epoch donates it
    jpp = jmodel.pack_params(jmodel.remap_params(p0, w["jsched"]))
    return jpp, convert.packed_from_numpy(jpp.row, jpp.col, jpp.mu, F, K,
                                          device="cpu")


def _jax_epochs(w, jpp, jsd, jshd, epochs=2, **kw):
    key = jax.random.PRNGKey(1)
    for ep in range(epochs):
        jpp = jsgd.train_epoch_scheduled(
            jpp, jsd, w["jsched"], jax.random.fold_in(key, ep),
            jnp.asarray(ep), jsgd.Hyper(), shd=jshd, **kw)
    return jpp


def _port_epochs(w, pp, sd, shd, epochs=2, **kw):
    key = prng.PRNGKey(1)
    for ep in range(epochs):
        sgd.train_epoch_scheduled(pp, sd, w["sched"], prng.fold_in(key, ep),
                                  ep, sgd.Hyper(), shd=shd, **kw)
    return pp


def _public(w, pp, jax_side=False):
    if jax_side:
        p = jmodel.unmap_params(jmodel.unpack_params(pp), w["jsched"])
        return {f: np.asarray(getattr(p, f)) for f in LEAVES}
    p = model.unmap_params(model.unpack_params(pp), w["sched"])
    return {f: getattr(p, f).numpy() for f in LEAVES}


def _rmse(w, leaves, mf_only):
    """The test RMSE of public leaves, through the JAX package's `rmse`
    (the one evaluation both sides are held to)."""
    p = jmodel.Params(**{f: jnp.asarray(leaves[f]) for f in LEAVES},
                      mu=jnp.asarray(w["mu"], jnp.float32))
    r, c, v = (jnp.asarray(a) for a in w["test"])
    return float(jmodel.rmse(p, w["jsp"], jnp.asarray(w["JK"]), r, c, v,
                             mf_only=mf_only))


def _assert_leaves_close(got, want, w, mf_only):
    for f in LEAVES:
        np.testing.assert_allclose(got[f], want[f], err_msg=f, **TOL)
    assert abs(_rmse(w, got, mf_only) - _rmse(w, want, mf_only)) <= 1e-5
    return max(float(np.abs(got[f] - want[f]).max(initial=0.0))
               for f in LEAVES)


@pytest.mark.parametrize("mf_only", [False, True])
def test_build_shard_data_equals_jax(world, mf_only):
    (jsd, jshd), (sd, shd) = _layouts(world, mf_only)
    for f in ("i", "j", "r", "nb", "rnb", "expl"):
        a, b = getattr(shd, f).numpy(), np.asarray(getattr(jshd, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    D_, S, R = world["sched"].shard_starts.shape
    assert shd.i.shape == (D_, S, R, world["sched"].shard_width)


def test_shard_round_shuffle_equals_jax(world):
    (_, jshd), (_, shd) = _layouts(world, False)
    for seed in (0, 7):
        key = jax.random.PRNGKey(seed)
        jp, jv = jsgd._shard_round_shuffle(jshd, world["jsched"], key)
        p, v = sgd._shard_round_shuffle(shd, world["sched"],
                                        convert.key_from_numpy(key))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        for f in ("i", "j", "r", "nb", "rnb", "expl"):
            np.testing.assert_array_equal(getattr(p, f).numpy(),
                                          np.asarray(getattr(jp, f)), f)


@pytest.mark.parametrize("mf_only,bce", [(False, False), (True, False),
                                         (False, True), (True, True)])
def test_replay_two_epochs_match_jax(world, mf_only, bce):
    (jsd, jshd), (sd, shd) = _layouts(world, mf_only)
    jpp, pp = _state(world)
    want = _public(world, _jax_epochs(world, jpp, jsd, jshd, mf_only=mf_only,
                                      bce=bce), jax_side=True)
    got = _public(world, _port_epochs(world, pp, sd, shd, mf_only=mf_only,
                                      bce=bce))
    _assert_leaves_close(got, want, world, mf_only)
    assert np.abs(got["U"] - np.asarray(world["p0"].U)).max() > 1e-3


@pytest.mark.parametrize("mf_only", [False, True])
def test_mesh_tier_matches_replay_and_jax(world, monkeypatch, mf_only):
    """The tier over four logical CPU devices against the port's replay
    and the JAX replay; the largest difference is reported."""
    (jsd, jshd), (sd, shd) = _layouts(world, mf_only)
    jpp, pp_replay = _state(world)
    _, pp_mesh = _state(world)
    monkeypatch.setenv(shard_mesh.LOGICAL_DEVICES, "4")
    m = shard_mesh.make_shard_mesh(D, "cpu")
    replay = _public(world, _port_epochs(world, pp_replay, sd, shd,
                                         mf_only=mf_only))
    meshed = _public(world, _port_epochs(world, pp_mesh, sd, shd,
                                         mf_only=mf_only, mesh=m))
    jreplay = _public(world, _jax_epochs(world, jpp, jsd, jshd,
                                         mf_only=mf_only), jax_side=True)
    d_port = _assert_leaves_close(meshed, replay, world, mf_only)
    d_jax = _assert_leaves_close(meshed, jreplay, world, mf_only)
    print(f"mesh vs replay: max |Δ| {d_port:.3g}; vs the JAX replay "
          f"{d_jax:.3g}")


def test_mesh_tier_refuses_a_mismatched_mesh(world, monkeypatch):
    (_, _), (sd, shd) = _layouts(world, False)
    _, pp = _state(world)
    monkeypatch.setenv(shard_mesh.LOGICAL_DEVICES, "2")
    with pytest.raises(ValueError, match="4 shards, the mesh 2"):
        sgd.train_epoch_scheduled(pp, sd, world["sched"], prng.PRNGKey(0), 0,
                                  sgd.Hyper(), shd=shd,
                                  mesh=shard_mesh.make_shard_mesh(2, "cpu"))


def _jax_fit_composed(tr, te, cfg, shards):
    """`fit`'s stages from the JAX package's single-device functions, on
    a ``shards``-shard schedule through the replay → RMSE history."""
    k_nb, k_init, k_ep = jax.random.split(jax.random.PRNGKey(cfg.seed), 3)
    sp = jsparse.from_coo(*tr, (M, N))
    JK, _, _, _ = jtrainer.build_neighbours(sp, cfg, k_nb)
    mf_only = cfg.method == "none"
    if JK is None:
        JK = jnp.zeros((N, cfg.K), jnp.int32)
    params = jmodel.init_from_data(k_init, sp, cfg.F, cfg.K)
    sched = jsparse.conflict_free_schedule(
        np.asarray(sp.rows), np.asarray(sp.cols),
        batch=min(cfg.cf_batch, cfg.batch), tiers=cfg.tiers,
        tier_shrink=cfg.tier_shrink, min_fill_frac=cfg.min_fill_frac,
        shards=shards, M=M, N=N, seed=cfg.seed)
    sd = jmodel.build_scheduled_data(sp, JK, sched, mf_only=mf_only)
    shd = jmodel.build_shard_data(sp, JK, sched, mf_only=mf_only)
    te_r, te_c, te_v = (jnp.asarray(a) for a in te)
    ec = jmodel.build_eval_cache(sp, JK, te_r, te_c, mf_only=mf_only)
    state = jmodel.pack_params(jmodel.remap_params(params, sched))
    hist = []
    for ep in range(cfg.epochs):
        state = jsgd.train_epoch_scheduled(
            state, sd, sched, jax.random.fold_in(k_ep, ep), jnp.asarray(ep),
            cfg.hp, shd=shd, mf_only=mf_only, use_kernels=cfg.use_kernels,
            impl="ref", interpret=True)
        p = jmodel.unmap_params(jmodel.unpack_params(state), sched)
        hist.append(float(jmodel.rmse_cached(p, ec, te_r, te_c, te_v,
                                             mf_only=mf_only)))
    return np.asarray(hist), JK, sched


@pytest.fixture(scope="module")
def fit_data():
    spec = dataclasses.replace(jsyn.MOVIELENS_LIKE, M=M, N=N, nnz=4000)
    rows, cols, vals, _ = jsyn.generate(spec, seed=0)
    return sparse.train_test_split(np.random.default_rng(0), rows, cols,
                                   vals)


@pytest.mark.parametrize("method,use_kernels", [("simlsh", False),
                                                ("simlsh", True),
                                                ("none", True)])
def test_fit_four_shards_matches_jax_composition(fit_data, monkeypatch,
                                                 method, use_kernels):
    tr, te = fit_data
    kw = dict(F=F, K=K, epochs=2, cf_batch=64, method=method,
              use_kernels=use_kernels)
    want, jJK, jsched = _jax_fit_composed(
        tr, te, jtrainer.FitConfig(lsh=jsim.SimLSHConfig(**LSH), **kw), D)
    monkeypatch.setenv(shard_mesh.LOGICAL_DEVICES, "4")
    got = trainer.fit(tr, te, (M, N), trainer.FitConfig(
        lsh=simlsh.SimLSHConfig(**LSH), shards=4, **kw), device="cpu")
    if method == "simlsh":
        np.testing.assert_array_equal(got.JK.numpy(), np.asarray(jJK))
    assert got.schedule_stats["shard"] == jsched.stats()["shard"]
    assert got.schedule_stats["shard"]["shards"] == D
    hist = np.asarray([h[2] for h in got.history])
    np.testing.assert_allclose(hist, want, rtol=0, atol=1e-5)
    assert hist[-1] < hist[0]
    assert got.params.U.shape == (M, F) and got.params.V.shape == (N, F)


def test_fit_shards_auto_is_one_shard_without_devices(fit_data, monkeypatch):
    """``shards="auto"`` with no logical devices on the CPU is one shard,
    and the fit is the one-shard fit; a request beyond the devices is
    clamped to them, as the JAX package's `fit` clamps."""
    tr, te = fit_data
    monkeypatch.delenv(shard_mesh.LOGICAL_DEVICES, raising=False)
    kw = dict(F=F, K=K, epochs=1, cf_batch=64,
              lsh=simlsh.SimLSHConfig(**LSH))
    runs = [trainer.fit(tr, te, (M, N), trainer.FitConfig(shards=s, **kw),
                        device="cpu") for s in ("auto", 1, 4)]
    for res in runs:
        assert res.schedule_stats["shard"]["shards"] == 1
        assert [h[2] for h in res.history] == [h[2] for h in
                                               runs[1].history]
        for f in LEAVES:
            assert torch.equal(getattr(res.params, f),
                               getattr(runs[1].params, f)), f
