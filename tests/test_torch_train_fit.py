"""Port vs JAX package: one scheduled SGD epoch and the whole offline fit
(`core/sgd.py::train_epoch_scheduled`, `train/trainer.py::fit`), on the
CPU at a small size (M = 200, N = 80, 2,700 training triples).

* One `train_epoch_scheduled` epoch from the same packed state, schedule
  and key, with ``use_kernels`` both ways (the port's kernel wrappers run
  their plain versions on the CPU; the JAX package's run its Pallas
  kernels in interpret mode or its jnp refs): within rtol/atol 1e-5.
* `fit` with ``method="simlsh"`` and ``"none"``: J^K and the schedule
  statistics equal, and the test RMSE after each of 3 epochs within
  1e-4 of the JAX package's (2.4e-7 measured: the Φ, J^K, schedule and
  batch order are bit-equal, the initial factors agree to a few ulp).
* The comparator neighbour methods run (their parity:
  `test_torch_comparators.py`), each also beside ``shards=2`` on two
  logical CPU devices (the shard tier's parity:
  `test_torch_shard_train.py`); with no device given `fit` runs on
  ``cuda``.  ``schedule="none"`` and checkpoints run:
  `tests/test_torch_legacy_ckpt.py`.
* `convert` carries keys and packed planes between the packages.
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
from repro.core import topk as jtopk
from repro.data import sparse as jsparse
from repro.train import trainer as jtrainer
from repro_torch import convert, prng
from repro_torch.core import model, sgd, simlsh
from repro_torch.data import sparse, synthetic
from repro_torch.launch import mesh as shard_mesh
from repro_torch.train import trainer

LSH = dict(G=8, p=1, q=10, band_cap=16)
SMALL = dict(F=8, K=4, cf_batch=64)
EPOCH_TOL = dict(rtol=1e-5, atol=1e-5)
RMSE_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    spec = dataclasses.replace(synthetic.MOVIELENS_LIKE, M=200, N=80,
                               nnz=3000)
    rows, cols, vals, _ = synthetic.generate(spec, seed=0)
    tr, te = sparse.train_test_split(np.random.default_rng(0), rows, cols,
                                     vals)
    return spec, tr, te


def _planes_close(got: model.PackedParams, want, **tol):
    np.testing.assert_allclose(got.row.numpy(), np.asarray(want.row), **tol)
    np.testing.assert_allclose(got.col.numpy(), np.asarray(want.col), **tol)


@pytest.mark.parametrize("use_kernels,jax_impl", [
    (False, "ref"), (True, "ref"), (True, "pallas")])
@pytest.mark.parametrize("method", ["simlsh", "none"])
def test_one_scheduled_epoch_matches_jax(data, method, use_kernels,
                                         jax_impl):
    spec, tr, _ = data
    shape = (spec.M, spec.N)
    mf_only = method == "none"
    K, F = SMALL["K"], SMALL["F"]
    jsp = jsparse.from_coo(*tr, shape)
    tsp = sparse.from_coo(*tr, shape, device="cpu")
    sigs = jsim.encode(jsp, jsim.SimLSHConfig(**LSH), jax.random.PRNGKey(3))
    jJK = jtopk.topk_from_signatures(sigs, jax.random.PRNGKey(4), K=K,
                                     band_cap=LSH["band_cap"])
    JK = torch.tensor(np.asarray(jJK))
    kw = dict(batch=64, tiers=4, tier_shrink=0.5, min_fill_frac=0.5,
              shards=1, M=spec.M, N=spec.N, seed=0)
    jsched = jsparse.conflict_free_schedule(np.asarray(jsp.rows),
                                            np.asarray(jsp.cols), **kw)
    sched = sparse.conflict_free_schedule(tsp.rows.numpy(),
                                          tsp.cols.numpy(), **kw)
    assert sched.stats() == jsched.stats()
    jsd = jmodel.build_scheduled_data(jsp, jJK, jsched, mf_only=mf_only)
    sd = model.build_scheduled_data(tsp, JK, sched, mf_only=mf_only)
    p0 = jmodel.init_from_data(jax.random.PRNGKey(1), jsp, F, K)
    jpp = jmodel.pack_params(p0)
    pp = convert.packed_from_numpy(jpp.row, jpp.col, jpp.mu, F, K,
                                   device="cpu")
    row0 = np.asarray(jpp.row).copy()
    key, epoch = jax.random.PRNGKey(7), 1
    want = jsgd.train_epoch_scheduled(
        jpp, jsd, jsched, key, jnp.asarray(epoch), jsgd.Hyper(),
        mf_only=mf_only, use_kernels=use_kernels, impl=jax_impl,
        interpret=True)
    got = sgd.train_epoch_scheduled(
        pp, sd, sched, convert.key_from_numpy(key), epoch, sgd.Hyper(),
        mf_only=mf_only, use_kernels=use_kernels)
    _planes_close(got, want, **EPOCH_TOL)
    moved = np.abs(got.row.numpy() - row0).max()
    assert moved > 1e-3                       # the epoch did train


def _fit_pair(data, method, use_kernels, epochs=3):
    spec, tr, te = data
    kw = dict(epochs=epochs, method=method, use_kernels=use_kernels, **SMALL)
    want = jtrainer.fit(tr, te, (spec.M, spec.N), jtrainer.FitConfig(
        lsh=jsim.SimLSHConfig(**LSH), kernel_impl="ref", **kw))
    got = trainer.fit(tr, te, (spec.M, spec.N), trainer.FitConfig(
        lsh=simlsh.SimLSHConfig(**LSH), **kw), device="cpu")
    return got, want


@pytest.mark.parametrize("method,use_kernels", [
    ("simlsh", True), ("simlsh", False), ("none", True)])
def test_fit_matches_jax(data, method, use_kernels):
    got, want = _fit_pair(data, method, use_kernels)
    if method == "simlsh":
        np.testing.assert_array_equal(got.JK.numpy(), np.asarray(want.JK))
        np.testing.assert_array_equal(got.hash_key.numpy().astype(np.uint32),
                                      np.asarray(want.hash_key))
        np.testing.assert_allclose(got.S.numpy(), np.asarray(want.S),
                                   rtol=1e-5, atol=1e-5)
    else:
        assert got.S is None and want.S is None
    assert got.schedule_stats["tiers"] == want.schedule_stats["tiers"]
    for k in ("nb_cf", "nb_lo", "n_cf", "n_lo", "cf_frac"):
        assert got.schedule_stats[k] == want.schedule_stats[k], k
    assert [h[0] for h in got.history] == [0, 1, 2]
    r_got = np.array([h[2] for h in got.history])
    r_want = np.array([h[2] for h in want.history])
    np.testing.assert_allclose(r_got, r_want, rtol=0, atol=RMSE_TOL)
    assert r_got[-1] < r_got[0]               # it trains
    for f in ("U", "V", "b", "bh", "W", "C"):
        np.testing.assert_allclose(getattr(got.params, f).numpy(),
                                   np.asarray(getattr(want.params, f)),
                                   rtol=1e-4, atol=1e-5, err_msg=f)
    reg = got.registry
    assert len(reg.span_durations("train.epoch")) == 3
    assert got.history[-1][1] == pytest.approx(
        sum(reg.span_durations("train.epoch")))
    assert got.prep_seconds == reg.span_durations("train.prep")[-1]


@pytest.mark.parametrize("change,match", [
    (dict(method="gsm"), "gsm"),
    (dict(method="rand"), "rand"),
    (dict(method="rp_cos"), "rp_cos"),
    (dict(method="minhash"), "minhash"),
    (dict(shards=2), "shard"),
])
def test_unported_paths_raise(data, change, match, monkeypatch):
    """No path is refused any more (the name is the earlier slices').
    Each comparator method the JAX package accepts runs (its parity:
    `test_torch_comparators.py`), and runs beside ``shards=2`` on two
    logical CPU devices, with a two-shard tier; without the devices
    ``shards=2`` is clamped to one shard, as the JAX package's `fit`
    clamps to its devices."""
    spec, tr, te = data
    cfg = trainer.FitConfig(epochs=1, **SMALL, **change)
    if "method" in change:
        res = trainer.fit(tr, te, (spec.M, spec.N), cfg, device="cpu")
        assert cfg.method == match and res.JK.shape == (spec.N, SMALL["K"])
        assert np.isfinite(res.history[-1][2])
        cfg = dataclasses.replace(cfg, shards=2)
    else:
        monkeypatch.delenv(shard_mesh.LOGICAL_DEVICES, raising=False)
        res = trainer.fit(tr, te, (spec.M, spec.N), cfg, device="cpu")
        assert res.schedule_stats["shard"]["shards"] == 1
    monkeypatch.setenv(shard_mesh.LOGICAL_DEVICES, "2")
    res = trainer.fit(tr, te, (spec.M, spec.N), cfg, device="cpu")
    assert res.schedule_stats["shard"]["shards"] == 2 and match in (
        "shard", cfg.method)
    assert res.schedule_stats["shard"]["n"] > 0
    assert np.isfinite(res.history[-1][2])


def test_unknown_options_are_errors(data):
    spec, tr, te = data
    for change in (dict(schedule="bogus"), dict(method="bogus")):
        with pytest.raises(ValueError, match="unknown"):
            trainer.fit(tr, te, (spec.M, spec.N),
                        trainer.FitConfig(epochs=1, **SMALL, **change),
                        device="cpu")


def test_shard_tier_epoch_raises(data):
    spec, tr, _ = data
    tsp = sparse.from_coo(*tr, (spec.M, spec.N), device="cpu")
    sched = sparse.conflict_free_schedule(
        tsp.rows.numpy(), tsp.cols.numpy(), batch=64, tiers=2, shards=2,
        M=spec.M, N=spec.N, seed=0)
    assert sched.shard_span > 0
    pp = model.pack_params(model.init_from_data(prng.PRNGKey(0), tsp, 8, 4))
    with pytest.raises(ValueError, match="shard tier"):   # no cells given
        sgd.train_epoch_scheduled(pp, None, sched, prng.PRNGKey(0), 0,
                                  sgd.Hyper())


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the CPU-only refusal")
def test_fit_runs_on_cuda_by_default(data):
    spec, tr, te = data
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trainer.fit(tr, te, (spec.M, spec.N),
                    trainer.FitConfig(epochs=1, **SMALL))


def test_convert_keys_and_packed_planes(data):
    spec, tr, _ = data
    for seed in (0, 5, 2 ** 31 - 1):
        jkey = jax.random.PRNGKey(seed)
        key = convert.key_from_numpy(np.asarray(jkey))
        assert torch.equal(key, prng.PRNGKey(seed))
        np.testing.assert_array_equal(prng.split(key, 3).numpy(),
                                      np.asarray(jax.random.split(jkey, 3)))
    typed = jax.random.key(9)
    assert torch.equal(convert.key_from_numpy(jax.random.key_data(typed)),
                       prng.PRNGKey(9))
    with pytest.raises(ValueError, match="uint32"):
        convert.key_from_numpy(np.zeros(2, np.int64))
    jsp = jsparse.from_coo(*tr, (spec.M, spec.N))
    jpp = jmodel.pack_params(jmodel.init_from_data(jax.random.PRNGKey(2), jsp,
                                                   8, 4))
    pp = convert.packed_from_numpy(jpp.row, jpp.col, jpp.mu, 8, 4,
                                   device="cpu")
    back = convert.to_numpy(pp)
    np.testing.assert_array_equal(back["row"], np.asarray(jpp.row))
    np.testing.assert_array_equal(back["col"], np.asarray(jpp.col))
    assert (back["F"], back["K"]) == (8, 4)
    with pytest.raises(ValueError, match="F=8, K=5"):
        convert.packed_from_numpy(jpp.row, jpp.col, jpp.mu, 8, 5,
                                  device="cpu")
