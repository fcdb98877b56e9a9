"""Port vs JAX package: the legacy fit path (``schedule="none"``) and
checkpoints, on the CPU at a small size (M = 200, N = 80, 2,700 training
triples).

* `epoch_batches` bit-equal; one `train_epoch` (culsh and mf, L2 and
  BCE) within rtol/atol 1e-5; the uncached `model.rmse` within 1e-5;
  `fit(schedule="none")`'s 3-epoch RMSE history within 1e-4.
* `train/checkpoint.py` keeps the JAX package's on-disk format: a
  checkpoint written by either package restores in the other bit for
  bit.  Torn step dirs are skipped, 3 steps are kept, an injected crash
  at ``ckpt.save`` leaves the previous step the latest.
* On the CPU a resumed `fit` (2 epochs, then 3) is bit-identical to an
  uninterrupted 3-epoch fit, on the legacy and the scheduled path, and a
  checkpoint taken mid-fit holds that step's parameters, not a later
  step's (the planes are updated in place after it is taken).
"""
import dataclasses
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import model as jmodel
from repro.core import sgd as jsgd
from repro.core import simlsh as jsim
from repro.data import sparse as jsparse
from repro.train import checkpoint as jckpt
from repro.train import trainer as jtrainer
from repro_torch import convert, prng
from repro_torch.core import model, sgd, simlsh
from repro_torch.data import sparse, synthetic
from repro_torch.resil import faults
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import trainer

LSH = dict(G=8, p=1, q=10, band_cap=16)
SMALL = dict(F=8, K=4, cf_batch=64)
EPOCH_TOL = dict(rtol=1e-5, atol=1e-5)
FIELDS = ("U", "V", "b", "bh", "W", "C", "mu")


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
    shape = (spec.M, spec.N)
    return (shape, tr, te, jsparse.from_coo(*tr, shape),
            sparse.from_coo(*tr, shape, device="cpu"))


def _params_pair(jsp, seed=1, F=8, K=4):
    """JAX `Params` with W, C as a trained state has them, and the port's
    copy of them."""
    rng = np.random.default_rng(seed)
    p0 = jmodel.init_from_data(jax.random.PRNGKey(seed), jsp, F, K)
    jp = dataclasses.replace(
        p0, W=jnp.asarray(0.1 * rng.normal(size=(jsp.N, K)), jnp.float32),
        C=jnp.asarray(0.1 * rng.normal(size=(jsp.N, K)), jnp.float32))
    return jp, _from_jax(jp)


def _from_jax(jp):
    return convert.params_from_numpy(
        *(np.array(getattr(jp, f)) for f in FIELDS), device="cpu")


def _assert_params_equal(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


@pytest.mark.parametrize("nnz,batch,seed", [(1000, 64, 0), (4096, 4096, 3),
                                            (2700, 512, 7)])
def test_epoch_batches_bit_equal(nnz, batch, seed):
    key = jax.random.PRNGKey(seed)
    idx, valid = sparse.epoch_batches(convert.key_from_numpy(
        np.asarray(key)), nnz, batch)
    jidx, jvalid = jsparse.epoch_batches(key, nnz, batch)
    assert idx.dtype == torch.int32 and valid.dtype == torch.bool
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


@pytest.mark.parametrize("bce", [False, True])
@pytest.mark.parametrize("mf_only", [False, True])
def test_train_epoch_matches_jax(data, mf_only, bce):
    _, _, _, jsp, tsp = data
    jp, tp = _params_pair(jsp)
    JK = np.random.default_rng(2).integers(0, jsp.N, (jsp.N, 4)).astype(
        np.int32)
    key, epoch = jax.random.PRNGKey(7), 1
    got = sgd.train_epoch(tp, tsp, torch.tensor(JK),
                          convert.key_from_numpy(np.asarray(key)), epoch,
                          sgd.Hyper(), batch=256, mf_only=mf_only, bce=bce)
    want = jsgd.train_epoch(jp, jsp, jnp.asarray(JK), key, jnp.asarray(epoch),
                            jsgd.Hyper(), batch=256, mf_only=mf_only,
                            bce=bce)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   err_msg=f, **EPOCH_TOL)
    assert np.abs(got.U.numpy() - tp.U.numpy()).max() > 1e-3   # it trained


@pytest.mark.parametrize("mf_only", [False, True])
def test_rmse_matches_jax(data, mf_only):
    _, _, te, jsp, tsp = data
    jp, tp = _params_pair(jsp)
    JK = np.random.default_rng(3).integers(0, jsp.N, (jsp.N, 4)).astype(
        np.int32)
    te_t = [torch.as_tensor(a) for a in te]
    got = model.rmse(tp, tsp, torch.tensor(JK), *te_t, batch=64,
                     mf_only=mf_only)
    want = jmodel.rmse(jp, jsp, jnp.asarray(JK), *map(jnp.asarray, te),
                       batch=64, mf_only=mf_only)
    assert te[0].shape[0] % 64                 # the last batch is padded
    np.testing.assert_allclose(float(got), float(want), **EPOCH_TOL)
    bts = list(model.eval_batches(tsp, torch.tensor(JK), *te_t, batch=64))
    assert sum(float(b.valid.sum()) for b in bts) == te[0].shape[0]


@pytest.mark.parametrize("method", ["simlsh", "none"])
def test_legacy_fit_matches_jax(data, method):
    shape, tr, te, _, _ = data
    kw = dict(epochs=3, method=method, schedule="none", batch=256, **SMALL)
    want = jtrainer.fit(tr, te, shape, jtrainer.FitConfig(
        lsh=jsim.SimLSHConfig(**LSH), **kw))
    got = trainer.fit(tr, te, shape, trainer.FitConfig(
        lsh=simlsh.SimLSHConfig(**LSH), **kw), device="cpu")
    r_got = np.array([h[2] for h in got.history])
    r_want = np.array([h[2] for h in want.history])
    assert [h[0] for h in got.history] == [0, 1, 2]
    np.testing.assert_allclose(r_got, r_want, rtol=0, atol=1e-4)
    assert r_got[-1] < r_got[0]
    assert got.schedule_stats is None and got.prep_seconds == 0.0
    assert len(got.registry.span_durations("train.epoch")) == 3


# ---------------------------------------------------------------- checkpoints

def test_checkpoints_cross_between_the_packages(data, tmp_path):
    _, _, _, jsp, _ = data
    jp, tp = _params_pair(jsp)
    jckpt.save(str(tmp_path / "jax"), jp, step=4, sync=True)
    got, step = ckpt.restore(str(tmp_path / "jax"), tp)
    assert step == 4
    _assert_params_equal(got, jp)
    assert got.mu.shape == () and got.U.dtype == torch.float32
    tp2 = dataclasses.replace(tp, U=tp.U + 1.0, mu=tp.mu + 0.5)
    ckpt.save(str(tmp_path / "torch"), tp2, step=9, sync=True)
    assert sorted(os.listdir(tmp_path / "torch" / "step-00000009")) == [
        "manifest.json", "shard-0.npz"]
    back, jstep = jckpt.restore(str(tmp_path / "torch"), jp)
    assert jstep == 9
    _assert_params_equal(back, tp2)


def test_torn_steps_are_skipped(data, tmp_path):
    _, _, _, jsp, _ = data
    _, tp = _params_pair(jsp)
    d = str(tmp_path)
    ckpt.save(d, tp, step=1, sync=True)
    ckpt.save(d, tp, step=2, sync=True)
    os.remove(os.path.join(d, "step-00000002", "manifest.json"))   # torn
    assert ckpt.latest_step(d) == 1
    assert ckpt.restore(d, tp)[1] == 1
    with pytest.raises(FileNotFoundError, match="torn"):
        ckpt.restore(d, tp, step=2)
    with open(os.path.join(d, "step-00000001", "shard-0.npz"), "wb") as f:
        f.write(b"\x00\x01")                   # a truncated shard
    assert ckpt.latest_step(d) is None
    assert ckpt.try_restore(d, tp) is None
    assert ckpt.try_restore(str(tmp_path / "absent"), tp) is None


def test_prune_keeps_three_and_shapes_are_checked(data, tmp_path):
    _, _, _, jsp, _ = data
    _, tp = _params_pair(jsp)
    d = str(tmp_path)
    for step in range(1, 6):
        ckpt.save(d, dataclasses.replace(tp, mu=tp.mu + step), step=step)
    ckpt.wait()
    assert sorted(os.listdir(d)) == [f"step-{s:08d}" for s in (3, 4, 5)]
    got, step = ckpt.restore(d, tp)
    assert step == 5 and float(got.mu) == float(tp.mu + 5)
    wrong = dataclasses.replace(tp, U=tp.U[:, :3])
    with pytest.raises(ValueError, match="leaf U"):
        ckpt.restore(d, wrong)


def test_save_copies_the_leaves_before_it_returns(data, tmp_path,
                                                 monkeypatch):
    """The writer thread is held until the caller has updated the live
    tensors in place, as the next epoch updates the planes."""
    _, _, _, jsp, _ = data
    _, tp = _params_pair(jsp)
    taken = dataclasses.replace(tp, **{f: getattr(tp, f).clone()
                                       for f in FIELDS})
    gate = threading.Event()
    write = ckpt._replace_write

    def held(path, fn):
        assert gate.wait(30)
        write(path, fn)

    monkeypatch.setattr(ckpt, "_replace_write", held)
    ckpt.save(str(tmp_path), tp, step=1)
    tp.U.add_(1.0)
    tp.mu.add_(1.0)
    gate.set()
    ckpt.wait()
    _assert_params_equal(ckpt.restore(str(tmp_path), tp)[0], taken)


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_injected_crash_keeps_the_previous_step(data, tmp_path):
    """The injected fault kills the save thread after the shard and before
    the manifest; the thread's exception is the simulated crash."""
    _, _, _, jsp, _ = data
    _, tp = _params_pair(jsp)
    d = str(tmp_path)
    ckpt.save(d, tp, step=1, sync=True)
    with faults.injected({"ckpt.save": faults.FaultSpec(at_calls=(0,))}) \
            as plan:
        ckpt.save(d, dataclasses.replace(tp, U=tp.U * 2), step=2, sync=True)
    assert plan.fired == {"ckpt.save": 1}
    assert ckpt.latest_step(d) == 1
    _assert_params_equal(ckpt.restore(d, tp)[0], tp)
    ckpt.save(d, tp, step=3, sync=True)       # cleans the crash remnant
    assert ckpt.latest_step(d) == 3
    assert not [f for f in os.listdir(d) if f.startswith(".tmp-")]


@pytest.mark.parametrize("schedule", ["none", "conflict_free"])
def test_resumed_fit_is_bit_identical(data, tmp_path, schedule):
    shape, tr, te, _, _ = data
    kw = dict(method="simlsh", schedule=schedule, batch=256,
              lsh=simlsh.SimLSHConfig(**LSH), **SMALL)
    whole = trainer.fit(tr, te, shape, trainer.FitConfig(epochs=3, **kw),
                        device="cpu")
    d = str(tmp_path)
    first = trainer.fit(tr, te, shape, trainer.FitConfig(
        epochs=2, ckpt_dir=d, ckpt_every=1, **kw), device="cpu")
    assert ckpt.latest_step(d) == 2
    resumed = trainer.fit(tr, te, shape, trainer.FitConfig(
        epochs=3, ckpt_dir=d, **kw), device="cpu")
    assert [h[0] for h in resumed.history] == [2]
    assert ckpt.latest_step(d) == 2            # ckpt_every=0 saves nothing
    _assert_params_equal(resumed.params, whole.params)
    assert resumed.history[-1][2] == whole.history[-1][2]
    assert [h[2] for h in first.history] == [h[2] for h in
                                             whole.history[:2]]


@pytest.mark.parametrize("schedule", ["none", "conflict_free"])
def test_mid_fit_checkpoint_holds_its_own_step(data, tmp_path, schedule):
    shape, tr, te, _, _ = data
    kw = dict(method="simlsh", schedule=schedule, batch=256,
              lsh=simlsh.SimLSHConfig(**LSH), **SMALL)
    d = str(tmp_path)
    trainer.fit(tr, te, shape, trainer.FitConfig(
        epochs=3, ckpt_dir=d, ckpt_every=1, **kw), device="cpu")
    like = model.init_from_data(prng.PRNGKey(0), sparse.from_coo(
        *tr, shape, device="cpu"), SMALL["F"], SMALL["K"])
    for step in (1, 2):
        got, _ = ckpt.restore(d, like, step=step)
        want = trainer.fit(tr, te, shape, trainer.FitConfig(epochs=step,
                                                            **kw),
                           device="cpu").params
        _assert_params_equal(got, want)
