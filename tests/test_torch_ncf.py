"""Port vs JAX package: the NCF baselines of Table 10 (`core/ncf.py`) and
the implicit-feedback fit they are set against (`fit(loss="bce")`), on
the CPU at small sizes.

* `init` draws the JAX package's streams: the same keys and shapes, the
  biases zero, each float within 4 ulp of JAX's (`prng.normal`'s
  contract: `log1p` differs between libraries) and ≥ 95 % bit-equal.
* From the JAX package's parameters (`convert.ncf_params_from_numpy`):
  `logits` and `bce_loss` within 1e-5; autograd's gradients within 1e-5
  of `jax.grad`'s, each leaf relative to its own largest entry (most
  entries are ~1e-7 at this size, so an absolute 1e-5 would pass a zero
  or sign-flipped leaf); one Adam update given the *same* gradients within
  1e-6 of the JAX `adam_step` (Adam's first step is ≈ lr·sign(g), so a
  gradient near 0 whose sign flips between summation orders would move
  an entry by 2·lr — comparing the update on shared gradients keeps that
  out of the check); then 10 whole steps on each side at the reference's
  default lr 1e-3, compared on the loss trajectory within 1e-5 (≤ 1.8e-7
  measured).  At Table 10's lr 2e-2 whole steps drift apart: an entry
  whose gradient is within a few ε of 0 moves by lr·g/(|g|+ε), which
  turns summation-order noise of ~1e-9 into ~7e-5 on a parameter after
  one step, and the NeuMF losses differ by 5e-5 after five steps.
* `hit_ratio` equal on trained parameters (no float ties at this size).
* `test_online_checkpoint_ncf.py::test_ncf_models_learn` on the port.
* One epoch of Table 10's CULSH-MF fit (``loss="bce"``, positives plus
  3:1 sampled negatives) within 1e-5 of the JAX fit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ncf as jncf
from repro.core.sgd import Hyper as JHyper
from repro.core.simlsh import SimLSHConfig as JLSH
from repro.train import trainer as jtrainer
from repro_torch import convert, prng
from repro_torch import tree as T
from repro_torch.core import ncf
from repro_torch.core.sgd import Hyper
from repro_torch.core.simlsh import SimLSHConfig
from repro_torch.train import trainer

KINDS = ("gmf", "mlp", "neumf")
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(kind, M=64, N=32):
    kw = dict(M=M, N=N, F=8, mlp_layers=(16, 8), kind=kind)
    return jncf.NCFConfig(**kw), ncf.NCFConfig(**kw)


@pytest.fixture(scope="module")
def implicit():
    """`test_ncf_models_learn`'s planted data: user u likes item 7u mod N,
    one sampled negative per positive."""
    rng = np.random.default_rng(0)
    M, N = 64, 32
    users = np.repeat(np.arange(M), 6).astype(np.int32)
    pos = ((users * 7) % N).astype(np.int32)
    negs = rng.integers(0, N, len(users)).astype(np.int32)
    i = np.concatenate([users, users])
    j = np.concatenate([pos, negs])
    y = np.concatenate([np.ones(len(users)), np.zeros(len(users))])
    y[len(users):][negs == pos] = 1.0
    y = y.astype(np.float32)
    return (i, j, y), tuple(map(torch.from_numpy, (i, j, y))), rng


def assert_grads_close(got, want, rel=1e-5):
    """Each gradient leaf within ``rel`` of its own scale max|g| (plus 4
    ulp of it), every scale a real gradient (> 0): an all-zero or
    sign-flipped leaf fails however small its entries are."""
    for n, (a, b) in enumerate(zip(got, want)):
        scale = np.float32(np.abs(b).max())
        assert np.isfinite(scale) and scale > 0, (n, scale)
        bound = rel * scale + 4 * np.spacing(scale)
        err = np.abs(a - b).max()
        assert err <= bound, (n, err, bound, scale)


def _leaves_np(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


def _port(tree):
    return convert.ncf_params_from_numpy(jax.tree.map(np.asarray, tree),
                                         device="cpu")


@pytest.mark.parametrize("kind", KINDS)
def test_init_draws_the_jax_streams(kind):
    jc, tc = _configs(kind)
    jp = jncf.init(jc, jax.random.PRNGKey(0))
    tp = ncf.init(tc, prng.PRNGKey(0), device="cpu")
    assert list(tp) == list(jp)
    for k in jp:
        assert isinstance(tp[k], list) == isinstance(jp[k], list), k
    want, got = _leaves_np(jp), [t.numpy() for t in T.leaves(tp)]
    assert [g.shape for g in got] == [w.shape for w in want]
    assert all(g.dtype == np.float32 for g in got)
    for g, w in zip(got, want):
        np.testing.assert_array_max_ulp(g, w, maxulp=4)
    same = np.concatenate([(g == w).ravel() for g, w in zip(got, want)])
    assert same.mean() > 0.95
    for b in tp.get("mlp_b", []):
        assert not b.any()
    # another key draws another model
    other = ncf.init(tc, prng.PRNGKey(1), device="cpu")
    assert not any(torch.equal(a, b) and a.any() for a, b in zip(
        T.leaves(other), T.leaves(tp)))


@pytest.mark.parametrize("kind", KINDS)
def test_logits_loss_and_grads_match_jax(kind, implicit):
    (i, j, y), (ti, tj, ty), _ = implicit
    jc, tc = _configs(kind)
    jp = jncf.init(jc, jax.random.PRNGKey(0))
    tp = _port(jp)
    np.testing.assert_allclose(ncf.logits(tp, tc, ti, tj).detach().numpy(),
                               np.asarray(jncf.logits(jp, jc, i, j)), **TOL)
    np.testing.assert_allclose(float(ncf.bce_loss(tp, tc, ti, tj, ty)),
                               float(jncf.bce_loss(jp, jc, i, j, y)), **TOL)
    g = ncf.grads(tp, tc, ti, tj, ty)
    jg = jax.grad(jncf.bce_loss)(jp, jc, i, j, y)
    assert list(g) == list(jg)
    assert_grads_close([a.numpy() for a in T.leaves(g)], _leaves_np(jg))


@pytest.mark.parametrize("t", [1, 2, 7])
@pytest.mark.parametrize("kind", KINDS)
def test_one_adam_update_on_the_same_gradients(kind, t, implicit):
    """At step ``t`` from moments left by ``t - 1`` JAX steps, the port's
    update of the JAX gradients equals the JAX `adam_step`."""
    (i, j, y), _, _ = implicit
    jc, _ = _configs(kind)
    jp = jncf.init(jc, jax.random.PRNGKey(0))
    jm = jax.tree.map(jnp.zeros_like, jp)
    jv = jax.tree.map(jnp.zeros_like, jp)
    for s in range(1, t):
        jp, jm, jv = jncf.adam_step(jp, jm, jv, jnp.float32(s), jc, i, j, y,
                                    lr=2e-2)
    jg = jax.grad(jncf.bce_loss)(jp, jc, i, j, y)
    want = jncf.adam_step(jp, jm, jv, jnp.float32(t), jc, i, j, y, lr=2e-2)
    got = ncf.adam_update(_port(jp), _port(jm), _port(jv), _port(jg), t,
                          lr=2e-2)
    for g_tree, w_tree in zip(got, want):
        for a, b in zip(T.leaves(g_tree), _leaves_np(w_tree)):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_adam_steps_follow_the_jax_loss_trajectory(kind, implicit):
    (i, j, y), (ti, tj, ty), _ = implicit
    jc, tc = _configs(kind)
    jp = jncf.init(jc, jax.random.PRNGKey(0))
    jm = jax.tree.map(jnp.zeros_like, jp)
    jv = jax.tree.map(jnp.zeros_like, jp)
    tp = _port(jp)
    tm = T.tree_map(torch.zeros_like, tp)
    tv = T.tree_map(torch.zeros_like, tp)
    jl, tl = [], []
    for t in range(1, 11):
        jp, jm, jv = jncf.adam_step(jp, jm, jv, jnp.float32(t), jc, i, j, y)
        tp, tm, tv = ncf.adam_step(tp, tm, tv, t, tc, ti, tj, ty)
        jl.append(float(jncf.bce_loss(jp, jc, i, j, y)))
        tl.append(float(ncf.bce_loss(tp, tc, ti, tj, ty)))
    np.testing.assert_allclose(tl, jl, **TOL)
    assert tl[-1] < tl[0]


@pytest.mark.parametrize("kind", KINDS)
def test_hit_ratio_equals_jax(kind, implicit):
    (i, j, y), _, rng = implicit
    jc, tc = _configs(kind)
    jp = jncf.init(jc, jax.random.PRNGKey(0))
    jm = jax.tree.map(jnp.zeros_like, jp)
    jv = jax.tree.map(jnp.zeros_like, jp)
    for t in range(1, 40):
        jp, jm, jv = jncf.adam_step(jp, jm, jv, jnp.float32(t), jc, i, j, y,
                                    lr=2e-2)
    users = np.arange(64, dtype=np.int32)
    pos = ((users * 7) % 32).astype(np.int32)
    cands = np.random.default_rng(5).integers(0, 32, (64, 20)).astype(
        np.int32)
    tp = _port(jp)
    z = ncf.logits(tp, tc, torch.from_numpy(users)[:, None].expand(64, 21),
                   torch.from_numpy(np.concatenate([pos[:, None], cands],
                                                   1))).detach().numpy()
    for topk in (1, 5, 10):
        want = float(jncf.hit_ratio(jp, jc, users, pos, cands, topk=topk))
        got = float(ncf.hit_ratio(tp, tc, *map(torch.from_numpy,
                                               (users, pos, cands)),
                                  topk=topk))
        assert got == want, topk
    # no candidate's logit ties the positive's unless it is the positive
    ties = (z[:, 1:] == z[:, :1]) & (cands != pos[:, None])
    assert not ties.any()


def test_ncf_models_learn(implicit):
    """`tests/test_online_checkpoint_ncf.py::test_ncf_models_learn` on the
    port: 300 Adam steps halve each model's loss; the last model's HR@5
    beats chance by half."""
    _, (ti, tj, ty), _ = implicit
    rng = np.random.default_rng(0)
    rng.integers(0, 32, 64 * 6)            # the fixture's negatives' draw
    M, N = 64, 32
    for kind in KINDS:
        c = ncf.NCFConfig(M=M, N=N, F=8, mlp_layers=(16, 8), kind=kind)
        p = ncf.init(c, prng.PRNGKey(0), device="cpu")
        m = T.tree_map(torch.zeros_like, p)
        v = T.tree_map(torch.zeros_like, p)
        l0 = float(ncf.bce_loss(p, c, ti, tj, ty))
        for t in range(1, 300):
            p, m, v = ncf.adam_step(p, m, v, t, c, ti, tj, ty, lr=2e-2)
        l1 = float(ncf.bce_loss(p, c, ti, tj, ty))
        assert l1 < 0.5 * l0, f"{kind}: {l0} -> {l1}"
    cands = torch.from_numpy(rng.integers(0, N, (M, 20)).astype(np.int32))
    users = torch.arange(M, dtype=torch.int32)
    hr = float(ncf.hit_ratio(p, c, users, (users * 7) % N, cands, topk=5))
    assert hr > 5 / 21 * 1.5


def test_ncf_params_from_numpy_round_trips():
    jc, tc = _configs("neumf")
    jp = jncf.init(jc, jax.random.PRNGKey(3))
    tp = _port(jp)
    assert isinstance(tp["mlp_w"], list) and len(tp["mlp_w"]) == 2
    for a, b in zip(T.leaves(tp), _leaves_np(jp)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b)


def test_init_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ncf.init(ncf.NCFConfig(M=4, N=4), prng.PRNGKey(0))


def make_implicit(M=400, N=100, per_user=8, seed=0):
    """`benchmarks/bench_ncf.py::make_implicit`'s planted recipe."""
    rng = np.random.default_rng(seed)
    users = np.repeat(np.arange(M), per_user).astype(np.int32)
    items = ((users * 7 + rng.integers(0, 6, len(users))) % N).astype(
        np.int32)
    vals = np.ones(len(users), np.float32)
    _, uq = np.unique(users.astype(np.int64) * N + items, return_index=True)
    return users[uq], items[uq], vals[uq], M, N


def test_bce_fit_epoch_matches_jax():
    """One epoch of Table 10's CULSH-MF fit, on the bench's recipe and
    protocol: every parameter within 1e-5 of the JAX fit's."""
    users, items, vals, M, N = make_implicit()
    rng = np.random.default_rng(1)
    te = np.zeros(len(users), bool)
    _, last = np.unique(users[::-1], return_index=True)
    te[len(users) - 1 - last] = True
    tr = (users[~te], items[~te], vals[~te])
    negs = rng.integers(0, N, 3 * len(tr[0])).astype(np.int32)
    tr_mf = (np.concatenate([tr[0]] * 4), np.concatenate([tr[1], negs]),
             np.concatenate([tr[2], np.zeros(3 * len(tr[0]), np.float32)]))
    test = (users[te], items[te], np.ones(te.sum(), np.float32))
    hp = dict(a_u=0.2, a_v=0.2, a_b=0.1, a_bh=0.1, beta=0.02)
    kw = dict(F=16, K=8, epochs=1, batch=2048, method="simlsh", loss="bce",
              eval_every=0, shards=1)
    lsh = dict(G=8, p=1, q=10, psi_pow=1.0)
    want = jtrainer.fit(tr_mf, test, (M, N), jtrainer.FitConfig(
        lsh=JLSH(**lsh), hp=JHyper(**hp), kernel_impl="ref", **kw))
    got = trainer.fit(tr_mf, test, (M, N), trainer.FitConfig(
        lsh=SimLSHConfig(**lsh), hp=Hyper(**hp), **kw), device="cpu")
    np.testing.assert_array_equal(got.JK.numpy(), np.asarray(want.JK))
    for f in ("U", "V", "b", "bh", "W", "C", "mu"):
        np.testing.assert_allclose(getattr(got.params, f).numpy(),
                                   np.asarray(getattr(want.params, f)),
                                   **TOL, err_msg=f)
    moved = np.abs(got.params.bh.numpy()).max()
    assert moved > 1e-3
