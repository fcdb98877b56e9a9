"""Port vs JAX package: LM training (`models/steps.py`'s training half,
`models/lsh_softmax.py`, `launch/train.py`, nested-tree checkpoints), on
the CPU at the reduced dense configs, float32 unless a case says
otherwise.  The oracle is always the JAX function at the installed
version.

* `lm_loss` within 1e-5, with and without a mask, in both arms (the
  simLSH arm with a label among its candidates); autograd's gradients
  against `jax.grad`, each leaf within 1e-5 of its own max |g|; remat on
  and off give equal gradients.
* Adam in stages (its first step is about lr·sign(g), so entries whose
  gradient is near 0 flip with summation order, and one loose tolerance
  on the parameters would test nothing): `init_opt` equal; `adam_update`
  of the same gradients with the clip inactive gives bit-equal moments
  and parameters within 2 ulp of their scale; with the clip active, a
  gradient whose squared norm every summation order gives exactly keeps
  the moments bit-equal, and a random one holds `gnorm` within 1e-6 and
  the moments within twice that; bfloat16 moments within one bfloat16
  ulp.
* `make_train_step`: the accumulated gradient (the first moment after
  one step is (1 − b1)·g·scale) within 1e-5 of each leaf's max at µ = 2
  with ``mb_mask`` [1, 1] and [1, 0], and in a bfloat16 accumulator
  within its rounding; the ``cands`` split of the simLSH arm; the
  straggler case (`test_lm.py::test_straggler_drop_microbatch`).
* `train_loop`: five steps' losses within 1e-4 of the JAX loop's; a
  checkpoint written by either package restores in the other bit for
  bit; a resumed run's losses equal the JAX resume's (both draw from
  the seed's first batch again).
* `hash_embeddings` / `refresh`: signature bits differ only where the
  float32 sum lies within rounding of 0 (counted, bounded); the strided
  sample's positions bit-equal to `jnp.linspace` over a sweep;
  `candidates_for` equal from the same state.
* A bfloat16 leaf: both packages write the same bytes, and neither
  restores it.
* bfloat16 compute: one step's loss and gradients within stated
  multiples of u = 2⁻⁸.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JCB
from repro.launch import train as jtrain
from repro.models import lm as jlm
from repro.models import lsh_softmax as JLS
from repro.models import steps as jsteps
from repro.train import checkpoint as jckpt
from repro_torch import convert, prng
from repro_torch import tree as T
from repro_torch.configs import base as CB
from repro_torch.launch import train as ttrain
from repro_torch.models import lm, steps
from repro_torch.models import lsh_softmax as LS
from repro_torch.train import checkpoint as ckpt

DENSE = ("llama3-8b", "llama3-405b", "qwen1.5-0.5b", "qwen3-0.6b")
U = 2.0 ** -8                     # bfloat16's unit roundoff


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(name, **kw):
    kw = {"dtype": "float32", **kw}
    return tuple(dataclasses.replace(c, **kw) for c in (
        JCB.reduced(JCB.get(name)), CB.reduced(CB.get(name))))


def _port(tree, dtype=None):
    return convert.lm_params_from_numpy(jax.tree.map(np.asarray, tree),
                                        device="cpu", dtype=dtype)


def _np_leaves(tree):
    return [np.asarray(a, np.float32) if np.asarray(a).dtype.name
            == "bfloat16" else np.asarray(a) for a in jax.tree.leaves(tree)]


def _t_leaves(tree):
    return [t.detach().float().numpy() if t.dtype == torch.bfloat16
            else t.detach().numpy() for t in T.leaves(tree)]


def _batch(cfg, B=2, S=16, seed=0, mask=False):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if mask:
        b["mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
    return b


def _both(b):
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()})


def assert_grads_close(got, want, rel=1e-5, floor=1e-4):
    """Each gradient leaf within ``rel`` of its own max |g| (plus 4 ulp of
    it), and every leaf's max |g| above ``floor`` (far above the bound:
    an all-zero or sign-flipped leaf fails)."""
    for n, (a, b) in enumerate(zip(got, want)):
        scale = np.float32(np.abs(b).max())
        assert np.isfinite(scale) and scale > floor, (n, scale)
        bound = rel * scale + 4 * np.spacing(scale)
        err = np.abs(a - b).max()
        assert err <= bound, (n, err, bound, scale)


# --------------------------------------------------------------------------
# the loss and its gradients
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", DENSE)
def test_lm_loss_matches_jax(name):
    jc, tc = _cfgs(name)
    jp = jlm.init_params(jc, jax.random.PRNGKey(0), model_shards=1)
    tp = _port(jp)
    for mask in (False, True):
        jb, tb = _both(_batch(tc, mask=mask))
        want = float(jax.jit(jsteps.lm_loss, static_argnums=0)(jc, jp, jb))
        got = steps.lm_loss(tc, tp, tb)
        assert got.dtype == torch.float32 and got.ndim == 0
        np.testing.assert_allclose(float(got), want, rtol=1e-5)
    # the simLSH arm, a label among the candidates (masked to -1e30)
    jc2, tc2 = (dataclasses.replace(c, lsh_softmax=True) for c in (jc, tc))
    b = _batch(tc)
    b["cands"] = np.concatenate([b["labels"][0, :3], np.arange(
        40, 100)]).astype(np.int32)
    jb, tb = _both(b)
    want = float(jax.jit(jsteps.lm_loss, static_argnums=0)(jc2, jp, jb))
    np.testing.assert_allclose(float(steps.lm_loss(tc2, tp, tb)), want,
                               rtol=1e-5)
    # without cands the simLSH config takes the full arm, as in JAX
    jb, tb = _both(_batch(tc))
    np.testing.assert_allclose(float(steps.lm_loss(tc2, tp, tb)),
                               float(jax.jit(jsteps.lm_loss, static_argnums=0)(
                                   jc, jp, jb)), rtol=1e-5)


def test_lsh_softmax_loss_close_to_full():
    """`test_lm.py::test_lsh_softmax_loss_close_to_full` on the port (at
    the reduced config's bfloat16 compute, as there), and its full-cover
    loss against the JAX package's within 4u."""
    jc, tc = _cfgs("qwen3-0.6b", dtype="bfloat16", lsh_softmax=True)
    jp = jlm.init_params(jc, jax.random.PRNGKey(0), model_shards=1)
    tp = _port(jp)
    b = _batch(tc, S=16)
    V = tc.vocab_padded(1)
    b["cands"] = np.arange(V, dtype=np.int32)               # full cover
    jb, tb = _both(b)
    loss_lsh = float(steps.lm_loss(tc, tp, tb))
    np.testing.assert_allclose(loss_lsh, float(jsteps.lm_loss(jc, jp, jb)),
                               rtol=4 * U)
    full = dataclasses.replace(tc, lsh_softmax=False)
    loss_full = float(steps.lm_loss(full, tp, {k: v for k, v in tb.items()
                                               if k != "cands"}))
    assert abs(loss_lsh - loss_full) < 1e-3
    tb["cands"] = torch.arange(64, dtype=torch.int32)
    assert float(steps.lm_loss(tc, tp, tb)) <= loss_full + 1e-4


@pytest.mark.parametrize("name", DENSE)
def test_grads_match_jax(name):
    jc, tc = _cfgs(name)
    jp = jlm.init_params(jc, jax.random.PRNGKey(1), model_shards=1)
    tp = _port(jp)
    jb, tb = _both(_batch(tc, mask=True))
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jsteps.lm_loss(jc, p, jb)))(jp)
    tl, tg = steps.value_and_grad(tc, tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert [p for p, _ in T.leaves_with_paths(tg)] == [
        p for p, _ in T.leaves_with_paths(tp)]
    assert_grads_close(_t_leaves(tg), _np_leaves(jg))


def test_simlsh_arm_grads_match_jax():
    """The candidate and label gathers' backward (`gather_rows`, rows
    added in index order) against `jax.grad`, with repeated ids."""
    jc, tc = _cfgs("qwen3-0.6b", lsh_softmax=True)
    jp = jlm.init_params(jc, jax.random.PRNGKey(2), model_shards=1)
    tp = _port(jp)
    b = _batch(tc, S=24)
    b["labels"][:, ::3] = 7                              # repeated labels
    b["cands"] = np.concatenate([np.arange(0, 64), np.arange(0, 64, 2),
                                 b["labels"][1, :4]]).astype(np.int32)
    jb, tb = _both(b)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jsteps.lm_loss(jc, p, jb)))(jp)
    tl, tg = steps.value_and_grad(tc, tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert_grads_close(_t_leaves(tg), _np_leaves(jg))


def test_remat_changes_no_gradient():
    _, tc = _cfgs("llama3-8b")
    assert tc.remat
    p = lm.init_params(tc, prng.PRNGKey(0), model_shards=1, device="cpu")
    _, tb = _both(_batch(tc))
    l1, g1 = steps.value_and_grad(tc, p, tb)
    l0, g0 = steps.value_and_grad(dataclasses.replace(tc, remat=False), p, tb)
    assert float(l1) == float(l0)
    for a, b in zip(T.leaves(g1), T.leaves(g0)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# --------------------------------------------------------------------------
# Adam
# --------------------------------------------------------------------------


def _adam_pair(md="float32", seed=0):
    jc, tc = _cfgs("llama3-8b", moment_dtype=md)
    jp = jlm.init_params(jc, jax.random.PRNGKey(seed), model_shards=1)
    return jc, tc, jp


def _random_grads(jp, scale, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: jnp.asarray(
        rng.normal(0, scale, x.shape).astype(np.float32)), jp)


def _two_updates(jc, tc, jp, g, **kw):
    """Two Adam updates of ``g`` in JAX, and each of them in the port from
    the JAX package's state before it (count 1 and 2 both checked, with
    no error carried from one to the next) → the JAX states after each,
    the port's pairs of (params, opt, gnorm)."""
    jo = jsteps.init_opt(jc, jp)
    jp1, jo1, jgn1 = jsteps.adam_update(jc, jp, g, jo, **kw)
    jp2, jo2, jgn2 = jsteps.adam_update(jc, jp1, g, jo1, **kw)
    tg = _port(g)
    got = []
    for p_, o_ in ((jp, jo), (jp1, jo1)):
        tp = _port(p_)
        to = convert.lm_opt_from_numpy(jax.tree.map(np.asarray, o_),
                                       device="cpu")
        tp, to, tgn = steps.adam_update(tc, tp, tg, to, **kw)
        got.append((tp, to, float(tgn)))
    return [(jp, jp1, jo1, float(jgn1)), (jp1, jp2, jo2, float(jgn2))], got


def _assert_params_2ulp(tp, jp2, jp1):
    """Within 2 ulp of the update's scale, the largest of the old and new
    parameter and the step ``lr·step`` between them (XLA may contract
    ``p − lr·step`` into one fused multiply-add, and ``step``'s own
    rounding shows at its scale where the parameter crosses 0)."""
    for a, b, prev in zip(_t_leaves(tp), _np_leaves(jp2), _np_leaves(jp1)):
        scale = np.maximum(np.maximum(np.abs(b), np.abs(prev)),
                           np.abs(b - prev))
        assert np.all(np.abs(a - b) <= 2 * np.spacing(scale))


@pytest.mark.parametrize("md", ["float32", "bfloat16"])
def test_init_opt_equals_jax(md):
    jc, tc, jp = _adam_pair(md)
    jo = jsteps.init_opt(jc, jp)
    to = steps.init_opt(tc, _port(jp))
    assert to["count"].dtype == torch.int32 and to["count"].ndim == 0
    assert int(to["count"]) == int(jo["count"]) == 0
    for k in ("m", "v"):
        assert [p for p, _ in T.leaves_with_paths(to[k])] == [
            p for p, _ in T.leaves_with_paths(_port(jp))]
        for a, b in zip(T.leaves(to[k]), jax.tree.leaves(jo[k])):
            assert a.dtype == getattr(torch, md) and b.dtype == md
            assert tuple(a.shape) == b.shape and not a.any()
    back = convert.lm_opt_from_numpy(jax.tree.map(np.asarray, jo),
                                     device="cpu")
    assert T.leaves(back["m"])[0].dtype == getattr(torch, md)
    assert back["count"].dtype == torch.int32


def test_adam_update_clip_inactive_equals_jax():
    jc, tc, jp = _adam_pair()
    g = _random_grads(jp, 1e-4)
    want, got = _two_updates(jc, tc, jp, g)
    for count, ((jp0, jp1, jo1, jgn), (tp, to, tgn)) in enumerate(
            zip(want, got), 1):
        assert jgn < 1.0                               # scale is exactly 1
        np.testing.assert_allclose(tgn, jgn, rtol=1e-6)
        assert int(to["count"]) == int(jo1["count"]) == count
        assert to["count"].dtype == torch.int32
        for k in ("m", "v"):
            for a, b in zip(_t_leaves(to[k]), _np_leaves(jo1[k])):
                np.testing.assert_array_equal(a, b)
        _assert_params_2ulp(tp, jp1, jp0)


def test_adam_update_clip_active_equals_jax():
    """±0.5 entries: every partial sum of the squares is a multiple of
    0.25 below 2²⁴, so the norm, and the clip's scale, are the same in
    any summation order — the moments must be bit-equal."""
    jc, tc, jp = _adam_pair()
    rng = np.random.default_rng(3)
    g = jax.tree.map(lambda x: jnp.asarray(np.where(
        rng.random(x.shape) < 0.5, -0.5, 0.5).astype(np.float32)), jp)
    for (jp0, jp1, jo1, jgn), (tp, to, tgn) in zip(*_two_updates(
            jc, tc, jp, g)):
        assert jgn > 1.0 and tgn == jgn
        for k in ("m", "v"):
            for a, b in zip(_t_leaves(to[k]), _np_leaves(jo1[k])):
                np.testing.assert_array_equal(a, b)
        _assert_params_2ulp(tp, jp1, jp0)


def test_adam_update_clip_active_random_grads():
    """A random gradient's norm depends on the summation order: within
    1e-6, and the moments (∝ the clip's scale, v ∝ its square) within
    twice that relative."""
    jc, tc, jp = _adam_pair()
    g = _random_grads(jp, 1e-2)
    for (_, _, jo1, jgn), (_, to, tgn) in zip(*_two_updates(
            jc, tc, jp, g, lr=1e-3)):
        assert jgn > 1.0
        assert abs(tgn - jgn) / jgn <= 1e-6
        for k in ("m", "v"):
            for a, b in zip(_t_leaves(to[k]), _np_leaves(jo1[k])):
                np.testing.assert_allclose(a, b, rtol=2 * 1e-6 + 2 ** -22,
                                           atol=0)


def test_adam_update_bfloat16_moments():
    jc, tc, jp = _adam_pair("bfloat16")
    g = _random_grads(jp, 1e-4)
    for (jp0, jp1, jo1, jgn), (tp, to, tgn) in zip(*_two_updates(
            jc, tc, jp, g)):
        np.testing.assert_allclose(tgn, jgn, rtol=1e-6)
        for k in ("m", "v"):
            for a, b in zip(T.leaves(to[k]), jax.tree.leaves(jo1[k])):
                assert a.dtype == torch.bfloat16
                ai = a.view(torch.int16).numpy().astype(np.int64)
                bi = np.asarray(b).view(np.int16).astype(np.int64)
                assert np.abs(ai - bi).max() <= 1
        _assert_params_2ulp(tp, jp1, jp0)


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------


def _step_pair(cfgs, jp, b):
    """One train step in both packages → (JAX aux, opt), (port aux, opt)."""
    jc, tc = cfgs
    jb, tb = _both(b)
    jo = jsteps.init_opt(jc, jp)
    _, jo1, jaux = jax.jit(jsteps.make_train_step(jc))(jp, jo, jb)
    tp = _port(jp)
    _, to1, taux = steps.make_train_step(tc)(tp, steps.init_opt(tc, tp), tb)
    return (jaux, jo1), (taux, to1)


@pytest.mark.parametrize("mb_mask,gd", [(None, "float32"),
                                        ([1.0, 0.0], "float32"),
                                        ([1.0, 1.0], "bfloat16")])
def test_microbatched_train_step_matches_jax(mb_mask, gd):
    cfgs = _cfgs("llama3-8b", microbatches=2, grad_dtype=gd)
    jp = jlm.init_params(cfgs[0], jax.random.PRNGKey(0), model_shards=1)
    b = _batch(cfgs[1], B=4, S=16)
    if mb_mask is not None:
        b["mb_mask"] = np.asarray(mb_mask, np.float32)
    (jaux, jo1), (taux, to1) = _step_pair(cfgs, jp, b)
    np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]),
                               rtol=1e-5)
    # a bfloat16 accumulator rounds each microbatch's gradient (u) and
    # their sum (u): the norm moves by up to 2u
    np.testing.assert_allclose(float(taux["gnorm"]), float(jaux["gnorm"]),
                               rtol=1e-5 if gd == "float32" else 2 * U)
    assert int(to1["count"]) == 1
    # m = (1 − b1)·scale·g: the accumulated gradient itself
    assert_grads_close(_t_leaves(to1["m"]), _np_leaves(jo1["m"]),
                       rel=1e-5 if gd == "float32" else 2 * U, floor=1e-6)


def test_straggler_drop_microbatch():
    """`test_lm.py::test_straggler_drop_microbatch` on the port: with
    ``mb_mask`` [1, 0] the loss is microbatch 0's alone."""
    _, cfg = _cfgs("llama3-8b", dtype="bfloat16", microbatches=2)
    p = lm.init_params(cfg, prng.PRNGKey(0), model_shards=1, device="cpu")
    _, tb = _both(_batch(cfg, B=4, S=16))
    loss0 = steps.lm_loss(dataclasses.replace(cfg, microbatches=1), p,
                          {k: v[:2] for k, v in tb.items()})
    opt = steps.init_opt(cfg, p)
    p2, _, aux = steps.make_train_step(cfg)(
        T.tree_map(torch.clone, p), opt,
        dict(tb, mb_mask=torch.tensor([1.0, 0.0])))
    np.testing.assert_allclose(float(aux["loss"]), float(loss0), rtol=1e-4)
    assert np.isfinite(float(aux["loss"]))


def test_cands_are_split_like_the_reference():
    """With µ = 2 a ``cands`` vector of even length passes the reference's
    shape test and is split: microbatch i is normalised over half i of
    the candidates (kept for parity, ROADMAP Queue 3)."""
    cfgs = _cfgs("qwen3-0.6b", microbatches=2, lsh_softmax=True)
    jc, tc = cfgs
    jp = jlm.init_params(jc, jax.random.PRNGKey(4), model_shards=1)
    b = _batch(tc, B=4, S=8)
    b["cands"] = np.arange(2, 130, dtype=np.int32)           # 128: even
    (jaux, jo1), (taux, to1) = _step_pair(cfgs, jp, b)
    np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]),
                               rtol=1e-5)
    assert_grads_close(_t_leaves(to1["m"]), _np_leaves(jo1["m"]),
                       floor=1e-6)
    one = dataclasses.replace(tc, microbatches=1)
    tp = _port(jp)
    _, tb = _both(b)
    halves = [steps.lm_loss(one, tp, {
        "tokens": tb["tokens"][2 * i:2 * i + 2],
        "labels": tb["labels"][2 * i:2 * i + 2],
        "cands": tb["cands"][64 * i:64 * i + 64]}) for i in range(2)]
    np.testing.assert_allclose(float(taux["loss"]), float(sum(halves)) / 2,
                               rtol=1e-5)


@pytest.mark.parametrize("name", DENSE)
def test_arch_smoke_forward_train(name):
    """`test_lm.py::test_arch_smoke_forward_train`'s dense cases on the
    port (bfloat16 compute, as the reduced configs)."""
    cfg = CB.reduced(CB.get(name))
    p = lm.init_params(cfg, prng.PRNGKey(0), model_shards=1, device="cpu")
    _, tb = _both(_batch(cfg, S=32))
    h = lm.forward(cfg, p, tb)
    assert h.shape == (2, 32, cfg.d_model)
    assert bool(torch.isfinite(h.float()).all())
    before = T.tree_map(torch.clone, p)
    p2, opt2, aux = steps.make_train_step(cfg)(p, steps.init_opt(cfg, p), tb)
    assert np.isfinite(float(aux["loss"])) and int(opt2["count"]) == 1
    moved = sum(float((a - b).abs().sum()) for a, b in zip(
        T.leaves(p2), T.leaves(before)))
    assert moved > 0


# --------------------------------------------------------------------------
# the loop, checkpoints and resume
# --------------------------------------------------------------------------


def test_train_loop_checkpoints_and_resume_match_jax(tmp_path):
    jc, tc = _cfgs("qwen3-0.6b")
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    kw = dict(batch=4, seq=32, lr=3e-4, log=lambda s: None)
    jp, jo, jl = jtrain.train_loop(jc, steps_n=5, ckpt_dir=jd, **kw)
    tp, to, tl = ttrain.train_loop(tc, steps_n=5, ckpt_dir=td, device="cpu",
                                   **kw)
    assert len(tl) == 5
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    # each package's step-5 checkpoint in the other, leaf for leaf
    got, step = ckpt.restore(jd, (tp, to), step=5)
    assert step == 5
    for a, b in zip(T.leaves(got), jax.tree.leaves((jp, jo))):
        assert isinstance(a, torch.Tensor) and a.dtype == getattr(
            torch, str(b.dtype))
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back, step = jckpt.restore(td, (jp, jo), step=5)
    for a, b in zip(jax.tree.leaves(back), T.leaves((tp, to))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert int(got[1]["count"]) == 5
    # resume to 7: both start from step 5's state and draw the seed's
    # first two batches again (the reference's rng is not restored)
    logs = []
    _, _, jr = jtrain.train_loop(jc, steps_n=7, ckpt_dir=jd, **kw)
    _, _, tr = ttrain.train_loop(tc, steps_n=7, ckpt_dir=td, device="cpu",
                                 **dict(kw, log=logs.append))
    assert logs[0] == "resumed from step 5" and len(tr) == 2
    np.testing.assert_allclose(tr, jr, rtol=0, atol=1e-4)
    rng = np.random.default_rng(0)
    first = ttrain.synth_batch(rng, tc, 4, 32)
    jfirst = jtrain.synth_batch(np.random.default_rng(0), jc, 4, 32)
    np.testing.assert_array_equal(first["tokens"].numpy(),
                                  np.asarray(jfirst["tokens"]))
    assert ckpt.latest_step(td) == jckpt.latest_step(jd) == 7


def test_train_loop_from_jax_params():
    """``train_loop(params=)`` starts from another package's parameters:
    the JAX package's draw for key 5, converted, trains as the JAX steps
    composed by hand from that draw over the seed-0 batches."""
    jc, tc = _cfgs("qwen3-0.6b")
    jp = jlm.init_params(jc, jax.random.PRNGKey(5), model_shards=1)
    step = jax.jit(jsteps.make_train_step(jc, lr=3e-4))
    jo, rng, want = jsteps.init_opt(jc, jp), np.random.default_rng(0), []
    for _ in range(3):
        jp, jo, aux = step(jp, jo, jtrain.synth_batch(rng, jc, 4, 32))
        want.append(float(aux["loss"]))
    start = _port(jlm.init_params(jc, jax.random.PRNGKey(5), model_shards=1))
    _, opt, got = ttrain.train_loop(tc, steps_n=3, batch=4, seq=32,
                                    log=lambda s: None, device="cpu",
                                    params=start)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert int(opt["count"]) == 3
    _, _, own = ttrain.train_loop(tc, steps_n=1, batch=4, seq=32,
                                  log=lambda s: None, device="cpu")
    assert abs(own[0] - want[0]) > 1e-3         # the seed's draw differs


def test_train_cli_runs_reduced_on_the_cpu(tmp_path, capsys):
    losses = ttrain.main(["--arch", "qwen1.5-0.5b", "--reduced", "--steps",
                          "2", "--batch", "2", "--seq", "16", "--device",
                          "cpu", "--ckpt-dir", str(tmp_path),
                          "--ckpt-every", "1"])
    assert len(losses) == 2 and "final loss" in capsys.readouterr().out
    assert ckpt.latest_step(str(tmp_path)) == 2


def test_train_loop_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.train_loop(CB.reduced(CB.get("qwen3-0.6b")), steps_n=1,
                          batch=1, seq=4)


def test_bfloat16_leaf_is_refused_by_both_packages(tmp_path):
    """The JAX package writes a bfloat16 leaf as raw ``|V2`` words and its
    own `restore` cannot read them back; the port writes the same bytes
    and refuses them alike (ROADMAP Queue 3, not fixed on one side)."""
    vals = np.linspace(-2, 2, 12, dtype=np.float32).reshape(3, 4)
    jtree = {"m": jnp.asarray(vals, jnp.bfloat16), "n": jnp.ones(3)}
    ttree = {"m": torch.from_numpy(vals).to(torch.bfloat16),
             "n": torch.ones(3)}
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    jckpt.save(jd, jtree, step=1, sync=True)
    ckpt.save(td, ttree, step=1, sync=True)
    raw = [np.load(f"{d}/step-00000001/shard-0.npz")["a0"] for d in (jd, td)]
    assert raw[0].dtype.str == raw[1].dtype.str == "|V2"
    assert raw[0].tobytes() == raw[1].tobytes()
    for d in (jd, td):
        with pytest.raises(TypeError):
            jckpt.restore(d, jtree)
        with pytest.raises(TypeError, match="leaf m"):
            ckpt.restore(d, ttree)


# --------------------------------------------------------------------------
# the simLSH softmax
# --------------------------------------------------------------------------


def test_hash_embeddings_and_refresh_match_jax():
    rng = np.random.default_rng(0)
    V, D = 512, 128
    E = rng.normal(0, 0.02, (V, D)).astype(np.float32)
    key = 5
    js = JLS.refresh(jnp.asarray(E), jax.random.PRNGKey(key), K=8)
    ts = LS.refresh(torch.from_numpy(E), prng.PRNGKey(key), K=8)
    assert ts.sigs.dtype == ts.nbrs.dtype == torch.int32
    assert tuple(ts.sigs.shape) == (8, V) and tuple(ts.nbrs.shape) == (V, 8)
    # bits may differ only where the float32 sum lies within rounding
    # of 0: |E[v]·Φ| ≤ D·2⁻²³·Σ|E[v]| (Φ = ±1)
    differ = 0
    for band in range(8):
        phi = np.asarray(jax.random.rademacher(jax.random.fold_in(
            jax.random.PRNGKey(key), band), (D, 16), jnp.float32))
        S = E.astype(np.float64) @ phi.astype(np.float64)       # [V, 16]
        tol = D * 2.0 ** -23 * np.abs(E).sum(1, keepdims=True)
        bits = lambda s: (s[:, None] >> np.arange(16)) & 1
        flips = bits(ts.sigs[band].numpy()) != bits(np.asarray(js.sigs[
            band]))
        assert np.all(np.abs(S[flips]) <= tol.repeat(16, 1)[flips])
        differ += int(flips.sum())
    assert differ <= 0.001 * V * 8 * 16
    # the bucket-mates: the JAX function on the port's signatures
    from repro.core import topk as jtopk
    want = jtopk.topk_from_signatures(jnp.asarray(ts.sigs.numpy()),
                                      jax.random.PRNGKey(key), K=8,
                                      band_cap=8)
    np.testing.assert_array_equal(ts.nbrs.numpy(), np.asarray(want))
    if differ == 0:
        np.testing.assert_array_equal(ts.nbrs.numpy(), np.asarray(js.nbrs))


def test_linspace_positions_equal_jnp_linspace():
    """The strided sample's positions against `jnp.linspace(...).astype(
    int32)` over a sweep of (n, take), and against the reference's own
    expression under `jax.jit` (its constants folded, as in
    `candidates_for`) on some of them."""
    pairs = [(n, t) for n in [1, 2, 3, 5, 17, 100, 255, 1000, 8191, 8192,
                               16384, 49152, 131072]
             for t in sorted({0, 1, 2, 3, 7, 64, 4096, 8192}) if t <= n]
    pairs += [(n, t) for n in (99, 1000, 8192, 49152)
              for t in (n // 3, n // 2, n - 1, n)]
    assert len(pairs) > 80
    torch_differs = 0
    for i, (n, take) in enumerate(pairs):
        got = LS._linspace_int32(n, take, "cpu")
        assert got.dtype == torch.int32
        want = np.asarray(jnp.linspace(0, n - 1, take).astype(jnp.int32))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(
            (n, take)))
        if i % 16 == 0:
            folded = jax.jit(lambda: jnp.linspace(0, n - 1, take).astype(
                jnp.int32))()
            np.testing.assert_array_equal(got.numpy(), np.asarray(folded))
        if take:
            torch_differs += int((torch.linspace(
                0, n - 1, take).to(torch.int32).numpy() != want).sum())
    assert torch_differs > 0            # why torch.linspace is not used


def test_candidates_for_equals_jax():
    rng = np.random.default_rng(1)
    V, D = 512, 64
    E = rng.normal(size=(V, D)).astype(np.float32)
    js = JLS.refresh(jnp.asarray(E), jax.random.PRNGKey(0), K=8)
    ts = LS.LSHSoftmaxState(sigs=torch.from_numpy(np.array(js.sigs)),
                            nbrs=torch.from_numpy(np.array(js.nbrs)),
                            step=torch.zeros((), dtype=torch.int32))
    for B, S, n_cands, seed in ((4, 16, 128, 9), (2, 8, 64, 3),
                                (1, 3, 64, 4), (8, 128, 128, 5)):
        labels = rng.integers(0, V, (B, S)).astype(np.int32)
        want = JLS.candidates_for(js, jnp.asarray(labels),
                                  jax.random.PRNGKey(seed), n_cands=n_cands)
        got = LS.candidates_for(ts, torch.from_numpy(labels),
                                prng.PRNGKey(seed), n_cands=n_cands)
        assert got.dtype == torch.int32 and got.shape == (n_cands,)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lsh_softmax_candidates():
    """`test_lm.py::test_lsh_softmax_candidates` on the port: duplicate
    rows are mutual bucket-mates, and the candidates hold the labels'
    top mates."""
    rng = np.random.default_rng(0)
    V, D = 64, 32
    E = rng.normal(size=(V, D)).astype(np.float32)
    E[32:] = E[:32]                       # duplicate rows
    st = LS.refresh(torch.from_numpy(E), prng.PRNGKey(0), K=4)
    dup = (st.nbrs[:32] == (torch.arange(32)[:, None] + 32)).any(1)
    assert float(dup.float().mean()) > 0.9
    labels = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    cands = LS.candidates_for(st, labels, prng.PRNGKey(1), n_cands=32)
    assert cands.shape == (32,)
    mates = st.nbrs[labels.reshape(-1).long()][:, 0].numpy()
    assert np.isin(mates, cands.numpy()).mean() > 0.5


# --------------------------------------------------------------------------
# bfloat16 compute
# --------------------------------------------------------------------------


def test_bfloat16_step_within_multiples_of_u():
    """One step at the reduced config's own bfloat16 compute: the loss
    within 4u of the JAX package's, and each gradient leaf within 32u of
    its own max |g| (two bfloat16 layers, each rounding its activations
    and weight casts at u, on sums the two packages order differently)."""
    jc, tc = _cfgs("qwen3-0.6b", dtype="bfloat16")
    jp = jlm.init_params(jc, jax.random.PRNGKey(0), model_shards=1)
    tp = _port(jp)
    jb, tb = _both(_batch(tc, S=32))
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jsteps.lm_loss(jc, p, jb)))(jp)
    tl, tg = steps.value_and_grad(tc, tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=4 * U)
    assert_grads_close(_t_leaves(tg), _np_leaves(jg), rel=32 * U)
