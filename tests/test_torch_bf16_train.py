"""Port vs JAX package: training with bfloat16 parameters, gradients and
moments (`models/steps.py`'s `init_opt`, `adam_update`,
`make_train_step`, `logits_of`'s blocked backward; `models/moe.py`'s
expert backward; `launch/train.py`; `train/checkpoint.py`), on the CPU
at ``dataclasses.replace(reduced(cfg), param_dtype="bfloat16",
moment_dtype="bfloat16", grad_dtype="bfloat16")`` for llama3-405b and
arctic-480b, the two configs that set all three.

* `init_opt` gives bfloat16 zeros in both packages.
* `adam_update` on bfloat16 leaves from the same gradients, clip
  inactive and active: the reference fed the float32 quotient of a
  bfloat16 sum, the port fed the quotient and fed the sum with
  ``denom``: the moments bit-equal, the parameters bit-equal but where
  the float32 value lies within `_assert_params_2ulp`'s 2 float32 ulp
  of a bfloat16 rounding midpoint (counted).  The folded division, in
  slices, is bit-equal to dividing first in one pass.
* The in-place bfloat16 sum is bit-equal to ``0 + (w_0·g_0).to(bf16) +
  (w_1·g_1).to(bf16)`` composed from `value_and_grad`.
* `make_train_step` at µ = 2 against the jitted JAX step.  At float32
  compute (the bfloat16 leaves upcast at each use) the loss within
  1e-5, the norm within 2u (u = 2⁻⁸), each first-moment leaf within 4u
  of its max and each expert leaf within the bound of the reference's
  bfloat16 accumulation, (4 + n)·u of its max for the n (token, slot)
  pairs an expert takes in a microbatch; arctic's routes equal first.
  At llama3-405b's own bfloat16 compute the loss within 4u and each leaf
  within 32u of its max (`test_torch_lm_train.py`'s bfloat16 bounds).
  arctic-480b at its bfloat16 compute against the reference run
  un-jitted (inside its jitted step the routes differ from its own eager
  ones on some tokens, and a flipped route moves a whole expert's
  gradient): over seeds 0–7 the routes first, the draws that route
  differently counted and printed, the others held to the same bounds
  with each expert stack within (4 + n)·u.
* An expert stack's gradient: the reference scatter-adds each token's
  term into the bfloat16 stack, the port sums a float32 GEMM and rounds
  once; the port is no farther than the reference from a float64 sum of
  each package's own terms, and within one rounding of it.
* `train_loop`: 3 steps' losses within 1e-4 of the JAX loop's; a
  bfloat16 checkpoint written by the JAX `save` restores in the port bit
  for bit; a resumed loop equals the same state stepped in memory.
* A bfloat16 step makes no float32 tensor of a parameter leaf's size
  (``ADAM_SLICE`` and ``LOGITS_CHUNK`` monkeypatched below the leaves'
  sizes) and never holds a second gradient tree (the bytes of tensors
  made in the step and alive at once, tracked at dispatch).
* `logits_of`'s blocked product: its gradients within the float32
  reordering bound of one product's.
"""
import dataclasses
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import base as JCB
from repro.launch import train as jtrain
from repro.models import layers as jL
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models import steps as jsteps
from repro.train import checkpoint as jckpt
from repro_torch import convert, prng
from repro_torch import tree as T
from repro_torch.configs import base as CB
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as L
from repro_torch.models import lm, steps
from repro_torch.models import moe as MOE
from repro_torch.train import checkpoint as ckpt

NAMES = ("llama3-405b", "arctic-480b")
U = 2.0 ** -8                            # bfloat16's unit roundoff
BF16 = dict(param_dtype="bfloat16", moment_dtype="bfloat16",
            grad_dtype="bfloat16")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(name, **kw):
    """(JAX config, port config): reduced, bfloat16 parameters, gradients
    and moments."""
    return tuple(dataclasses.replace(c, **(BF16 | kw)) for c in (
        JCB.reduced(JCB.get(name)), CB.reduced(CB.get(name))))


def _jax_params(jc, seed=0):
    return jlm.init_params(jc, jax.random.PRNGKey(seed), model_shards=1)


def _port(tree):
    return convert.lm_params_from_numpy(jax.tree.map(np.asarray, tree),
                                        device="cpu")


def _port_opt(jo):
    return convert.lm_opt_from_numpy(jax.tree.map(np.asarray, jo),
                                     device="cpu")


def _bits(x):
    """A bfloat16 array or tensor → its int16 words as int64 (numpy)."""
    if isinstance(x, torch.Tensor):
        return x.detach().reshape(-1).view(torch.int16).numpy().astype(
            np.int64)
    return np.asarray(x).reshape(-1).view(np.int16).astype(np.int64)


def _f64(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(x).astype(np.float64)


def _batch(cfg, B=4, S=16, seed=0, mb_mask=None):
    rng = np.random.default_rng(seed)
    b = {k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
         for k in ("tokens", "labels")}
    if mb_mask is not None:
        b["mb_mask"] = np.asarray(mb_mask, np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _routes(cfg, p, toks):
    """Each layer's expert ids through the port's forward, composed."""
    x, eids = lm.embed_tokens(p, cfg, toks), []
    for i in range(cfg.L):
        pl = lm.layer(p["layers"], i)
        x, _ = lm._attn_sublayer(pl, x, cfg, causal=True)
        eids.append(MOE.router(pl, L.rms_norm(x, pl["ln2"], cfg.norm_eps),
                               cfg)[0].numpy())
        x = lm._ffn_sublayer(pl, x, cfg)
    return eids


def _jax_routes(cfg, p, toks):
    """Each layer's expert ids through the JAX package's forward."""
    x, eids = jlm.embed_tokens(p, cfg, toks), []
    for i in range(cfg.L):
        pl = jax.tree.map(lambda a: a[i], p["layers"])
        x, _ = jlm._attn_sublayer(pl, x, cfg, causal=True)
        eids.append(np.asarray(jmoe.router(
            pl, jL.rms_norm(x, pl["ln2"], cfg.norm_eps), cfg)[0]))
        x = jlm._ffn_sublayer(pl, x, cfg, None, None)
    return eids


# --------------------------------------------------------------------------
# Adam on bfloat16 leaves
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_init_opt_gives_bfloat16_zeros(name):
    jc, tc = _cfgs(name)
    jp = _jax_params(jc)
    jo, to = jsteps.init_opt(jc, jp), steps.init_opt(tc, _port(jp))
    assert int(to["count"]) == int(jo["count"]) == 0
    for k in ("m", "v"):
        got, want = T.leaves(to[k]), jax.tree.leaves(jo[k])
        assert len(got) == len(want) == len(jax.tree.leaves(jp))
        for a, b in zip(got, want):
            assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
            assert tuple(a.shape) == b.shape and not a.any()


def _sums(jp, clip_active, seed=3):
    """A bfloat16 gradient sum of two microbatches shaped like ``jp``:
    small random values (the clip inactive), or ±0.5 (the clip active,
    and every partial sum of the quotients' squares exact, so the norm
    is the same in any order)."""
    rng = np.random.default_rng(seed)
    if clip_active:
        draw = lambda x: np.where(rng.random(x.shape) < 0.5, -0.5, 0.5)
    else:
        draw = lambda x: rng.normal(0, 1e-4, x.shape)
    return jax.tree.map(lambda x: jnp.asarray(draw(x).astype(np.float32),
                                              jnp.bfloat16), jp)


def _midpoint_cases(got, want, p_old, m32, v32, c1, c2, lr=3e-4, eps=1e-8):
    """Elements where the port's bfloat16 parameter differs from the
    reference's → their count; each must be one bfloat16 ulp apart with
    the float32 update ``p − lr·step`` (the port's own float32 value)
    within 2 float32 ulp of the update's scale of the midpoint between
    the two (XLA may contract ``p − lr·step`` into one fused
    multiply-add: `test_torch_lm_train.py::_assert_params_2ulp`)."""
    a, b = _bits(got), _bits(want)
    diff = np.flatnonzero(a != b)
    if diff.size == 0:
        return 0
    assert np.abs(a[diff] - b[diff]).max() == 1
    step = (m32 / c1) / (np.sqrt(v32 / c2) + np.float32(eps))
    p32 = (p_old * np.float32(1.0) - np.float32(lr) * step).reshape(-1)
    g64, w64 = _f64(got).reshape(-1), _f64(want).reshape(-1)
    mid = (g64[diff] + w64[diff]) / 2
    old = p_old.reshape(-1)[diff].astype(np.float64)
    scale = np.maximum(np.maximum(np.abs(w64[diff]), np.abs(old)),
                       np.abs(w64[diff] - old)).astype(np.float32)
    assert np.all(np.abs(p32[diff] - mid) <= 2 * np.spacing(scale))
    return int(diff.size)


@pytest.mark.parametrize("clip_active", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_adam_update_on_bfloat16_leaves_equals_jax(name, clip_active):
    """One jitted JAX `adam_update` of the float32 quotient of a bfloat16
    sum (what its train step feeds it) against the port's, fed the
    quotient and fed the sum with ``denom``: the two port updates
    bit-equal, the moments bit-equal to the reference's, the parameters
    bit-equal but for counted midpoint cases (at most 1 in 10³)."""
    jc, tc = _cfgs(name)
    jp = _jax_params(jc)
    jg = _sums(jp, clip_active)
    denom = 2.0
    jq = jax.tree.map(lambda g: g.astype(jnp.float32) / denom, jg)
    jo = jsteps.init_opt(jc, jp)
    jp1, jo1, jgn = jax.jit(lambda p, g, o: jsteps.adam_update(
        jc, p, g, o))(jp, jq, jo)
    assert (float(jgn) > 1.0) == clip_active
    runs = []
    for grads, kw in ((_port(jq), {}),
                      (_port(jg), dict(denom=torch.tensor(denom)))):
        tp, to = _port(jp), _port_opt(jo)
        runs.append(steps.adam_update(tc, tp, grads, to, **kw))
    (tp, to, tgn), (tp2, to2, tgn2) = runs
    assert float(tgn) == float(tgn2)
    for a, b in zip(T.leaves((tp, to)), T.leaves((tp2, to2))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if clip_active:
        assert float(tgn) == float(jgn)
    else:
        # the reference sums ~10⁶ float32 squares in float32 (1.6e-6
        # read), the port in float64
        np.testing.assert_allclose(float(tgn), float(jgn), rtol=1e-5)
    for k in ("m", "v"):
        for a, b in zip(T.leaves(to[k]), jax.tree.leaves(jo1[k])):
            assert a.dtype == torch.bfloat16
            np.testing.assert_array_equal(_bits(a), _bits(b))
    # the port's float32 values before rounding, from the same quotients
    scale = min(1.0, 1.0 / max(float(tgn), 1e-12))
    c1, c2 = np.float32(1 - 0.9), np.float32(1 - 0.95)
    n_mid = n_all = 0
    for a, b, p0, q in zip(T.leaves(tp), jax.tree.leaves(jp1),
                           jax.tree.leaves(jp), jax.tree.leaves(jq)):
        g32 = np.asarray(q, np.float32) * np.float32(scale)
        m32 = np.float32(1 - 0.9) * g32
        v32 = np.float32(1 - 0.95) * g32 * g32
        n_mid += _midpoint_cases(a, b, np.asarray(p0, np.float32), m32,
                                 v32, c1, c2)
        n_all += a.numel()
    assert n_mid <= n_all // 1000, (n_mid, n_all)


@pytest.mark.parametrize("clip_active", [False, True])
def test_folded_division_equals_dividing_first(clip_active, monkeypatch):
    """`adam_update` with ``denom``, each leaf and the norm in slices of a
    prime `ADAM_SLICE` (slices that cut rows), against the float32
    quotient tree updated in one pass: every parameter, moment and the
    norm bit-equal, two steps running."""
    _, tc = _cfgs("arctic-480b")
    p = lm.init_params(tc, prng.PRNGKey(0), model_shards=1, device="cpu")
    rng = np.random.default_rng(7)
    sd = 0.5 if clip_active else 1e-4
    g = T.tree_map(lambda t: torch.from_numpy(rng.normal(
        0, sd, t.shape).astype(np.float32)).to(torch.bfloat16), p)
    denom = torch.tensor(2.0)
    runs = []
    for sl, fold in ((steps.ADAM_SLICE, False), (4099, True)):
        monkeypatch.setattr(steps, "ADAM_SLICE", sl)
        tp, to = T.tree_map(torch.clone, (p, steps.init_opt(tc, p)))
        grads = g if fold else T.tree_map(lambda t: t.float() / denom, g)
        kw = dict(denom=denom) if fold else {}
        for _ in range(2):
            tp, to, gn = steps.adam_update(tc, tp, grads, to, **kw)
        assert (float(gn) > 1.0) == clip_active
        runs.append((T.leaves((tp, to)), float(gn)))
    assert max(t.numel() for t in T.leaves(p)) > 4099
    assert runs[0][1] == runs[1][1]
    for a, b in zip(runs[0][0], runs[1][0]):
        assert a.dtype == b.dtype and torch.equal(a, b)


# --------------------------------------------------------------------------
# the in-place bfloat16 sum and the train step
# --------------------------------------------------------------------------


def _capture_adam(monkeypatch):
    """Record the gradients and ``denom`` `make_train_step` hands Adam."""
    seen, adam = {}, steps.adam_update

    def capture(cfg, params, grads, opt, **kw):
        seen["g"] = T.tree_map(torch.clone, grads)
        seen["denom"] = kw.get("denom")
        return adam(cfg, params, grads, opt, **kw)

    monkeypatch.setattr(steps, "adam_update", capture)
    return seen


@pytest.mark.parametrize("mb_mask", [[1.0, 1.0], [1.0, 0.0]])
@pytest.mark.parametrize("name", NAMES)
def test_in_place_bfloat16_sum_is_the_composed_sum(name, mb_mask,
                                                   monkeypatch):
    """The µ = 2 step's bfloat16 gradient sum, made in place in the
    leaves' ``.grad``, against the reference's sum composed from
    `value_and_grad` by hand, ``0 + (w_0·g_0).to(bf16) +
    (w_1·g_1).to(bf16)``: bit for bit, the loss too, and ``denom`` is
    Σw handed to Adam undivided."""
    _, tc = _cfgs(name, microbatches=2)
    p = lm.init_params(tc, prng.PRNGKey(1), model_shards=1, device="cpu")
    _, tb = _batch(tc)
    w = torch.tensor(mb_mask)
    seen = _capture_adam(monkeypatch)
    _, _, aux = steps.make_train_step(tc)(
        T.tree_map(torch.clone, p), steps.init_opt(tc, p),
        dict(tb, mb_mask=w))
    one = dataclasses.replace(tc, microbatches=1)
    acc = T.tree_map(torch.zeros_like, p)
    loss = torch.zeros(())
    for i in range(2):
        l_i, g = steps.value_and_grad(one, p, {k: v[2 * i:2 * i + 2]
                                               for k, v in tb.items()})
        acc = T.tree_map(lambda a, b: a + (w[i] * b).to(a.dtype), acc, g)
        loss = loss + w[i] * l_i
    denom = torch.clamp(w.sum(), min=1.0)
    assert float(aux["loss"]) == float(loss / denom)
    assert float(seen["denom"]) == float(denom)
    for a, b in zip(T.leaves(seen["g"]), T.leaves(acc)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def _step_pair(jc, tc, jp, jb, tb):
    """One train step in both packages → (JAX aux, opt), (port aux, opt)."""
    _, jo1, jaux = jax.jit(jsteps.make_train_step(jc))(
        jp, jsteps.init_opt(jc, jp), jb)
    tp = _port(jp)
    _, to1, taux = steps.make_train_step(tc)(tp, steps.init_opt(tc, tp), tb)
    return (jaux, jo1), (taux, to1)


def _pairs_an_expert_takes(tc, tp, tb):
    """The most (token, slot) pairs one expert takes in one microbatch
    and layer, from the port's routes (equal to the reference's)."""
    n = 0
    for i in range(tc.microbatches):
        mb = tb["tokens"].reshape(tc.microbatches, -1, tb["tokens"].shape[
            1])[i]
        for e in _routes(tc, tp, mb):
            n = max(n, int(np.bincount(e.reshape(-1),
                                       minlength=tc.n_experts).max()))
    return n


@pytest.mark.parametrize("mb_mask", [[1.0, 1.0], [1.0, 0.0]])
@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_jax_at_float32_compute(name, mb_mask):
    """One µ = 2 step, the bfloat16 leaves used at float32: the loss
    within 1e-5, the norm within 2u (each microbatch's gradient and
    their sum are rounded to bfloat16), each first-moment leaf (=
    (1 − b1)·scale·g, rounded to bfloat16) within 4u of its max, and each
    expert stack within (4 + n)·u of its max: the reference rounds each
    of the n pairs' terms into the bfloat16 stack, each time by at most
    u/2 of a partial sum of the order of the leaf's max, where the port
    rounds once.  arctic's routes equal first, microbatch by
    microbatch."""
    jc, tc = _cfgs(name, microbatches=2, dtype="float32")
    jp = _jax_params(jc, seed=2)
    jb, tb = _batch(tc, seed=2, mb_mask=mb_mask)
    experts = ("w1", "w3", "w2") if tc.family == "moe" else ()
    n = 0
    if experts:
        tp = _port(jp)
        for i in range(2):
            toks = tb["tokens"][2 * i:2 * i + 2]
            for a, b in zip(_routes(tc, tp, toks), _jax_routes(
                    jc, jp, jnp.asarray(toks.numpy()))):
                np.testing.assert_array_equal(a, b)
        n = _pairs_an_expert_takes(tc, tp, tb)
        assert n >= 8
    (jaux, jo1), (taux, to1) = _step_pair(jc, tc, jp, jb, tb)
    np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(taux["gnorm"]), float(jaux["gnorm"]),
                               rtol=2 * U)
    assert int(to1["count"]) == 1
    for (path, a), b in zip(T.leaves_with_paths(to1["m"]),
                            jax.tree.leaves(jo1["m"])):
        assert a.dtype == torch.bfloat16
        want = _f64(b)
        top = np.abs(want).max()
        assert top > 0, path
        k = (4 + n) if path.split("/")[-1] in experts else 4
        assert np.abs(_f64(a) - want).max() <= k * U * top, path


def test_train_step_matches_jax_at_bfloat16_compute():
    """llama3-405b's µ = 2 step at its own bfloat16 compute: the loss
    within 4u and each first-moment leaf within 32u of its max
    (`test_torch_lm_train.py::test_bfloat16_step_within_multiples_of_u`'s
    bounds: two bfloat16 layers round their activations at u, and the
    packages order their sums differently)."""
    jc, tc = _cfgs("llama3-405b", microbatches=2)
    assert tc.dtype == "bfloat16"
    jp = _jax_params(jc, seed=2)
    jb, tb = _batch(tc, seed=2)
    (jaux, jo1), (taux, to1) = _step_pair(jc, tc, jp, jb, tb)
    np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]),
                               rtol=4 * U)
    np.testing.assert_allclose(float(taux["gnorm"]), float(jaux["gnorm"]),
                               rtol=4 * U)
    for (path, a), b in zip(T.leaves_with_paths(to1["m"]),
                            jax.tree.leaves(jo1["m"])):
        want = _f64(b)
        assert np.abs(_f64(a) - want).max() <= 32 * U * np.abs(want).max()


ARCTIC_SEEDS = tuple(range(8))


def test_arctic_train_step_matches_unjitted_jax_at_bfloat16_compute():
    """arctic-480b's µ = 2 step at its own bfloat16 compute against the
    reference run un-jitted (`jax.disable_jit()`: the jitted step's own
    routes differ from its eager ones on some draws), over a fixed list
    of seeds.  Each draw's routes first, microbatch by microbatch: the
    draws whose routes differ are counted and printed, and at least half
    the seeds must be compared on values.  On the others the loss and
    the norm within 4u, each first-moment leaf within 32u of its max
    (the llama case's bounds) and each expert stack within (4 + n)·u of
    its max for the n (token, slot) pairs an expert takes."""
    jc, tc = _cfgs("arctic-480b", microbatches=2)
    assert tc.dtype == "bfloat16" and tc.moe_top_k < tc.n_experts
    experts = ("w1", "w3", "w2")
    differ, compared = [], 0
    for seed in ARCTIC_SEEDS:
        jp = _jax_params(jc, seed=seed)
        jb, tb = _batch(tc, seed=seed)
        tp = _port(jp)
        same = True
        with jax.disable_jit():
            for i in range(2):
                toks = tb["tokens"][2 * i:2 * i + 2]
                for a, b in zip(_routes(tc, tp, toks), _jax_routes(
                        jc, jp, jnp.asarray(toks.numpy()))):
                    same &= bool(np.array_equal(a, b))
            if not same:
                differ.append(seed)
                continue
            _, jo1, jaux = jsteps.make_train_step(jc)(
                jp, jsteps.init_opt(jc, jp), jb)
        n = _pairs_an_expert_takes(tc, tp, tb)
        _, to1, taux = steps.make_train_step(tc)(tp, steps.init_opt(tc, tp),
                                                 tb)
        np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]),
                                   rtol=4 * U)
        np.testing.assert_allclose(float(taux["gnorm"]),
                                   float(jaux["gnorm"]), rtol=4 * U)
        for (path, a), b in zip(T.leaves_with_paths(to1["m"]),
                                jax.tree.leaves(jo1["m"])):
            assert a.dtype == torch.bfloat16
            want = _f64(b)
            k = (4 + n) if path.split("/")[-1] in experts else 32
            assert np.abs(_f64(a) - want).max() <= k * U * np.abs(
                want).max(), (seed, path)
        compared += 1
    print(f"arctic-480b at bfloat16 compute: {len(differ)} of "
          f"{len(ARCTIC_SEEDS)} draws route differently from the un-jitted "
          f"reference (seeds {differ}); {compared} compared on values")
    assert compared >= len(ARCTIC_SEEDS) / 2, differ


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_gradient_is_nearer_the_float64_sum(dtype):
    """512 tokens over 4 experts (top 1, so every gate is 1) with
    bfloat16 stacks: each package's ``w2`` gradient against a float64
    sum of its own terms ``h_t ⊗ dy_t``.  The reference scatter-adds the
    terms into the bfloat16 stack one by one; the port sums them in a
    float32 GEMM and rounds once: it is within one rounding, u·|sum|
    (plus the float32 sum's error), of its float64 sum, and no farther from it
    than the reference is from its own."""
    E, D, ff, Tn = 4, 64, 32, 512
    jc, tc = _cfgs("arctic-480b", n_experts=E, moe_top_k=1, d_model=D,
                   d_ff=ff, dtype=dtype)
    rng = np.random.default_rng(11)
    bf = lambda *s, sd=1.0: rng.normal(0, sd, s).astype(np.float32)
    w = {n: bf(*s, sd=0.1) for n, s in (("w1", (E, D, ff)),
                                        ("w3", (E, D, ff)),
                                        ("w2", (E, ff, D)))}
    x, R = bf(1, Tn, D), bf(1, Tn, D)
    eid = rng.integers(0, E, (1, Tn, 1)).astype(np.int32)
    gate = np.ones((1, Tn, 1), np.float32)
    to_bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    jw = {n: jnp.asarray(a, jnp.bfloat16) for n, a in w.items()}
    cdt = getattr(jnp, dtype)
    jx, jR = jnp.asarray(x, cdt), jnp.asarray(R, cdt)
    jdw2 = jax.grad(lambda p: jnp.sum((jmoe.moe_dense_ref(
        p, jx, jnp.asarray(eid), jnp.asarray(gate), jc) * jR).astype(
        jnp.float32)))(jw)["w2"]
    tw = {n: to_bf(a).requires_grad_(True) for n, a in w.items()}
    tdt = getattr(torch, dtype)
    tx, tR = torch.from_numpy(x).to(tdt), torch.from_numpy(R).to(tdt)
    y = MOE.moe_dense_ref(tw, tx, torch.from_numpy(eid),
                          torch.from_numpy(gate), tc)
    (y.float() * tR.float()).sum().backward()
    tdw2 = tw["w2"].grad
    assert tdw2.dtype == torch.bfloat16 and jdw2.dtype == jnp.bfloat16
    # each package's own h_t (its own products), dy_t = R_t (gate 1)
    e = eid.reshape(-1)
    xt = jx.reshape(Tn, D)
    jh = jax.nn.silu(jnp.einsum("td,tdf->tf", xt, jw["w1"][e].astype(
        cdt)).astype(jnp.float32)).astype(cdt) * jnp.einsum(
        "td,tdf->tf", xt, jw["w3"][e].astype(cdt))
    th = torch.empty(Tn, ff, dtype=tdt)
    with torch.no_grad():
        for k in range(E):
            rows = np.flatnonzero(e == k)
            xe = tx.reshape(Tn, D)[rows]
            g = xe @ tw["w1"][k].to(tdt)
            th[rows] = F.silu(g.float()).to(tdt) * (xe @ tw["w3"][k].to(tdt))
    R64 = R.reshape(Tn, D).astype(np.float64)
    if dtype == "bfloat16":
        R64 = _f64(tR).reshape(Tn, D)
    errs = []
    for h, got in ((np.asarray(jh, np.float64), jdw2), (_f64(th), tdw2)):
        want = np.zeros((E, ff, D))
        absum = np.zeros((E, ff, D))
        for k in range(E):
            rows = e == k
            want[k] = h[rows].T @ R64[rows]
            absum[k] = np.abs(h[rows]).T @ np.abs(R64[rows])
        errs.append((np.abs(_f64(got) - want), want, absum))
    (j_err, _, _), (t_err, t_want, t_abs) = errs
    assert t_err.max() <= j_err.max()
    assert t_err.mean() < j_err.mean() / 2
    bound = U * np.abs(t_want) + Tn * 2.0 ** -23 * t_abs
    assert np.all(t_err <= bound)


# --------------------------------------------------------------------------
# the loop and checkpoints
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_train_loop_matches_jax(name):
    """Three `train_loop` steps at µ = 2, float32 compute: the losses
    within 1e-4 of the JAX loop's (the step-0 loss within 1e-5), and
    each leaf bfloat16 after them."""
    jc, tc = _cfgs(name, microbatches=2, dtype="float32")
    kw = dict(steps_n=3, batch=4, seq=16, lr=3e-4, log=lambda s: None)
    _, _, jl = jtrain.train_loop(jc, **kw)
    tp, opt, tl = ttrain.train_loop(tc, device="cpu", **kw)
    assert len(tl) == 3 and int(opt["count"]) == 3
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-5)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    assert all(t.dtype == torch.bfloat16 for t in T.leaves((tp, opt["m"],
                                                            opt["v"])))


@pytest.mark.parametrize("name", NAMES)
def test_jax_bfloat16_checkpoint_restores_in_the_port(name, tmp_path):
    """The JAX package's `save` of a bfloat16 ``(params, opt)`` after one
    µ = 2 step: the port's `restore` under its own bfloat16 template gives
    every leaf bit for bit (the JAX `restore` raises on such words:
    ROADMAP Queue 3)."""
    jc, tc = _cfgs(name, microbatches=2, dtype="float32")
    jp = _jax_params(jc, seed=4)
    jb, _ = _batch(tc, seed=4)
    jp, jo, _ = jax.jit(jsteps.make_train_step(jc))(
        jp, jsteps.init_opt(jc, jp), jb)
    d = str(tmp_path)
    jckpt.save(d, (jp, jo), step=1, sync=True)
    tp = lm.init_params(tc, prng.PRNGKey(9), model_shards=1, device="cpu")
    got, step = ckpt.restore(d, (tp, steps.init_opt(tc, tp)))
    assert step == 1 and int(got[1]["count"]) == 1
    want = jax.tree.leaves((jp, jo))
    assert len(T.leaves(got)) == len(want)
    for a, b in zip(T.leaves(got), want):
        if b.dtype == jnp.bfloat16:
            assert a.dtype == torch.bfloat16
            np.testing.assert_array_equal(_bits(a), _bits(b))
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", NAMES)
def test_resumed_loop_equals_the_state_stepped_in_memory(name, tmp_path):
    """µ = 2, bfloat16 throughout: the step-2 checkpoint restores bit for
    bit, and the loop resumed from it ends in the state that the same
    step-2 state stepped on in memory over the same batches reaches
    (both draw from the seed's first batch again): losses and every
    leaf bit-equal."""
    _, tc = _cfgs(name, microbatches=2)
    d = str(tmp_path)
    kw = dict(batch=4, seq=16, device="cpu", log=lambda s: None)
    p, opt, _ = ttrain.train_loop(tc, steps_n=2, ckpt_dir=d, ckpt_every=2,
                                  **kw)
    got, step = ckpt.restore(d, (p, opt))
    assert step == 2
    for a, w in zip(T.leaves(got), T.leaves((p, opt))):
        assert a.dtype == w.dtype and torch.equal(
            a.reshape(-1).view(torch.uint8), w.reshape(-1).view(torch.uint8))
    step_fn = steps.make_train_step(tc)
    rng, want = np.random.default_rng(0), []
    for _ in range(2):
        p, opt, aux = step_fn(p, opt, ttrain.synth_batch(rng, tc, 4, 16))
        want.append(float(aux["loss"]))
    logs = []
    p2, opt2, losses = ttrain.train_loop(tc, steps_n=4, ckpt_dir=d,
                                         **dict(kw, log=logs.append))
    assert logs[0] == "resumed from step 2" and losses == want
    for a, w in zip(T.leaves((p2, opt2)), T.leaves((p, opt))):
        assert a.dtype == w.dtype and torch.equal(a, w)


# --------------------------------------------------------------------------
# memory: no float32 leaf, no second gradient tree
# --------------------------------------------------------------------------


class _Live(TorchDispatchMode):
    """Tracks the tensors the ops under it make: the bytes of their
    storages alive at once (peak), and each float32 output's shape.  A
    storage is alive while any tensor made on it under the mode is."""

    def __init__(self):
        super().__init__()
        self.refs, self.nbytes = {}, {}
        self.now = self.peak = 0
        self.f32_shapes = []

    def _drop(self, key):
        self.refs[key] -= 1
        if not self.refs[key]:
            del self.refs[key]
            self.now -= self.nbytes.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = {a.untyped_storage().data_ptr() for a in torch.utils._pytree
               .tree_leaves((args, kwargs)) if isinstance(a, torch.Tensor)}
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if not isinstance(t, torch.Tensor):
                continue
            if t.dtype == torch.float32:
                self.f32_shapes.append(tuple(t.shape))
            st = t.untyped_storage()
            key = st.data_ptr()
            # a view, or an op in place, makes no storage
            if not st.nbytes() or not key or (key in ins
                                              and key not in self.refs):
                continue
            if key not in self.refs:
                self.refs[key] = 0
                self.nbytes[key] = st.nbytes()
                self.now += st.nbytes()
                self.peak = max(self.peak, self.now)
            self.refs[key] += 1
            weakref.finalize(t, self._drop, key)
        return out


@pytest.mark.parametrize("name", NAMES)
def test_bfloat16_step_makes_no_float32_leaf_and_one_gradient_tree(
        name, monkeypatch):
    """A µ = 2 bfloat16 step at L = 1 (the depth the full widths train
    at) with `ADAM_SLICE` (1,000) and `LOGITS_CHUNK` (4,096) below the
    large leaves' sizes, so Adam, the norm and the output table are read
    in slices: no float32 tensor the shape of a parameter leaf, of a
    layer's slice of a stack or of one expert's weight; and the bytes of
    the storages the step makes and holds at once stay below two
    gradient trees (1.6–1.8 read: the ``.grad`` sum, the layer's weight
    gradients on their way into it, activations).  A sum by trees, as the
    reference's scan carries it, holds a sum tree, a microbatch's tree
    and the next sum tree: 4.2–4.4 trees."""
    monkeypatch.setattr(steps, "ADAM_SLICE", 1000)
    monkeypatch.setattr(steps, "LOGITS_CHUNK", 4096)
    _, tc = _cfgs(name, microbatches=2, L=1)
    p = lm.init_params(tc, prng.PRNGKey(1), model_shards=1, device="cpu")
    opt = steps.init_opt(tc, p)
    _, tb = _batch(tc, B=2, S=4)
    shapes = set()
    for path, t in T.leaves_with_paths(p):
        if t.numel() > 4096:
            # the leaf, a layer's slice of a stack, an expert's weight
            shapes.add(tuple(t.shape))
            if path.startswith("layers/"):
                shapes.add(tuple(t.shape[1:]))
            if path.split("/")[-1] in ("w1", "w3", "w2") and t.ndim == 4:
                shapes.add(tuple(t.shape[2:]))
    assert len(shapes) >= 6
    step_fn = steps.make_train_step(tc)
    with _Live() as live:
        _, _, aux = step_fn(p, opt, tb)
        loss = float(aux["loss"])
    assert np.isfinite(loss)
    assert not shapes & set(live.f32_shapes), shapes & set(live.f32_shapes)
    tree_bytes = sum(t.numel() * 2 for t in T.leaves(p))
    assert live.peak < 2 * tree_bytes, (live.peak, tree_bytes)


# --------------------------------------------------------------------------
# the output table's blocked product
# --------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [1 << 28, 4096, 128 * 7])
def test_blocked_logits_gradients_within_reordering(chunk, monkeypatch):
    """`logits_of` on a bfloat16 table in blocks of `LOGITS_CHUNK`
    elements (the default: one block, the plain product; then 32 rows and
    7) against autograd of one float32 product: the logits and ``h``'s
    gradient within float32 reordering (2·n·2⁻²⁴·Σ|a||b| over each
    sum's n terms), the table's gradient, rounded to bfloat16, within one
    bfloat16 ulp (plus the reordering) of the float32 product's —
    bit-equal at the default."""
    monkeypatch.setattr(steps, "LOGITS_CHUNK", chunk)
    _, tc = _cfgs("llama3-405b")
    p = lm.init_params(tc, prng.PRNGKey(3), model_shards=1, device="cpu")
    E = p["out_embed"].detach().requires_grad_(True)
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.normal(0, 1, (2, 5, tc.d_model)).astype(
        np.float32)).to(torch.bfloat16).requires_grad_(True)
    G = torch.from_numpy(rng.normal(0, 1, (2, 5, tc.vocab)).astype(
        np.float32))
    lg = steps.logits_of(tc, dict(p, out_embed=E), h)
    gh, gE = torch.autograd.grad(lg, (h, E), G)
    E2 = p["out_embed"].detach().requires_grad_(True)
    h2 = h.detach().requires_grad_(True)
    ref = h2.float() @ E2.float().T
    rh, rE = torch.autograd.grad(ref, (h2, E2), G)
    assert gE.dtype == torch.bfloat16 and gh.dtype == torch.bfloat16
    if chunk == 1 << 28:
        for a, b in ((lg, ref), (gh, rh), (gE, rE)):
            assert torch.equal(a, b)
        return
    h64, E64, G64 = (_f64(t) for t in (h, E, G))
    h64, G64 = h64.reshape(-1, tc.d_model), G64.reshape(-1, tc.vocab)
    reorder = lambda n, a, b: 2 * n * 2.0 ** -24 * (np.abs(a) @ np.abs(b))
    ulp16 = lambda x: np.spacing(np.abs(x).astype(np.float32)) * 2.0 ** 16
    assert np.all(np.abs(_f64(lg).reshape(h64.shape[0], -1) - _f64(
        ref).reshape(h64.shape[0], -1)) <= reorder(tc.d_model, h64, E64.T))
    # each gradient is a float32 sum rounded to bfloat16: within one
    # bfloat16 ulp of the other's plus the sums' reordering
    for got, want, tol in (
            (gh, rh, reorder(tc.vocab, G64, E64)),
            (gE, rE, reorder(G64.shape[0], G64.T, h64))):
        w64 = _f64(want).reshape(tol.shape)
        assert np.all(np.abs(_f64(got).reshape(tol.shape) - w64)
                      <= ulp16(w64) + tol)
