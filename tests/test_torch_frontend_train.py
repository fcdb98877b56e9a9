"""Port vs JAX package: training the encdec (seamless-m4t-large-v2) and
vlm (llava-next-mistral-7b) families, on the CPU at their reduced
configs, float32 unless a case says otherwise.  Their loss, gradients,
Adam and one-step smoke cases sit with the other families' in
`test_torch_lm_train.py`; here:

* remat on and off give bit-equal gradients for every leaf (encdec's
  encoder output is captured by each rematerialised decoder layer, so
  its gradient is the sum of the L layers' cross K/V products), in both
  dtypes;
* the ``(params, opt)`` trees match the JAX package's path for path —
  ``dec_cross`` holds the attention leaves alone, as the reference keeps
  them — and a checkpoint written by either package restores in the
  other leaf for leaf;
* `make_train_step`: llava at µ = 2 with ``mb_mask`` [1, 1] and [1, 0]
  (``frontend_embeds`` split with the tokens), seamless at µ = 1 and
  µ = 2, through the first moment (= (1 − b1)·scale·g);
* `train_loop`: five steps' losses within 1e-4 of the JAX loop's, and
  each package's step-5 checkpoint restored in the other;
* `synth_batch` bit-equal to the JAX draw for two consecutive batches
  (encdec draws the 16 patches and then its frames, keeping the frames);
* the CLI for each family.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import train as jtrain
from repro.models import lm as jlm
from repro.models import steps as jsteps
from repro.train import checkpoint as jckpt
from repro_torch import convert, prng
from repro_torch import tree as T
from repro_torch.configs import base as CB
from repro_torch.launch import train as ttrain
from repro_torch.models import lm, steps
from repro_torch.train import checkpoint as ckpt
from test_torch_lm_train import (FRONTEND, _batch, _both, _cfgs, _np_leaves,
                                 _port, _step_pair, _t_leaves,
                                 assert_grads_close)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_paths(tree):
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)
            for path, _ in jax.tree_util.tree_leaves_with_path(tree)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", FRONTEND)
def test_frontend_remat_changes_no_gradient(name, dtype):
    """Every gradient leaf — ``enc``, ``dec``, ``dec_cross``,
    ``enc_norm``, ``embed``, ``out_embed``; vlm's ``layers`` — and the
    loss bit for bit with each layer rematerialised and without."""
    _, tc = _cfgs(name, dtype=dtype)
    assert tc.remat
    p = lm.init_params(tc, prng.PRNGKey(3), model_shards=1, device="cpu")
    _, tb = _both(_batch(tc, mask=True))
    l1, g1 = steps.value_and_grad(tc, p, tb)
    l0, g0 = steps.value_and_grad(dataclasses.replace(tc, remat=False), p, tb)
    assert float(l1) == float(l0)
    paths = [q for q, _ in T.leaves_with_paths(g1)]
    if tc.family == "encdec":
        assert {"enc/wq", "dec/w1", "dec_cross/wk", "enc_norm", "embed",
                "out_embed"} <= set(paths)
    for path, a, b in zip(paths, T.leaves(g1), T.leaves(g0)):
        assert bool(b.abs().max() > 0), path
        assert torch.equal(a, b), path


@pytest.mark.parametrize("name", FRONTEND)
def test_frontend_trees_match_jax_leaf_for_leaf(name, tmp_path):
    """The parameter and Adam trees have the JAX package's paths in its
    order (``dec_cross`` without ``w1`` / ``w3`` / ``w2`` in both), so the
    checkpoint leaves ``a0, a1, …`` name the same tensors: a state written
    by either package restores in the other bit for bit."""
    jc, tc = _cfgs(name)
    jp = jlm.init_params(jc, jax.random.PRNGKey(0), model_shards=1)
    tp = lm.init_params(tc, prng.PRNGKey(0), model_shards=1, device="cpu")
    assert [q for q, _ in T.leaves_with_paths(tp)] == _jax_paths(jp)
    if tc.family == "encdec":
        assert sorted(tp["dec_cross"]) == sorted(jp["dec_cross"]) == [
            "ln1", "wk", "wo", "wq", "wv"]
    # a state with distinct moments: one JAX Adam step of random grads
    rng = np.random.default_rng(0)
    g = jax.tree.map(lambda x: jnp.asarray(rng.normal(
        0, 1e-2, x.shape).astype(np.float32)), jp)
    jp1, jo1, _ = jsteps.adam_update(jc, jp, g, jsteps.init_opt(jc, jp))
    tp1 = _port(jp1)
    to1 = convert.lm_opt_from_numpy(jax.tree.map(np.asarray, jo1),
                                    device="cpu")
    assert [q for q, _ in T.leaves_with_paths((tp1, to1))] == _jax_paths(
        (jp1, jo1))
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    jckpt.save(jd, (jp1, jo1), step=1, sync=True)
    ckpt.save(td, (tp1, to1), step=1, sync=True)
    like = (tp, steps.init_opt(tc, tp))
    got, step = ckpt.restore(jd, like)
    assert step == 1
    for a, b in zip(T.leaves(got), jax.tree.leaves((jp1, jo1))):
        assert a.dtype == getattr(torch, str(b.dtype))
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back, step = jckpt.restore(td, (jp, jsteps.init_opt(jc, jp)))
    for a, b in zip(jax.tree.leaves(back), T.leaves((tp1, to1))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("name,mb_mask", [
    ("llava-next-mistral-7b", [1.0, 1.0]),
    ("llava-next-mistral-7b", [1.0, 0.0]),
    ("seamless-m4t-large-v2", None),
    ("seamless-m4t-large-v2", [0.0, 1.0])])
def test_frontend_train_step_matches_jax(name, mb_mask):
    """One `make_train_step`: the loss and the norm within 1e-5, the
    accumulated gradient (the first moment) within 1e-5 of each leaf's
    max.  At µ = 2 ``frontend_embeds`` [4, P, D] is split with the tokens
    and labels, as the reference splits every batch entry whose leading
    dim is a multiple of µ."""
    cfgs = _cfgs(name, microbatches=1 if mb_mask is None else 2)
    jp = jlm.init_params(cfgs[0], jax.random.PRNGKey(2), model_shards=1)
    b = _batch(cfgs[1], B=4, S=16)
    assert b["frontend_embeds"].shape[0] == 4
    if mb_mask is not None:
        b["mb_mask"] = np.asarray(mb_mask, np.float32)
    (jaux, jo1), (taux, to1) = _step_pair(cfgs, jp, b)
    np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(taux["gnorm"]), float(jaux["gnorm"]),
                               rtol=1e-5)
    assert int(to1["count"]) == 1
    assert_grads_close(_t_leaves(to1["m"]), _np_leaves(jo1["m"]),
                       floor=1e-8)
    if mb_mask is not None and 0.0 in mb_mask:
        # the dropped microbatch's frames or patches change nothing
        keep = mb_mask.index(1.0)
        one = dataclasses.replace(cfgs[1], microbatches=1)
        _, tb = _both({k: v[2 * keep:2 * keep + 2] for k, v in b.items()
                       if k != "mb_mask"})
        np.testing.assert_allclose(float(taux["loss"]), float(
            steps.lm_loss(one, _port(jp), tb)), rtol=1e-6)


@pytest.mark.parametrize("name", FRONTEND)
def test_frontend_train_loop_matches_jax(name, tmp_path):
    """Five `train_loop` steps (batches with the reference's stub
    frontend draws) within 1e-4 of the JAX loop's losses; each package's
    step-5 ``(params, opt)`` checkpoint restores in the other leaf for
    leaf; the loss falls."""
    jc, tc = _cfgs(name)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    kw = dict(steps_n=5, batch=4, seq=32, lr=3e-4, log=lambda s: None)
    jp, jo, jl = jtrain.train_loop(jc, ckpt_dir=jd, **kw)
    tp, to, tl = ttrain.train_loop(tc, ckpt_dir=td, device="cpu", **kw)
    assert len(tl) == 5 and int(to["count"]) == 5
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    assert tl[-1] < tl[0]
    got, step = ckpt.restore(jd, (tp, to))
    assert step == 5
    for a, b in zip(T.leaves(got), jax.tree.leaves((jp, jo))):
        assert isinstance(a, torch.Tensor) and a.dtype == getattr(
            torch, str(b.dtype))
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back, step = jckpt.restore(td, (jp, jo))
    assert step == 5
    for a, b in zip(jax.tree.leaves(back), T.leaves((tp, to))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("name", FRONTEND)
def test_synth_batch_draws_the_jax_frontend(name):
    """Two consecutive batches from one generator: ``tokens``, ``labels``
    and ``frontend_embeds`` bit-equal to the JAX package's — encdec's
    frames [B, seq, D] drawn after 16 patches it drops, vlm's 16 patches
    [B, 16, D] —, so the generator advances alike and the second batch
    still matches."""
    cfg = CB.reduced(CB.get(name))
    rt, rj = np.random.default_rng(4), np.random.default_rng(4)
    P = 24 if cfg.family == "encdec" else ttrain.FRONTEND_PATCHES
    for _ in range(2):
        got = ttrain.synth_batch(rt, cfg, 3, 24)
        want = jtrain.synth_batch(rj, cfg, 3, 24)
        assert sorted(got) == sorted(want) == ["frontend_embeds", "labels",
                                               "tokens"]
        assert got["frontend_embeds"].shape == (3, P, cfg.d_model)
        assert got["frontend_embeds"].dtype == torch.float32
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # the next draw of each generator: equal only if both advanced alike
    assert rt.random() == rj.random()


@pytest.mark.parametrize("arch", FRONTEND)
def test_train_cli_runs_the_frontend_families(arch, tmp_path, capsys):
    """``--arch seamless-m4t-large-v2`` / ``llava-next-mistral-7b``
    ``--reduced --device cpu`` train from the CLI with a checkpoint each
    step, and a rerun resumes from the last one."""
    argv = ["--arch", arch, "--reduced", "--steps", "2", "--batch", "2",
            "--seq", "16", "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "1"]
    losses = ttrain.main(argv)
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert "final loss" in capsys.readouterr().out
    assert ckpt.latest_step(str(tmp_path)) == 2
    more = ttrain.main(argv[:4] + ["3"] + argv[5:])
    assert len(more) == 1 and "resumed from step 2" in \
        capsys.readouterr().out
