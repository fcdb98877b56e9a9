"""Port vs JAX package: the LM side's configs and its dense serving path
(`configs/`, `models/layers.py`, `models/lm.py`, `models/steps.py`'s
serving half, `launch/serve.py`), on the CPU at the reduced configs.

* Every registered config equals the JAX package's field for field, for
  all ten names, and so do `reduced`, `SHAPES`, `runnable` and `cells`.
* On each reduced dense config (llama3-8b, llama3-405b, qwen1.5-0.5b,
  qwen3-0.6b): `init_params` draws the JAX package's streams (the same
  tree and shapes, each float within 4 ulp — `prng.normal`'s contract —
  and ≥ 95 % bit-equal); from the JAX parameters
  (`convert.lm_params_from_numpy`), `forward`, prefill and decode at
  float32 within 1e-4 of the JAX package's.
* `test_lm.py::test_dense_decode_matches_forward` on the port, in
  bfloat16 (the JAX test's 3e-2) and float32 (1e-4).
* `serve`'s greedy tokens equal the JAX `repro.launch.serve.serve`'s
  over 8 steps at float32, from the same parameters and prompts.
* The moe, ssm, hybrid, encdec and vlm families raise
  `NotImplementedError`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JCB
from repro.launch import serve as jserve
from repro.models import lm as jlm
from repro.models import steps as jsteps
from repro_torch import convert, prng
from repro_torch.configs import base as CB
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import lm, steps

NAMES = JCB.names()
DENSE = ("llama3-8b", "llama3-405b", "qwen1.5-0.5b", "qwen3-0.6b")
OTHER = ("arctic-480b", "dbrx-132b", "mamba2-370m", "zamba2-7b",
         "seamless-m4t-large-v2", "llava-next-mistral-7b")
F32 = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _reduced(name, dtype=None):
    j, t = JCB.reduced(JCB.get(name)), CB.reduced(CB.get(name))
    if dtype:
        j, t = (dataclasses.replace(c, dtype=dtype) for c in (j, t))
    return j, t


def _jax_params(jcfg, seed=0):
    return jlm.init_params(jcfg, jax.random.PRNGKey(seed), model_shards=1)


def _port_params(jp):
    return convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                        device="cpu")


def _tokens(cfg, B=2, S=12, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)


def test_names_and_shapes_equal_jax():
    assert CB.names() == NAMES and len(NAMES) == 10
    assert CB.SHAPES == {k: CB.ShapeSpec(**dataclasses.asdict(v))
                         for k, v in JCB.SHAPES.items()}
    assert CB.cells(include_skips=True) == JCB.cells(include_skips=True)
    assert CB.cells() == JCB.cells()


@pytest.mark.parametrize("name", NAMES)
def test_config_equals_jax_field_by_field(name):
    j, t = JCB.get(name), CB.get(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for prop in ("n_heads_padded", "hd", "subquadratic"):
        try:
            want = getattr(j, prop)
        except ZeroDivisionError:            # attention-free: no head dim
            with pytest.raises(ZeroDivisionError):
                getattr(t, prop)
            continue
        assert getattr(t, prop) == want, prop
    for shards in (1, 16, 7):
        assert t.vocab_padded(shards) == j.vocab_padded(shards)
    assert dataclasses.asdict(CB.reduced(t)) == dataclasses.asdict(
        JCB.reduced(j))
    for s in JCB.SHAPES.values():
        assert CB.runnable(t, CB.SHAPES[s.name]) == JCB.runnable(j, s)


@pytest.mark.parametrize("name", DENSE)
def test_init_params_draws_the_jax_streams(name):
    jcfg, tcfg = _reduced(name)
    jp = _jax_params(jcfg, seed=3)
    tp = lm.init_params(tcfg, prng.PRNGKey(3), model_shards=1, device="cpu")
    jl, jdef = jax.tree.flatten(jax.tree.map(np.asarray, jp))
    tl, tdef = jax.tree.flatten(jax.tree.map(lambda a: a.numpy(), tp))
    assert tdef == jdef
    same = []
    for a, b in zip(tl, jl):
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
        np.testing.assert_array_max_ulp(a, b, maxulp=4)
        same.append((a == b).ravel())
    assert np.concatenate(same).mean() > 0.95


@pytest.mark.parametrize("name", DENSE)
def test_forward_prefill_and_decode_match_jax_at_float32(name):
    jcfg, tcfg = _reduced(name, "float32")
    jp = _jax_params(jcfg)
    tp = _port_params(jp)
    toks = _tokens(tcfg, S=80)           # more than one query chunk (64)
    h = lm.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    jh = jlm.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    assert h.dtype == torch.float32
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **F32)
    logits, cache = steps.make_prefill(tcfg)(
        tp, {"tokens": torch.from_numpy(toks)})
    jlogits, jcache = jsteps.make_prefill(jcfg)(jp,
                                                {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **F32)
    assert cache["pos"] == int(jcache["pos"]) == 80
    for k in ("k", "v"):
        assert cache[k].dtype == torch.bfloat16
        np.testing.assert_allclose(cache[k].float().numpy(),
                                   np.asarray(jcache[k], np.float32),
                                   rtol=1e-2, atol=1e-2)
    # three decode steps on a fresh cache
    tc = steps.init_cache(tcfg, 2, 8, device="cpu")
    jc = jsteps.init_cache(jcfg, 2, 8)
    dec, jdec = steps.make_decode_step(tcfg), jsteps.make_decode_step(jcfg)
    for t in range(3):
        lg, tc = dec(tp, tc, torch.from_numpy(toks[:, t:t + 1]))
        jlg, jc = jdec(jp, jc, jnp.asarray(toks[:, t:t + 1]))
        assert lg.shape == tuple(jlg.shape) == (2, 1, tcfg.vocab_padded(1))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **F32)
    assert tc["pos"] == int(jc["pos"]) == 3
    np.testing.assert_allclose(tc["k"].float().numpy(),
                               np.asarray(jc["k"], np.float32), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 3e-2), ("float32", 1e-4)])
def test_dense_decode_matches_forward(dtype, tol):
    """`tests/test_lm.py::test_dense_decode_matches_forward` on the port:
    token-by-token decode logits equal the full forward's (the cache
    logic), in both compute dtypes; the cache is kept in the compute
    dtype (a bfloat16 cache under float32 compute moves the logits by
    ~2e-3)."""
    _, cfg = _reduced("llama3-8b", dtype)
    p = lm.init_params(cfg, prng.PRNGKey(0), model_shards=1, device="cpu")
    B, S = 2, 12
    toks = torch.from_numpy(_tokens(cfg, B, S))
    h = lm.forward(cfg, p, {"tokens": toks})
    full_logits = steps.logits_of(cfg, p, h)
    dec = steps.make_decode_step(cfg)
    cache = steps.init_cache(cfg, B, S, dtype=getattr(torch, dtype),
                             device="cpu")
    outs = []
    for t in range(S):
        lg, cache = dec(p, cache, toks[:, t:t + 1])
        outs.append(lg[:, 0])
    got = torch.stack(outs, dim=1)
    np.testing.assert_allclose(got.numpy(), full_logits.detach().numpy(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("name", ["llama3-8b", "qwen3-0.6b"])
def test_serve_greedy_tokens_equal_jax(name):
    jcfg, tcfg = _reduced(name, "float32")
    jp = _jax_params(jcfg, seed=1)
    logs = []
    want, jstats = jserve.serve(jcfg, batch=2, prompt_len=16, gen=8, seed=1,
                                log=logs.append)
    got, stats = tserve.serve(tcfg, batch=2, prompt_len=16, gen=8, seed=1,
                              log=logs.append, device="cpu",
                              params=_port_params(jp))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (2, 9) and got.dtype == torch.int32
    assert set(stats) >= {"prefill_s", "decode_s", "tok_per_s"}
    assert len(logs) == 2 and "tok/s batched" in logs[1]


def test_serve_cli_runs_reduced_on_the_cpu(capsys):
    toks, stats = tserve.main(["--arch", "qwen1.5-0.5b", "--reduced",
                               "--batch", "2", "--prompt-len", "8",
                               "--gen", "4", "--device", "cpu"])
    assert toks.shape == (2, 5) and stats["tok_per_s"] > 0
    assert "tok/s batched" in capsys.readouterr().out


@pytest.mark.parametrize("name", OTHER)
def test_other_families_raise(name):
    cfg = CB.reduced(CB.get(name))
    key = prng.PRNGKey(0)
    for call in (lambda: lm.init_params(cfg, key, 1, device="cpu"),
                 lambda: lm.forward(cfg, {}, {"tokens": torch.zeros(
                     (1, 1), dtype=torch.int32)}),
                 lambda: steps.init_cache(cfg, 1, 4, device="cpu"),
                 lambda: steps.make_decode_step(cfg),
                 lambda: steps.make_prefill(cfg),
                 lambda: steps.make_train_step(cfg),
                 lambda: tserve.serve(cfg, batch=1, prompt_len=2, gen=1,
                                      device="cpu"),
                 lambda: ttrain.train_loop(cfg, steps_n=1, batch=1, seq=2,
                                           device="cpu")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()


def test_lm_params_from_numpy_keeps_the_tree():
    jcfg, _ = _reduced("qwen1.5-0.5b")
    jp = _jax_params(jcfg)
    tp = _port_params(jp)
    assert sorted(tp) == sorted(jp) and sorted(tp["layers"]) == sorted(
        jp["layers"])
    np.testing.assert_array_equal(tp["layers"]["wq"].numpy(),
                                  np.asarray(jp["layers"]["wq"]))
    half = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                        device="cpu", dtype="bfloat16")
    assert half["embed"].dtype == torch.bfloat16


def test_serve_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.serve(CB.reduced(CB.get("llama3-8b")), batch=1, prompt_len=2,
                     gen=1)
