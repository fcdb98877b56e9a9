"""The port's examples (`examples/torch_*.py`) against the JAX package's
(`examples/*.py`), on the CPU at a reduced size: the quickstart, online
learning and LM training here, the serving example and the 100M training
script in `test_torch_examples_serve.py`.

Each port example's `main` runs with ``--device cpu`` (its kernels'
plain versions; the serving example's service runs the plain walk there,
as the JAX package's does).  The JAX example's own `main` runs at the
same size (its `dataclasses.replace` of the dataset spec is redirected
to the reduced shape), and the printed test RMSE must agree to the last
printed digit (≤ 1e-4: `test_torch_train_fit.py`'s fit tolerance) and
the printed recall@10 within 0.02.  The 100M training script is held
against the JAX `fit` with that script's configuration (the JAX example
writes its checkpoints to a fixed path); the loop demo against itself: a
second invocation resumes where the first stopped.
"""
import dataclasses
import importlib.util
import json
import pathlib
import re
import sys
import types

import numpy as np
import pytest
import torch

from repro.data import synthetic as jsyn

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(M=300, N=80, nnz=6000)
SIZE_ARGS = ["--M", "300", "--N", "80", "--nnz", "6000"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_example(name, monkeypatch, capsys, shape=SMALL, argv=()):
    """The JAX example's `main`, its dataset spec cut to ``shape``."""
    mod = _load(name)

    def replace(obj, **kw):
        if isinstance(obj, jsyn.DatasetSpec):
            kw = dict(kw, **shape)
        return dataclasses.replace(obj, **kw)

    monkeypatch.setattr(mod, "dataclasses",
                        types.SimpleNamespace(replace=replace))
    monkeypatch.setattr(sys, "argv", [name, *argv])
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out


def _floats(pattern, text):
    return [float(x) for x in re.findall(pattern, text)]


def _report(out):
    lines = [ln for ln in out.splitlines() if ln.startswith("report ")]
    assert len(lines) == 1
    return json.loads(lines[0][len("report "):])


def test_quickstart_prints_the_jax_rmse(monkeypatch, capsys):
    want = _run_jax_example("quickstart", monkeypatch, capsys)
    got = _load("torch_quickstart").main(
        ["--device", "cpu", *SIZE_ARGS, "--report"])
    out = capsys.readouterr().out
    w = _floats(r"rmse=([\d.]+)", want)
    g = _floats(r"rmse=([\d.]+)", out)
    assert len(g) == len(w) == 8
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 + 1e-9)
    assert abs(got["rmse"] - w[-1]) <= 1e-4
    assert "neighbour search took" in out
    assert _report(out)["launches"]["culsh_sgd"] == 0     # plain on the CPU


def test_online_learning_prints_the_jax_rmse(monkeypatch, capsys):
    """The update evaluates on the whole test split, including triples of
    users and items the base fit never saw (their ids clamp, as in the
    JAX package's gathers)."""
    want = _run_jax_example("online_learning", monkeypatch, capsys)
    got = _load("torch_online_learning").main(
        ["--device", "cpu", *SIZE_ARGS])
    out = capsys.readouterr().out
    (w,), (g,) = (_floats(r"→ rmse ([\d.]+)", t) for t in (want, out))
    assert abs(g - w) <= 1e-4 + 1e-9 and abs(got["rmse"] - w) <= 1e-4
    assert re.search(r"([\d,]+) new interactions", out).group(1) == \
        re.search(r"([\d,]+) new interactions", want).group(1)
    assert got["state"].M == SMALL["M"] and got["state"].N == SMALL["N"]


def test_examples_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("torch_quickstart", "torch_online_learning",
                 "torch_train_lshmf_100m", "torch_train_lm"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            _load(name).main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _load("torch_serve_recsys").cli([])


def test_fit_evaluates_ids_past_the_world_like_jax():
    """Test triples of users and items the fit never saw (ids ≥ M, N):
    the JAX gathers clamp them to the last row and their neighbour
    lookups miss; the port's `fit` evaluation and `model.rmse` do the
    same (they raised `IndexError` before)."""
    from repro.core.simlsh import SimLSHConfig as JLSH
    from repro.data.sparse import train_test_split as jsplit
    from repro.train import trainer as jtrainer
    from repro_torch.core import model
    from repro_torch.core.simlsh import SimLSHConfig
    from repro_torch.data.sparse import from_coo
    from repro_torch.train import trainer
    spec = dataclasses.replace(jsyn.MOVIELENS_LIKE, **SMALL)
    rows, cols, vals, _ = jsyn.generate(spec, seed=0)
    (r, c, v), te = jsplit(np.random.default_rng(0), rows, cols, vals)
    M0, N0 = SMALL["M"] - 20, SMALL["N"] - 8
    old = (r < M0) & (c < N0)
    tr = (r[old], c[old], v[old])
    assert (te[0] >= M0).any() and (te[1] >= N0).any()
    kw = dict(F=8, K=4, epochs=2, method="simlsh", use_kernels=True,
              eval_every=1)
    want = jtrainer.fit(tr, te, (M0, N0), jtrainer.FitConfig(
        lsh=JLSH(G=8, p=1, q=10, band_cap=16), kernel_impl="ref", **kw))
    got = trainer.fit(tr, te, (M0, N0), trainer.FitConfig(
        lsh=SimLSHConfig(G=8, p=1, q=10, band_cap=16), **kw), device="cpu")
    np.testing.assert_allclose([h[2] for h in got.history],
                               [h[2] for h in want.history], rtol=0,
                               atol=1e-4)
    sp = from_coo(*tr, (M0, N0), device="cpu")
    legacy = float(model.rmse(got.params, sp, got.JK,
                              *(torch.from_numpy(np.asarray(a)) for a in te)))
    assert abs(legacy - got.history[-1][2]) < 1e-5


@pytest.mark.parametrize("argv", [
    ["--steps", "3"], ["--steps", "11", "--lsh-softmax"],
    ["--steps", "3", "--arch", "dbrx-132b"],
    ["--steps", "3", "--arch", "seamless-m4t-large-v2"],
    ["--steps", "3", "--arch", "llava-next-mistral-7b"]])
def test_train_lm_prints_the_jax_losses(monkeypatch, capsys, argv):
    """`examples/torch_train_lm.py` in both arms, and for the moe, encdec
    and vlm families (the last two on the reference's stub frame and
    patch draws), against the JAX example's printed losses (the reduced
    config's bfloat16 compute: within 2⁻⁸ of the loss, one bfloat16 unit
    roundoff)."""
    pattern = r"(?:→|loss) (\d+\.\d+)"
    monkeypatch.setattr(sys, "argv", ["train_lm", *argv])
    capsys.readouterr()
    _load("train_lm").main()
    want = _floats(pattern, capsys.readouterr().out)
    got = _load("torch_train_lm").main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out
    printed = _floats(pattern, out)
    assert len(want) == len(printed) >= 2
    np.testing.assert_allclose(printed, want, rtol=2 ** -8)
    assert printed[-1] == float(f"{got[-1]:.3f}") and len(got) == int(argv[1])
