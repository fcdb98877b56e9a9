"""The port's serving example and 100M training script against the JAX package's
(`examples/serve_recsys.py`, `examples/train_lshmf_100m.py`), on the CPU
at a reduced size (`test_torch_examples.py` says how).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.simlsh import SimLSHConfig as JLSH
from repro.data import synthetic as jsyn
from repro.data.sparse import train_test_split as jsplit
from repro.train import trainer as jtrainer
from test_torch_examples import (SIZE_ARGS, _floats, _load, _report,
                                 _run_jax_example)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_serve_recsys_prints_the_jax_recall(monkeypatch, capsys):
    want = _run_jax_example("serve_recsys", monkeypatch, capsys)
    got = _load("torch_serve_recsys").cli(["--device", "cpu", *SIZE_ARGS])
    out = capsys.readouterr().out
    w = _floats(r"rmse=([\d.]+)", want)[-1]
    assert abs(got["rmse"] - w) <= 1e-4
    (wr,), (gr,) = (_floats(r"recall@10 of candidate-only vs full scoring: "
                            r"([\d.]+)", t) for t in (want, out))
    assert abs(gr - wr) <= 0.02 and gr > 0.5
    for line in ("candidate serving:", "ingested ΔΩ: catalog 80 → 100 items",
                 "post-ingest serving OK"):
        assert line in out and line in want
    assert got["fallbacks"] == 0


def test_serve_recsys_loop_resumes_where_it_stopped(tmp_path, capsys):
    mod = _load("torch_serve_recsys")
    argv = ["--device", "cpu", "--M", "600", "--N", "100", "--nnz", "12000",
            "--online-loop", "--root", str(tmp_path / "loop"), "--report"]
    first = mod.cli([*argv, "--slices", "2"])
    out1 = capsys.readouterr().out
    assert first == dict(first, slices=2, resumed=0)
    assert "fresh run" in out1 and "slice 1:" in out1
    second = mod.cli([*argv, "--slices", "2"])
    out2 = capsys.readouterr().out
    assert second["resumed"] == 2 and second["slices"] == 4
    assert "resumed from" in out2 and "slice 3:" in out2
    assert second["N"] > 60 and _report(out2)["slices"] == 4


def test_train_lshmf_100m_matches_the_jax_fit(tmp_path, capsys):
    """The 100M script at a reduced shape against the JAX `fit` with its
    configuration; ``--resume`` goes on from the newest checkpoint, and
    ``--trace`` writes the port's obs export."""
    M, N, F, K, nnz, epochs = 2000, 300, 16, 8, 20_000, 2
    mod = _load("torch_train_lshmf_100m")
    trace = tmp_path / "trace.json"
    argv = ["--device", "cpu", "--shape", f"{M},{N},{F},{K},{nnz},{epochs}",
            "--ckpt-dir", str(tmp_path / "ck")]
    got = mod.main([*argv, "--trace", str(trace)])
    out = capsys.readouterr().out
    spec = dataclasses.replace(jsyn.MOVIELENS_LIKE, M=M, N=N, nnz=nnz)
    rows, cols, vals, _ = jsyn.generate(spec, seed=0)
    tr, te = jsplit(np.random.default_rng(0), rows, cols, vals)
    want = jtrainer.fit(tr, te, (M, N), jtrainer.FitConfig(
        F=F, K=K, epochs=epochs, batch=8192, method="simlsh",
        lsh=JLSH(G=8, p=1, q=10, band_cap=16), use_kernels=True,
        kernel_impl="ref"))
    np.testing.assert_allclose([h[2] for h in got["history"]],
                               [h[2] for h in want.history], rtol=0,
                               atol=1e-4)
    assert f"M={M:,} N={N:,} F={F} K={K}" in out
    assert "train.epoch" in out and trace.exists()
    assert sorted(p.name for p in (tmp_path / "ck").iterdir())
    # a third epoch goes on from the second's checkpoint
    argv[3] = f"{M},{N},{F},{K},{nnz},{epochs + 1}"
    again = mod.main([*argv, "--resume", "--report"])
    out2 = capsys.readouterr().out
    assert [h[0] for h in again["history"]] == [epochs]
    assert again["rmse"] < got["history"][0][2]
    assert _report(out2)["launches"]["culsh_sgd"] == 0
