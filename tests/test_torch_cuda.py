"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a card (decided in
the ``cuda`` fixture, while the test runs).  The file imports no JAX, so
it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

`lsh_retrieve` must equal its plain version bit for bit;
`candidate_score` within rtol/atol 1e-5 with equal indices wherever
neighbouring top-N scores differ by more than 1e-5 (summation order);
`culsh_sgd_step` and `mf_sgd_step` within rtol 1e-5 / atol 1e-6 (the JAX
package's kernel tolerance, `tests/test_kernels.py`), with invalid rows
bit for bit unchanged.
"""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch import convert, prng
from repro_torch.core import model, sgd, simlsh
from repro_torch.data import synthetic
from repro_torch.data.sparse import from_coo, train_test_split
from repro_torch.kernels.candidate_score import kernel as score_kernel
from repro_torch.kernels.candidate_score.ref import (assert_topn_close,
                                                    candidate_score_topn_ref)
from repro_torch.kernels.lsh_retrieve import kernel as lsh_kernel
from repro_torch.kernels.lsh_retrieve.ref import lsh_retrieve_topc_ref
from repro_torch.kernels.mf_sgd import kernel as sgd_kernel
from repro_torch.kernels.mf_sgd.ops import apply_culsh_sgd, culsh_hyper
from repro_torch.kernels.mf_sgd.ref import culsh_sgd_step_ref, mf_sgd_step_ref
from repro_torch.serve import (RecsysService, ServeConfig, build_index,
                               insert, padded_flat_ids, seed_items,
                               tail_hits, window_slices)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from chip_smoke import make_catalog  # noqa: E402  (the smoke's catalog)

SENTINEL = 2 ** 31 - 1
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """The card, or a skip: decided while the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _state(N=1500, seed=0):
    """A small planted catalog (`chip_smoke.make_catalog` at F = 16),
    encoded and indexed by the port on the CPU."""
    U, V, bh, rows, cols, vals, M = make_catalog(N, "cpu", seed=seed, F=16)
    z = np.zeros((N, 1))
    params = convert.params_from_numpy(U, V, np.zeros(M), bh, z, z, 3.0,
                                       device="cpu")
    sp = from_coo(rows, cols, vals, (M, N), device="cpu")
    sigs = simlsh.encode(sp, simlsh.SimLSHConfig(G=8, p=2, q=10),
                         prng.PRNGKey(seed))
    return params, sp, sigs, build_index(sigs, tail_cap=32, device="cpu")


def _plane_args(B, C, F, N, rng, mask_p=0.7):
    return (torch.tensor(rng.normal(size=(B, F + 1)), dtype=torch.float32),
            torch.tensor(rng.normal(size=(N, F + 1)), dtype=torch.float32),
            torch.tensor(rng.integers(0, N, (B, C)), dtype=torch.int32),
            torch.tensor(rng.random((B, C)) < mask_p, dtype=torch.float32))


@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("n_seeds,cap,C,excl", [
    (4, 8, 32, ()), (8, 4, 64, (1, 9)), (2, 16, 24, (SENTINEL,)),
    (16, 8, 704, tuple(range(0, 640, 10)))])
def test_lsh_retrieve_kernel_equals_plain(cuda, tail, n_seeds, cap, C, excl):
    _, sp, sigs, index = _state()
    if tail:
        index = insert(index, sigs[:, :20], torch.arange(1500, 1520))
    users = torch.arange(0, 960, 40, dtype=torch.int32)
    seeds = seed_items(sp, users, n_seeds=n_seeds, window=64)
    starts, lens = window_slices(index, seeds, cap=cap)
    extra = (tail_hits(index, seeds) if tail else
             torch.full((users.shape[0], 1), SENTINEL, dtype=torch.int32))
    exclude = torch.tensor(list(excl) or [SENTINEL], dtype=torch.int32)
    ops = [x.to(cuda) for x in (starts, lens, extra,
                                padded_flat_ids(index, cap=cap), exclude)]
    C = min(C, starts.shape[1] * cap + extra.shape[1])
    before = lsh_kernel.LAUNCHES
    got = lsh_kernel.lsh_retrieve_topc(*ops, C=C, cap=cap)
    torch.cuda.synchronize()
    assert lsh_kernel.LAUNCHES == before + 1
    assert torch.equal(got, lsh_retrieve_topc_ref(*ops, C=C, cap=cap))
    assert torch.equal(got.cpu(), lsh_retrieve_topc_ref(
        *(x.cpu() for x in ops), C=C, cap=cap))


@pytest.mark.parametrize("B,C,F,topn", [(32, 64, 16, 10), (7, 33, 8, 5),
                                        (250, 768, 48, 10), (9, 16, 8, 16)])
def test_candidate_score_kernel_equals_plain(cuda, B, C, F, topn):
    ops = [x.to(cuda) for x in _plane_args(B, C, F, 300,
                                           np.random.default_rng(B + C))]
    before = score_kernel.LAUNCHES
    s, i = score_kernel.candidate_score_topn(*ops, topn=topn)
    torch.cuda.synchronize()
    assert score_kernel.LAUNCHES == before + 1
    assert_topn_close(s, i, *candidate_score_topn_ref(*ops, topn=topn))


def test_candidate_score_kernel_all_masked_and_tied(cuda):
    urow, plane, cand, mask = _plane_args(12, 40, 8, 6,
                                          np.random.default_rng(3))
    mask[:4] = 0                                  # all-masked rows
    ops = [x.to(cuda) for x in (urow, plane, cand, mask)]
    s, i = score_kernel.candidate_score_topn(*ops, topn=12)
    s_w, i_w = candidate_score_topn_ref(*ops, topn=12)
    assert torch.equal(i[:4], i_w[:4]) and torch.equal(s[:4], s_w[:4])
    assert_topn_close(s, i, s_w, i_w)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((4, 3), dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        lsh_kernel.lsh_retrieve_topc(x, x, x, x[0], x[0], C=2, cap=1)
    f = torch.zeros((4, 5), device=cuda)
    i = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        score_kernel.candidate_score_topn(f, f.t(), i, i.float(), topn=2)
    narrow = i[:, :4].float().contiguous()
    with pytest.raises(ValueError, match="disagree"):
        score_kernel.candidate_score_topn(f, f, i, narrow, topn=2)
    with pytest.raises(ValueError, match="topn"):
        score_kernel.candidate_score_topn(f, f, i, i.float(), topn=9)


def test_service_on_card_launches_both_kernels_and_matches_cpu(cuda):
    params, sp, _, index = _state()
    cfg = ServeConfig(topn=10, micro_batch=64, C=128, n_seeds=8, cap=8,
                      n_popular=16, tile_b=8, band_budget=256)
    users = np.arange(0, 960, 3, dtype=np.int32)
    out = {}
    for dev in ("cpu", "cuda"):
        svc = RecsysService(params, index, sp, cfg, device=dev)
        before = (lsh_kernel.LAUNCHES, score_kernel.LAUNCHES)
        svc.warmup()
        svc.submit(users)
        svc.flush()
        res = svc.take_results()
        out[dev] = (np.concatenate([r[1] for r in res]),
                    np.concatenate([r[2] for r in res]))
        n = (lsh_kernel.LAUNCHES - before[0], score_kernel.LAUNCHES - before[1])
        want = svc.stats()["batches"] + 1 if dev == "cuda" else 0
        assert n == (want, want)                  # + the warmup flush
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5,
                               atol=1e-5)
    assert (out["cuda"][1] == out["cpu"][1]).mean() > 0.99


# ------------------------------------------------------------ fused SGD steps

def culsh_args(B, F, K, rng):
    """Packed-plane operands of `culsh_sgd_step` (`tests/test_kernels.py::
    _culsh_args`): row, col, rnb, bh_nb, expl, r, valid (about half the
    rows invalid), hp[13]."""
    a = lambda *s: torch.tensor(rng.normal(size=s), dtype=torch.float32)
    expl = torch.tensor(rng.integers(0, 2, (B, K)), dtype=torch.float32)
    valid = torch.tensor(rng.integers(0, 2, B), dtype=torch.float32)
    hp = torch.cat([a(12).abs() * 0.05, a(1) * 0.1])
    return [a(B, F + 1), a(B, F + 2 * K + 1), a(B, K), a(B, K), expl, a(B),
            valid, hp]


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bce", [False, True])
@pytest.mark.parametrize("B,F,K", [(512, 128, 64), (7, 128, 64),
                                   (250, 128, 64), (24, 8, 4), (33, 40, 5)])
def test_culsh_sgd_kernel_equals_plain(cuda, B, F, K, bce):
    args = [x.to(cuda) for x in culsh_args(B, F, K,
                                          np.random.default_rng(B + F))]
    before = sgd_kernel.CULSH_LAUNCHES
    got = sgd_kernel.culsh_sgd_step(*args, bce=bce)
    torch.cuda.synchronize()
    assert sgd_kernel.CULSH_LAUNCHES == before + 1
    _close(got, culsh_sgd_step_ref(*args, bce=bce))
    off = args[6] == 0                       # invalid rows: bit for bit
    assert torch.equal(got[0][off], args[0][off])
    assert torch.equal(got[1][off], args[1][off])


@pytest.mark.parametrize("bce", [False, True])
@pytest.mark.parametrize("B,F", [(512, 128), (7, 128), (250, 128), (9, 40)])
def test_mf_sgd_kernel_equals_plain(cuda, B, F, bce):
    rng = np.random.default_rng(B * 3 + F)
    a = lambda *s: torch.tensor(rng.normal(size=s), dtype=torch.float32,
                                device=cuda)
    valid = torch.tensor(rng.integers(0, 2, B), dtype=torch.float32,
                         device=cuda)
    hp = torch.tensor([0.02, 0.03, 0.01, 0.02], device=cuda)
    args = (a(B, F), a(B, F), a(B), valid, hp)
    before = sgd_kernel.MF_LAUNCHES
    got = sgd_kernel.mf_sgd_step(*args, bce=bce)
    torch.cuda.synchronize()
    assert sgd_kernel.MF_LAUNCHES == before + 1
    _close(got, mf_sgd_step_ref(*args, bce=bce))
    off = valid == 0
    assert torch.equal(got[0][off], args[0][off])
    assert torch.equal(got[1][off], args[1][off])
    assert bool((got[2][off] == 0).all())


def test_sgd_kernels_all_invalid_rows_are_copies(cuda):
    args = [x.to(cuda) for x in culsh_args(64, 128, 64,
                                          np.random.default_rng(1))]
    args[6] = torch.zeros_like(args[6])
    row2, col2 = sgd_kernel.culsh_sgd_step(*args)
    assert torch.equal(row2, args[0]) and torch.equal(col2, args[1])
    u = args[0][:, :128].contiguous()
    u2, v2, e = sgd_kernel.mf_sgd_step(u, u, args[5], args[6],
                                       torch.full((4,), 0.1, device=cuda))
    assert torch.equal(u2, u) and torch.equal(v2, u)
    assert bool((e == 0).all())


def test_culsh_step_padding_slots_repeating_live_ids_add_nothing(cuda):
    """A schedule window reads past its batch's fill: an invalid slot may
    carry the i and j of a valid one.  Its delta must be exactly 0, so
    the planes equal those of the batch without the padding slots."""
    rng = np.random.default_rng(4)
    M, N, F, K, B = 40, 30, 128, 64, 12
    a = lambda *s: torch.tensor(rng.normal(size=s), dtype=torch.float32)
    pp0 = model.PackedParams(row=a(M, F + 1), col=a(N, F + 2 * K + 1),
                             mu=torch.tensor(3.5), F=F, K=K)
    i = torch.tensor(rng.permutation(M)[:B], dtype=torch.int32)
    j = torch.tensor(rng.permutation(N)[:B], dtype=torch.int32)
    nb = torch.tensor(rng.integers(0, N, (B, K)), dtype=torch.int32)
    nb[0, :4] = j[1]                 # a neighbour col that is another j
    expl = torch.tensor(rng.integers(0, 2, (B, K)), dtype=torch.float32)
    valid = torch.ones(B)
    pad = [8, 9, 10, 11]
    i[pad] = i[:4].clone()           # padding repeats live ids
    j[pad] = j[:4].clone()
    valid[pad] = 0.0
    bt = model.Batch(i, j, a(B), nb, a(B, K), expl, 1.0 - expl, valid)
    live = model.Batch(*(getattr(bt, f.name)[:8]
                         for f in dataclasses.fields(bt)))
    hpv = culsh_hyper(sgd.Hyper(), 0.9, pp0.mu)
    to = lambda x, d: dataclasses.replace(x, **{
        f.name: getattr(x, f.name).to(d) for f in dataclasses.fields(x)
        if isinstance(getattr(x, f.name), torch.Tensor)})
    got = apply_culsh_sgd(to(pp0, cuda), to(bt, cuda), hpv.to(cuda),
                          impl="cuda")
    want = apply_culsh_sgd(to(pp0, cuda), to(live, cuda), hpv.to(cuda),
                           impl="cuda")
    assert torch.equal(got.row, want.row) and torch.equal(got.col, want.col)
    plain = apply_culsh_sgd(to(pp0, "cpu"), bt, hpv, impl="ref")
    np.testing.assert_allclose(got.col.cpu().numpy(), plain.col.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_fit_on_card_launches_the_culsh_kernel_per_cf_step(cuda):
    from repro_torch.train.trainer import FitConfig, fit
    spec = dataclasses.replace(synthetic.MOVIELENS_LIKE, M=300, N=90,
                               nnz=4000)
    rows, cols, vals, _ = synthetic.generate(spec, seed=0)
    tr, te = train_test_split(np.random.default_rng(0), rows, cols, vals)
    cfg = FitConfig(F=16, K=8, epochs=2, cf_batch=64, use_kernels=True,
                    lsh=simlsh.SimLSHConfig(G=8, p=1, q=10, band_cap=16))
    before = sgd_kernel.CULSH_LAUNCHES
    res = fit(tr, te, (spec.M, spec.N), cfg)
    n = sgd_kernel.CULSH_LAUNCHES - before
    assert n == res.schedule_stats["nb_cf"] * cfg.epochs
    assert res.params.U.device.type == "cuda"
    cpu = fit(tr, te, (spec.M, spec.N), cfg, device="cpu")
    for (_, _, a), (_, _, b) in zip(res.history, cpu.history):
        assert abs(a - b) < 1e-4


def test_sgd_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    args = [x.to(cuda) for x in culsh_args(8, 8, 4,
                                          np.random.default_rng(0))]
    with pytest.raises(ValueError, match="disagree"):
        sgd_kernel.culsh_sgd_step(args[0], args[1][:, :-1].contiguous(),
                                  *args[2:])
    with pytest.raises(TypeError):
        sgd_kernel.culsh_sgd_step(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        sgd_kernel.mf_sgd_step(args[0], args[0].t(), args[5], args[6],
                               args[7][:4])
    with pytest.raises(ValueError, match="hp"):
        sgd_kernel.mf_sgd_step(args[0], args[0], args[5], args[6], args[7])
