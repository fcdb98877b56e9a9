"""Port vs JAX package: the neighbour comparators behind `fit`'s
``method`` switch (`core/baselines.py`, `core/gsm.py`) and the two
`data/synthetic.py` helpers, on the CPU at `test_torch_train_fit.py`'s
size (`MOVIELENS_LIKE` reshaped to M = 200, N = 80, 3,000 ratings).

Tolerances:

* `rand_topk` and `minhash_signatures`: bit-exact (threefry draws; the
  column minimum is order-free), for several (G, p), and an empty
  column keeps int32 max before the G-bit mask, as `segment_min` does;
* `rp_cos_signatures`: the bits that differ from the JAX package's are
  counted, and every one sits where the float64 accumulator is within
  1e-5 of 0 (the port's segment sum adds in COO order, JAX's in
  another);
* `gsm_topk`: ids equal to the JAX package's on this catalog, each
  id's score within 1e-5 of the K best of a float64 recompute; on a
  sparser one (M = 300, N = 120, 700 ratings), where many items share a
  rater with few others, so scores are exactly 0 and tie at the K-th
  place (the test checks they do), the exact ties are ordered as the
  JAX package orders them (lower id first), and ids differ only between
  scores equal in exact arithmetic (within 1e-6 relative in float64),
  whose float32 last bit follows each package's matmul blocking;
  `gsm_flops_bytes` equal;
* `scaled` and `add_noise`: equal, bit for bit;
* `fit(method=m)` for gsm, rand, rp_cos and minhash: J^K equal (rp_cos:
  equal here, where no signature bit differs) and the test RMSE after
  each of 2 epochs within 1e-4 of the JAX `fit`, as
  `test_torch_train_fit.py` holds simLSH.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import baselines as jbl
from repro.core import gsm as jgsm
from repro.core import simlsh as jsim
from repro.data import sparse as jsparse
from repro.data import synthetic as jsyn
from repro.train import trainer as jtrainer
from repro_torch import convert
from repro_torch.core import baselines, gsm, simlsh
from repro_torch.data import sparse, synthetic
from repro_torch.train import trainer

LSH = dict(G=8, p=1, q=10, band_cap=16)
SMALL = dict(F=8, K=4, cf_batch=64)
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
    jsp = jsparse.from_coo(rows, cols, vals, (spec.M, spec.N))
    tsp = sparse.from_coo(rows, cols, vals, (spec.M, spec.N), device="cpu")
    return spec, (rows, cols, vals), jsp, tsp


def _keys(seed):
    key = jax.random.PRNGKey(seed)
    return key, convert.key_from_numpy(np.asarray(key))


@pytest.mark.parametrize("N,K,seed", [(80, 8, 3), (17, 16, 0), (1000, 4, 9)])
def test_rand_topk_equals_jax(N, K, seed):
    jkey, tkey = _keys(seed)
    got = baselines.rand_topk(tkey, N, K)
    want = np.asarray(jbl.rand_topk(jkey, N, K))
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    assert not (got.numpy() == np.arange(N)[:, None]).any()   # never self


@pytest.mark.parametrize("G,p,q", [(8, 1, 6), (4, 3, 5), (10, 3, 2)])
def test_minhash_signatures_equal_jax(data, G, p, q):
    _, _, jsp, tsp = data
    jkey, tkey = _keys(5)
    cfg = jsim.SimLSHConfig(G=G, p=p, q=q)
    got = baselines.minhash_signatures(tsp, simlsh.SimLSHConfig(G=G, p=p,
                                                                q=q), tkey)
    want = np.asarray(jbl.minhash_signatures(jsp, cfg, jkey))
    assert got.dtype == torch.int32 and got.shape == (q, tsp.N)
    np.testing.assert_array_equal(got.numpy(), want)


def test_minhash_empty_column_keeps_int32_max_before_the_mask():
    rows = np.array([0, 1, 2], np.int32)
    cols = np.array([0, 0, 2], np.int32)             # column 1 is empty
    vals = np.ones(3, np.float32)
    jsp = jsparse.from_coo(rows, cols, vals, (3, 3))
    tsp = sparse.from_coo(rows, cols, vals, (3, 3), device="cpu")
    jkey, tkey = _keys(1)
    cfg = dict(G=6, p=2, q=3)
    got = baselines.minhash_signatures(tsp, simlsh.SimLSHConfig(**cfg), tkey)
    want = np.asarray(jbl.minhash_signatures(jsp, jsim.SimLSHConfig(**cfg),
                                             jkey))
    np.testing.assert_array_equal(got.numpy(), want)
    full = (1 << 6) - 1
    assert (got[:, 1].numpy() == full | (full << 6)).all()


@pytest.mark.parametrize("G,p,q", [(8, 1, 10), (4, 3, 5), (10, 3, 3)])
def test_rp_cos_signatures_differ_from_jax_only_near_zero(data, G, p, q):
    spec, (rows, cols, vals), jsp, tsp = data
    jkey, tkey = _keys(7)
    cfg = simlsh.SimLSHConfig(G=G, p=p, q=q)
    got = baselines.rp_cos_signatures(tsp, cfg, tkey).numpy()
    want = np.asarray(jbl.rp_cos_signatures(jsp, jsim.SimLSHConfig(
        G=G, p=p, q=q), jkey))
    bits = cfg.sig_bits
    flipped = 0
    for band in range(q):
        phi = simlsh.phi_rows(tkey, band, torch.from_numpy(rows.astype(
            np.int64)), bits).numpy().astype(np.float64)
        acc = np.zeros((spec.N, bits))
        np.add.at(acc, cols, vals[:, None].astype(np.float64) * phi)
        for b in range(bits):
            diff = ((got[band] >> b) & 1) != ((want[band] >> b) & 1)
            assert not (diff & (np.abs(acc[:, b]) >= 1e-5)).any(), (band, b)
            flipped += int(diff.sum())
    assert flipped <= 0.001 * got.size * bits, flipped
    again = baselines.rp_cos_signatures(tsp, cfg, tkey).numpy()
    np.testing.assert_array_equal(again, got)       # run to run


def _gsm_scores64(rows, cols, vals, M, N, lam=100.0):
    """The shrunk-Pearson matrix in float64 (the definition, no tiling)."""
    X = np.zeros((M, N))
    B = np.zeros((M, N))
    X[rows, cols] = vals
    B[rows, cols] = 1.0
    mean = X.sum(0) / np.maximum(B.sum(0), 1.0)
    Xc = (X - mean) * B
    X2 = Xc * Xc
    n = B.T @ B
    rho = (Xc.T @ Xc) / np.sqrt(np.maximum((X2.T @ B) * (B.T @ X2), 1e-12))
    S = n / (n + lam) * rho
    np.fill_diagonal(S, -np.inf)
    return S


@pytest.mark.parametrize("K,block", [(8, 512), (16, 24), (4, 80)])
def test_gsm_topk_equals_jax(data, K, block):
    spec, (rows, cols, vals), jsp, tsp = data
    got = gsm.gsm_topk(tsp, K=K, block=block)
    want = np.asarray(jgsm.gsm_topk(jsp, K=K, block=512))
    assert got.dtype == torch.int32 and got.shape == (spec.N, K)
    np.testing.assert_array_equal(got.numpy(), want)
    # each row's ids carry its K best scores (the definition, in float64)
    S = _gsm_scores64(rows, cols, vals, spec.M, spec.N)
    top = -np.sort(-S, axis=1)
    picked = np.take_along_axis(S, got.numpy().astype(np.int64), axis=1)
    np.testing.assert_allclose(picked, top[:, :K], rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def sparse_data():
    """A sparser catalog (M = 300, N = 120, 700 ratings) for GSM: many
    items share a rater with fewer than K others, so the K-th place is
    an exact 0 tied with many more."""
    spec = dataclasses.replace(synthetic.MOVIELENS_LIKE, M=300, N=120,
                               nnz=700)
    rows, cols, vals, _ = synthetic.generate(spec, seed=1)
    jsp = jsparse.from_coo(rows, cols, vals, (spec.M, spec.N))
    tsp = sparse.from_coo(rows, cols, vals, (spec.M, spec.N), device="cpu")
    return spec, (rows, cols, vals), jsp, tsp


@pytest.mark.parametrize("K,block", [(8, 512), (16, 24), (4, 80)])
def test_gsm_topk_matches_jax_with_exact_ties(sparse_data, K, block):
    """Exact ties (the 0 of every pair with no co-rater) keep the lower id
    first, as in the JAX package.  Scores that are equal in exact
    arithmetic (pairs whose co-ratings correlate alike) are not equal in
    float32: their last bit depends on each package's matmul blocking
    (the JAX package's tiled result differs from its own untiled one), so
    two such ids may swap — only between scores within 1e-6 (relative)
    in float64, never at an exact 0."""
    spec, (rows, cols, vals), jsp, tsp = sparse_data
    got = gsm.gsm_topk(tsp, K=K, block=block).numpy().astype(np.int64)
    want = np.asarray(jgsm.gsm_topk(jsp, K=K, block=512)).astype(np.int64)
    S = _gsm_scores64(rows, cols, vals, spec.M, spec.N)
    top = -np.sort(-S, axis=1)
    tied = int(((top[:, K - 1] == top[:, K]) & (top[:, K] == 0)).sum())
    assert tied >= 5, "the catalog must hold exact ties at the K-th place"
    s_got = np.take_along_axis(S, got, axis=1)
    s_want = np.take_along_axis(S, want, axis=1)
    swap = got != want
    assert not (swap & ((s_got == 0) | (s_want == 0))).any(), \
        "an exact tie is ordered differently from the JAX package"
    np.testing.assert_allclose(s_got, s_want, rtol=1e-6, atol=0)
    zero_ids = np.where(s_want == 0, want, -1)
    np.testing.assert_array_equal(np.where(s_got == 0, got, -1), zero_ids)
    np.testing.assert_allclose(s_got, top[:, :K], rtol=1e-6, atol=0)


def test_gsm_topk_orders_negative_zero_below_zero():
    from repro_torch.core.topk import topk_first_index
    S = torch.tensor([[0.0, -0.0, 0.0, -1.0, -0.0]])
    ids = topk_first_index(S, 5)
    assert ids.tolist() == [[0, 2, 1, 4, 3]]
    want = jax.lax.top_k(jax.numpy.asarray(S.numpy()), 5)[1]
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want))


def test_gsm_topk_computes_float32_whatever_the_matmul_setting(data):
    _, _, _, tsp = data
    prec = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        got = gsm.gsm_topk(tsp, K=8)
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prec)
    assert torch.equal(got, gsm.gsm_topk(tsp, K=8))


@pytest.mark.parametrize("M,N,K", [(69_878, 10_677, 8), (700_000, 30_000,
                                                          64), (1, 1, 1)])
def test_gsm_flops_bytes_equal_jax(M, N, K):
    assert gsm.gsm_flops_bytes(M, N, K) == jgsm.gsm_flops_bytes(M, N, K)


@pytest.mark.parametrize("scale", [0.01, 0.5, 1.0, 0.0001])
def test_scaled_equals_jax(scale):
    for name in ("MOVIELENS_LIKE",):
        got = synthetic.scaled(getattr(synthetic, name), scale)
        want = jsyn.scaled(getattr(jsyn, name), scale)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
def test_add_noise_equals_jax(data, rate):
    _, (_, _, vals), _, _ = data
    got = synthetic.add_noise(np.random.default_rng(4), vals, rate, 1.0, 5.0)
    want = jsyn.add_noise(np.random.default_rng(4), vals, rate, 1.0, 5.0)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert int((got != vals).sum()) <= int(len(vals) * rate)
    assert got is not vals


@pytest.fixture(scope="module")
def split(data):
    spec, (rows, cols, vals), _, _ = data
    tr, te = sparse.train_test_split(np.random.default_rng(0), rows, cols,
                                     vals)
    return spec, tr, te


@pytest.mark.parametrize("method", ["gsm", "rand", "rp_cos", "minhash"])
def test_fit_with_comparator_matches_jax(split, method):
    spec, tr, te = split
    kw = dict(epochs=2, method=method, use_kernels=True, **SMALL)
    want = jtrainer.fit(tr, te, (spec.M, spec.N), jtrainer.FitConfig(
        lsh=jsim.SimLSHConfig(**LSH), kernel_impl="ref", **kw))
    got = trainer.fit(tr, te, (spec.M, spec.N), trainer.FitConfig(
        lsh=simlsh.SimLSHConfig(**LSH), **kw), device="cpu")
    np.testing.assert_array_equal(got.JK.numpy(), np.asarray(want.JK))
    assert got.S is None and want.S is None
    for k in ("nb_cf", "nb_lo", "cf_frac"):
        assert got.schedule_stats[k] == want.schedule_stats[k], k
    r_got = np.array([h[2] for h in got.history])
    r_want = np.array([h[2] for h in want.history])
    assert r_got.shape == (2,)
    np.testing.assert_allclose(r_got, r_want, rtol=0, atol=RMSE_TOL)
    assert np.isfinite(r_got).all() and r_got[-1] < r_got[0]
    assert got.neighbour_seconds > 0
