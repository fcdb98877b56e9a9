"""Port vs JAX package: the simLSH accumulator and the fused Eq. (1)
prediction (`kernels/simlsh_encode`, `kernels/neighbor_predict`), on the
CPU, where the port's kernel wrappers run their plain versions and the
JAX package's Pallas kernels run in interpret mode.

* `ell_pack`: ids and ratings bit-equal, also when items have more
  raters than ``deg`` (the stable rank order decides which are kept).
* `simlsh_encode` at the JAX kernel tests' four shapes within 1e-5;
  `encode_band` within rtol 1e-5 / atol 1e-4 of the JAX package's (Ψ =
  r² sums reach 10³, where a float32 ulp is 6e-5, and the JAX ref's
  einsum sums in another order than the port's d-ordered plain version)
  and within rtol 1e-4 / atol 1e-3 of `band_accumulate` (segment-sum
  order, `tests/test_kernels.py`).
* `neighbor_predict` at the JAX kernel tests' four shapes and on random
  shapes within 1e-4; `predict_batch` within 1e-5 of the JAX package's
  and within 1e-4 of `model.predict` (``1/sqrt`` against ``rsqrt``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import model as jmodel
from repro.data import sparse as jsparse
from repro.kernels.neighbor_predict.kernel import (
    neighbor_predict as jneighbor_predict)
from repro.kernels.neighbor_predict.ops import predict_batch as jpredict_batch
from repro.kernels.neighbor_predict.ref import neighbor_predict_ref as jnp_ref
from repro.kernels.simlsh_encode.kernel import simlsh_encode as jsimlsh_encode
from repro.kernels.simlsh_encode.ops import encode_band as jencode_band
from repro.kernels.simlsh_encode.ops import ell_pack as jell_pack
from repro.kernels.simlsh_encode.ref import simlsh_encode_ref as jse_ref
from repro_torch import convert, prng
from repro_torch.core import model, simlsh
from repro_torch.data import sparse, synthetic
from repro_torch.kernels.neighbor_predict import kernel as np_kernel
from repro_torch.kernels.neighbor_predict.ops import (predict_batch,
                                                      predict_operands)
from repro_torch.kernels.neighbor_predict.ref import neighbor_predict_ref
from repro_torch.kernels.simlsh_encode import kernel as se_kernel
from repro_torch.kernels.simlsh_encode.ops import (band_operands,
                                                   encode_band, ell_pack)
from repro_torch.kernels.simlsh_encode.ref import simlsh_encode_ref

ENCODE_TOL = dict(rtol=1e-5, atol=1e-5)
BAND_TOL = dict(rtol=1e-5, atol=1e-4)   # Ψ = r² sums, see the docstring
PREDICT_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def coo():
    """A small MovieLens-like matrix (M = 300, N = 60, ~4,000 ratings)
    as both packages' `SparseMatrix`."""
    spec = dataclasses.replace(synthetic.MOVIELENS_LIKE, M=300, N=60,
                               nnz=4000)
    rows, cols, vals, _ = synthetic.generate(spec, seed=0)
    shape = (spec.M, spec.N)
    return (jsparse.from_coo(rows, cols, vals, shape),
            sparse.from_coo(rows, cols, vals, shape, device="cpu"))


def _deg(tsp) -> int:
    return int(torch.bincount(tsp.cols.long(), minlength=tsp.N).max())


@pytest.mark.parametrize("which", ["tight", "truncating"])
def test_ell_pack_bit_equal(coo, which):
    jsp, tsp = coo
    maxdeg = _deg(tsp)
    deg = ((maxdeg + 7) // 8) * 8 if which == "tight" else maxdeg // 3
    ids, vals = ell_pack(tsp, deg)
    jids, jvals = jell_pack(jsp, deg)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    kept = int((vals != 0).sum())
    assert kept == (tsp.nnz if which == "tight" else
                    int(torch.bincount(tsp.cols.long()).clamp(max=deg).sum()))
    assert kept < tsp.nnz or which == "tight"


@pytest.mark.parametrize("N,deg,bits,tile", [
    (8, 16, 16, 8), (37, 64, 24, 8), (128, 32, 30, 16), (5, 8, 8, 8)])
def test_simlsh_encode_matches_jax(N, deg, bits, tile):
    rng = np.random.default_rng(N * deg + bits)
    psi = rng.normal(size=(N, deg)).astype(np.float32)
    phi = rng.choice([-1.0, 1.0], size=(N, deg, bits)).astype(np.float32)
    got = se_kernel.simlsh_encode(torch.tensor(psi), torch.tensor(phi))
    assert got.shape == (N, bits) and got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jsimlsh_encode(psi, phi, tile_n=tile)),
        **ENCODE_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jse_ref(psi, phi)),
                               **ENCODE_TOL)


@pytest.mark.parametrize("cfg", [dict(G=8, p=2, q=2),
                                 dict(G=10, p=3, q=2, psi_mode="centered",
                                      psi_center=3.0, psi_pow=1.0)])
def test_encode_band_matches_jax_and_band_accumulate(coo, cfg):
    jsp, tsp = coo
    from repro.core.simlsh import SimLSHConfig as JCfg
    deg = ((_deg(tsp) + 7) // 8) * 8
    key = jax.random.PRNGKey(0)
    tkey = convert.key_from_numpy(np.asarray(key))
    tcfg = simlsh.SimLSHConfig(**cfg)
    for band in (0, 1):
        got = encode_band(tsp, tcfg, tkey, band, deg=deg)
        want = jencode_band(jsp, JCfg(**cfg), key, jnp.asarray(band),
                            deg=deg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **BAND_TOL)
        S = simlsh.band_accumulate(
            tsp.rows, tsp.cols, tsp.vals, tkey, band, N=tsp.N,
            bits=tcfg.sig_bits, psi_pow=tcfg.psi_pow,
            psi_mode=tcfg.psi_mode, psi_center=tcfg.psi_center)
        np.testing.assert_allclose(got.numpy(), S.numpy(), rtol=1e-4,
                                   atol=1e-3)
        ref = encode_band(tsp, tcfg, tkey, band, deg=deg, impl="ref")
        assert torch.equal(got, ref)


def test_band_operands_draw_phi_per_row_id(coo):
    _, tsp = coo
    cfg = simlsh.SimLSHConfig(G=8, p=2, q=2)
    key = prng.PRNGKey(5)
    w, phi = band_operands(tsp, cfg, key, 1, deg=16)
    ids, vals = ell_pack(tsp, 16)
    want = simlsh.phi_rows(key, 1, ids.reshape(-1), cfg.sig_bits)
    assert torch.equal(phi, want.reshape(phi.shape))
    assert torch.equal(w == 0, vals == 0)


@pytest.mark.parametrize("B,F,K,tile", [
    (64, 16, 8, 32), (100, 32, 16, 128), (3, 8, 4, 8), (256, 128, 32, 64)])
def test_neighbor_predict_matches_jax(B, F, K, tile):
    rng = np.random.default_rng(B + F + K)
    a = lambda *s: rng.normal(size=s).astype(np.float32)
    args = (a(B, F), a(B, F), a(B, K), a(B, K), a(B, K), a(B, K), a(B),
            a(B), a(B))
    got = np_kernel.neighbor_predict(*map(torch.tensor, args))
    assert got.shape == (B,)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jneighbor_predict(*args, tile_b=tile)),
        **PREDICT_TOL)


@settings(max_examples=10, deadline=None)
@given(st.integers(1, 50), st.integers(1, 20), st.integers(0, 10 ** 6))
def test_neighbor_predict_property(B, K, seed):
    rng = np.random.default_rng(seed)
    F = 8
    a = lambda *s: rng.normal(size=s).astype(np.float32)
    args = (a(B, F), a(B, F), a(B, K), a(B, K), a(B, K), a(B, K), a(B),
            a(B), a(B))
    got = neighbor_predict_ref(*map(torch.tensor, args)).numpy()
    np.testing.assert_allclose(got, np.asarray(jnp_ref(*args)),
                               **PREDICT_TOL)
    u, v, w, c, resid, impl, bbar, sR, sN = (x.astype(np.float64)
                                             for x in args)
    exact = (bbar + sR * (resid * w).sum(1) + sN * (impl * c).sum(1)
             + (u * v).sum(1))
    np.testing.assert_allclose(got, exact, **PREDICT_TOL)


def test_predict_batch_matches_jax_and_model(coo):
    jsp, tsp = coo
    F, K = 8, 4
    rng = np.random.default_rng(1)
    p0 = jmodel.init_from_data(jax.random.PRNGKey(0), jsp, F, K)
    jp = dataclasses.replace(  # W, C as a trained state has them
        p0, W=jnp.asarray(0.1 * rng.normal(size=(jsp.N, K)), jnp.float32),
        C=jnp.asarray(0.1 * rng.normal(size=(jsp.N, K)), jnp.float32))
    tp = convert.params_from_numpy(*(np.asarray(getattr(jp, f)) for f in (
        "U", "V", "b", "bh", "W", "C", "mu")), device="cpu")
    JK = rng.integers(0, jsp.N, (jsp.N, K)).astype(np.int32)
    idx = np.arange(256, dtype=np.int32)
    jbt = jmodel.assemble(jsp, jnp.asarray(JK), jnp.asarray(idx),
                          jnp.ones((256,), bool))
    bt = model.assemble(tsp, torch.tensor(JK), torch.tensor(idx),
                        torch.ones(256, dtype=torch.bool))
    assert 0 < float(bt.expl.mean()) < 1      # both kinds of slot occur
    got = predict_batch(tp, bt)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jpredict_batch(jp, jbt)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), model.predict(tp, bt)[0].numpy(),
                               **PREDICT_TOL)
    assert torch.equal(got, predict_batch(tp, bt, impl="ref"))
    assert all(t.is_contiguous() for t in predict_operands(tp, bt))


def test_impl_cuda_refuses_cpu_tensors(coo):
    _, tsp = coo
    cfg = simlsh.SimLSHConfig(G=8, p=2, q=2)
    with pytest.raises(ValueError, match="impl='cuda'"):
        encode_band(tsp, cfg, prng.PRNGKey(0), 0, deg=16, impl="cuda")
    p = model.init_from_data(prng.PRNGKey(0), tsp, 8, 4)
    JK = torch.zeros((tsp.N, 4), dtype=torch.int32)
    bt = model.assemble(tsp, JK, torch.arange(8), torch.ones(8))
    with pytest.raises(ValueError, match="impl='cuda'"):
        predict_batch(p, bt, impl="cuda")
    with pytest.raises(ValueError, match="impl must be"):
        predict_batch(p, bt, impl="pallas")
    before = (se_kernel.LAUNCHES, np_kernel.LAUNCHES)
    predict_batch(p, bt)
    encode_band(tsp, cfg, prng.PRNGKey(0), 0, deg=16)
    assert (se_kernel.LAUNCHES, np_kernel.LAUNCHES) == before  # CPU: plain


def test_plain_encode_is_the_einsum_summed_in_d_order():
    rng = np.random.default_rng(3)
    psi = torch.tensor(rng.normal(size=(6, 40)), dtype=torch.float32) * 5
    phi = torch.tensor(rng.choice([-1.0, 1.0], size=(6, 40, 7)),
                       dtype=torch.float32)
    got = simlsh_encode_ref(psi, phi)
    want = torch.einsum("nd,ndb->nb", psi.double(), phi.double())
    np.testing.assert_allclose(got.numpy(), want.numpy(), **ENCODE_TOL)
    seq = torch.zeros((6, 7))                 # the kernel's FMA chain
    for d in range(40):
        seq = torch.addcmul(seq, psi[:, d, None], phi[:, d])
    assert torch.equal(got, seq)
