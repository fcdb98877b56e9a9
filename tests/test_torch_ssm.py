"""Port vs JAX package: Mamba2's SSD block (`models/ssm.py`) and the ssm /
hybrid caches (`models/steps.py::init_cache`), on the CPU, float32
unless a case says otherwise.  The oracle is always the JAX function at
the installed version, on inputs drawn with numpy from a seed.

* `_conv1d` with and without a carried state, `ssd_chunked` with one
  chunk and several (and the chunk that does not divide the sequence,
  refused alike), `ssd_decode`, `softplus` and `mamba_block` for prefill
  and decode, within 1e-5.
* `tests/test_lm.py`'s `test_ssd_chunk_invariance`,
  `test_ssd_matches_naive_recurrence` and `test_ssm_decode_matches_forward`
  on the port (their tolerances; the decode test in bfloat16, 4e-2, and
  float32, 1e-4), and the same decode = forward for the hybrid.
* `init_cache`'s leaves, shapes and dtypes equal the JAX package's for
  both families, the hybrid's ring-buffer window at T = 100,000 too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JCB
from repro.models import lm as jlm
from repro.models import ssm as JSSM
from repro.models import steps as jsteps
from repro_torch import prng
from repro_torch.configs import base as CB
from repro_torch.models import lm, steps
from repro_torch.models import ssm as SSM

F32 = dict(rtol=1e-5, atol=1e-5)


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


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def _ssd_inputs(rng, B, S, H, Pd, N, dt_hi=0.2):
    """The JAX tests' draws: x, B, C, D normal; dt in [0.01, dt_hi];
    A in [−1, −0.1]."""
    f = lambda a: a.astype(np.float32)
    return (f(rng.normal(size=(B, S, H, Pd))),
            f(rng.uniform(0.01, dt_hi, (B, S, H))),
            -f(rng.uniform(0.1, 1.0, (H,))),
            f(rng.normal(size=(B, S, N))), f(rng.normal(size=(B, S, N))),
            f(rng.normal(size=(H,))))


@pytest.mark.parametrize("with_state", [False, True])
def test_conv1d_matches_jax(with_state):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    st = rng.normal(size=(2, 3, 12)).astype(np.float32) if with_state \
        else None
    (jx, jw), (tx, tw) = _both(x, w)
    jout, jst = JSSM._conv1d(jx, jw, None if st is None else jnp.asarray(st))
    out, new = SSM._conv1d(tx, tw, None if st is None else
                           torch.from_numpy(st))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **F32)
    np.testing.assert_array_equal(new.numpy(), np.asarray(jst))
    assert new.shape == (2, 3, 12) and new.dtype == torch.float32
    # a bfloat16 state under float32 input comes back in x's dtype
    if with_state:
        _, nb = SSM._conv1d(tx, tw, torch.from_numpy(st).bfloat16())
        assert nb.dtype == torch.float32


@pytest.mark.parametrize("S,chunk", [(32, 8), (32, 32), (24, 64)])
def test_ssd_chunked_matches_jax(S, chunk):
    """One chunk (Q = S, also when the chunk exceeds S) and four."""
    args = _ssd_inputs(np.random.default_rng(S + chunk), 2, S, 4, 8, 8)
    jargs, targs = _both(*args)
    want = JSSM.ssd_chunked(*jargs, chunk=chunk)
    got = SSM.ssd_chunked(*targs, chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == (2, S, 4, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_ssd_chunked_refuses_a_chunk_that_does_not_divide():
    jargs, targs = _both(*_ssd_inputs(np.random.default_rng(0), 1, 12, 2,
                                      4, 4))
    with pytest.raises(AssertionError, match="divide"):
        JSSM.ssd_chunked(*jargs, chunk=8)
    with pytest.raises(AssertionError, match="divide"):
        SSM.ssd_chunked(*targs, chunk=8)


def test_ssd_decode_matches_jax():
    rng = np.random.default_rng(4)
    B, H, Pd, N = 3, 4, 8, 16
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    args = (f(B, H, Pd), rng.uniform(0.01, 0.3, (B, H)).astype(np.float32),
            -rng.uniform(0.1, 1.0, (H,)).astype(np.float32), f(B, N),
            f(B, N), f(H), f(B, H, Pd, N))
    jargs, targs = _both(*args)
    jy, jst = JSSM.ssd_decode(*jargs)
    y, st = SSM.ssd_decode(*targs)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **F32)
    assert st.dtype == torch.float32


def test_softplus_is_jax_logaddexp():
    x = np.concatenate([np.linspace(-120, 120, 481), [-1e-7, 0.0, 1e-7,
                                                      19.9, 20.0, 20.1,
                                                      33.0, 89.0]])
    x = x.astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = SSM.softplus(torch.from_numpy(x)).numpy()
    # below −87 the result is subnormal, which XLA's CPU code flushes to 0
    np.testing.assert_allclose(got, want, rtol=2 ** -23,
                               atol=np.finfo(np.float32).tiny)
    # torch's own softplus returns x above its threshold
    assert np.any(torch.nn.functional.softplus(torch.from_numpy(x)).numpy()
                  != want)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_mamba_block_matches_jax(mode):
    jc, tc = _cfgs("mamba2-370m")
    key = jax.random.PRNGKey(5)
    rng = np.random.default_rng(6)
    jp = jlm._ssm_layer_init(jc, key, 0.5)          # large enough to mix
    # the init's constants (dt_bias, A_log 0; D, norm_w 1) drawn instead
    for k in ("dt_bias", "A_log", "D", "norm_w"):
        jp[k] = jnp.asarray(rng.normal(0, 0.5, jp[k].shape).astype(
            np.float32))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    H, N, K, di = SSM.n_heads(tc), tc.ssm_state, tc.ssm_conv, SSM.d_inner(tc)
    assert (H, di) == (JSSM.n_heads(jc), JSSM.d_inner(jc))
    B = 2
    if mode == "prefill":
        x = rng.normal(size=(B, 16, tc.d_model)).astype(np.float32)
        jy, (jst, jconv) = JSSM.mamba_block(jp, jnp.asarray(x), jc, chunk=4)
        y, (st, conv) = SSM.mamba_block(tp, torch.from_numpy(x), tc,
                                        chunk=4)
        assert st is None and jst is None
    else:
        x = rng.normal(size=(B, 1, tc.d_model)).astype(np.float32)
        s0 = rng.normal(size=(B, H, tc.ssm_headdim, N)).astype(np.float32)
        c0 = tuple(rng.normal(size=(B, K - 1, w)).astype(np.float32)
                   for w in (di, N, N))
        jy, (jst, jconv) = JSSM.mamba_block(
            jp, jnp.asarray(x), jc, state=jnp.asarray(s0),
            conv_state=tuple(map(jnp.asarray, c0)))
        y, (st, conv) = SSM.mamba_block(
            tp, torch.from_numpy(x), tc, state=torch.from_numpy(s0),
            conv_state=tuple(map(torch.from_numpy, c0)))
        np.testing.assert_allclose(st.numpy(), np.asarray(jst), **F32)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32)
    assert float(np.abs(np.asarray(jy)).max()) > 1e-3
    for a, b in zip(conv, jconv):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)


def test_ssd_chunked_gradient_where_the_reference_overflows():
    """ROADMAP Queue 3: one chunk of 128 positions with dt·|A| ≈ 1 takes
    cum_s − cum_t above the diagonal past float32's exp range (≈ 88.7).
    The reference exps before it masks: its forward is finite, its
    gradient NaN.  The port masks the exponent: the same forward, and a
    finite gradient equal to the reference's at chunk 32 (no overflow
    there; the chunking moves only the rounding)."""
    rng = np.random.default_rng(7)
    B, S, H, Pd, N = 1, 128, 2, 4, 4
    xs, _, _, B_, C_, D = _ssd_inputs(rng, B, S, H, Pd, N)
    dt = rng.uniform(0.8, 1.2, (B, S, H)).astype(np.float32)
    A = -rng.uniform(0.9, 1.0, (H,)).astype(np.float32)
    w = rng.normal(size=(B, S, H, Pd)).astype(np.float32)
    args = (xs, dt, A, B_, C_, D)
    jargs, targs = _both(*args)

    def jgrads(chunk):
        f = lambda *a: jnp.sum(JSSM.ssd_chunked(*a, chunk=chunk) * w)
        return jax.grad(f, argnums=tuple(range(6)))(*jargs)
    assert any(np.isnan(np.asarray(g)).any() for g in jgrads(128))
    want = jgrads(32)
    assert all(np.isfinite(np.asarray(g)).all() for g in want)
    leaves = [t.clone().requires_grad_(True) for t in targs]
    y = SSM.ssd_chunked(*leaves, chunk=128)
    # 128-term sums in another order: the JAX chunk test's 1e-4
    np.testing.assert_allclose(
        y.detach().numpy(), np.asarray(JSSM.ssd_chunked(*jargs, chunk=128)),
        rtol=1e-4, atol=1e-4)
    (y * torch.from_numpy(w)).sum().backward()
    for t, g in zip(leaves, want):
        g = np.asarray(g)
        scale = np.abs(g).max()
        assert np.isfinite(t.grad.numpy()).all()
        assert np.abs(t.grad.numpy() - g).max() <= 1e-4 * scale


def test_ssd_chunk_invariance():
    """`test_lm.py::test_ssd_chunk_invariance` on the port."""
    targs = [torch.from_numpy(a) for a in _ssd_inputs(
        np.random.default_rng(0), 2, 32, 4, 8, 8)]
    y1 = SSM.ssd_chunked(*targs, chunk=8)
    y2 = SSM.ssd_chunked(*targs, chunk=32)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=1e-4, atol=1e-4)


def test_ssd_matches_naive_recurrence():
    """`test_lm.py::test_ssd_matches_naive_recurrence` on the port: the
    chunked scan against h_t = exp(dt·A) h_{t−1} + dt·(B_t ⊗ x_t),
    y = C_t·h_t + D·x in float64."""
    xs, dt, A, B_, C_, D = _ssd_inputs(np.random.default_rng(1), 1, 12, 2,
                                       4, 4, dt_hi=0.3)
    got = SSM.ssd_chunked(*(torch.from_numpy(a) for a in
                            (xs, dt, A, B_, C_, D)), chunk=4).numpy()
    state = np.zeros((1, 2, 4, 4))
    want = np.zeros_like(xs)
    for t in range(12):
        dA = np.exp(dt[:, t] * A[None])
        upd = np.einsum("bh,bn,bhp->bhpn", dt[:, t], B_[:, t], xs[:, t])
        state = state * dA[:, :, None, None] + upd
        want[:, t] = np.einsum("bn,bhpn->bhp", C_[:, t], state) \
            + xs[:, t] * D[None, :, None]
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("name", ["mamba2-370m", "zamba2-7b"])
@pytest.mark.parametrize("dtype,tol", [("bfloat16", 4e-2), ("float32", 1e-4)])
def test_ssm_decode_matches_forward(name, dtype, tol):
    """`test_lm.py::test_ssm_decode_matches_forward` on the port (the SSD
    chunked scan = the one-token recurrence), for the hybrid too (its
    shared block's ring-buffer K/V); the caches in the compute dtype."""
    _, cfg = _cfgs(name, dtype=dtype)
    if name == "mamba2-370m":
        cfg = dataclasses.replace(cfg, L=2)
    p = lm.init_params(cfg, prng.PRNGKey(0), model_shards=1, device="cpu")
    B, S = 2, 16
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S)).astype(np.int32))
    full = steps.logits_of(cfg, p, lm.forward(cfg, p, {"tokens": toks}))
    dec = steps.make_decode_step(cfg)
    cache = steps.init_cache(cfg, B, S, dtype=getattr(torch, dtype),
                             device="cpu")
    outs = []
    for t in range(S):
        lg, cache = dec(p, cache, toks[:, t:t + 1])
        outs.append(lg[:, 0])
    got = torch.stack(outs, dim=1)
    np.testing.assert_allclose(got.numpy(), full.detach().numpy(),
                               rtol=tol, atol=tol)
    assert cache["pos"] == S


@pytest.mark.parametrize("name,T", [("mamba2-370m", 24), ("zamba2-7b", 24),
                                    ("zamba2-7b", 100_000)])
def test_init_cache_equals_jax(name, T):
    """The leaves, shapes and dtypes (the conv states in the cache dtype,
    the SSM state float32); the hybrid's K/V one slot per group, a
    window of 8,192 from T = 100,000 on."""
    jc, tc = _cfgs(name, dtype="bfloat16")
    if T > 1000:                      # keep the window's buffers small
        jc, tc = (dataclasses.replace(c, d_model=32, n_heads=2, n_kv=1,
                                      head_dim=8, ssm_state=4,
                                      ssm_headdim=8) for c in (jc, tc))
    want = jax.eval_shape(lambda: jsteps.init_cache(jc, 2, T))
    got = steps.init_cache(tc, 2, T, device="cpu")
    assert sorted(got) == sorted(want)
    assert got["pos"] == 0
    for k, v in want.items():
        if k == "pos":
            continue
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype) == f"torch.{v.dtype}", k
        assert not got[k].any()
    if name == "zamba2-7b":
        assert got["k"].shape[0] == len(lm._hybrid_groups(tc)) == len(
            jlm._hybrid_groups(jc))
        assert got["k"].shape[2] == (8192 if T >= 100_000 else T)
