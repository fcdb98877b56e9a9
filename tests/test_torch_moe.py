"""Port vs JAX package: `models/moe.py`'s single-device path on the CPU.

* `router` against `repro.models.moe.router`: the expert ids equal and
  the gates within 1e-6, at reduced dbrx-132b (every token to all 4
  experts), reduced arctic-480b (top 2 of 4) and dbrx-132b's reduced
  widths with 16 experts, top 4; duplicated router columns make exact
  ties, which `lax.top_k` orders lower expert first.
* `moe_dense_ref` against the JAX `moe_dense_ref` on the same ids and
  gates, at float32 within 1e-5 and at bfloat16 within 2⁻⁸ of the
  output's rms (read: 0.34·2⁻⁸ at most; the slot sum and the gate
  product round in bfloat16 as in the reference), for the router's
  routes, a route that leaves an expert without a token (some tokens
  naming one expert in two slots), and one that sends every token to
  the same experts.
* `moe_dense_ref`'s gradients in ``x``, the gates and the three expert
  stacks against `jax.grad` of the JAX `moe_dense_ref` on the same
  routes and cotangent, for the same three routes and configs: at
  float32 each within 1e-5 of its own max |g|, at bfloat16 within 16u
  (u = 2⁻⁸; read: 5.6u at most, the gate's), and an expert without a
  token gets an all-zero gradient in both packages.  The output without
  grad is bit-equal to the output with it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JCB
from repro.models import moe as jmoe
from repro_torch.configs import base as CB
from repro_torch.models import moe

CONFIGS = {"dbrx-132b": {}, "arctic-480b": {},
           "dbrx-132b:16x4": dict(n_experts=16, moe_top_k=4)}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(name):
    base = name.partition(":")[0]
    return (dataclasses.replace(JCB.reduced(JCB.get(base)), **CONFIGS[name]),
            dataclasses.replace(CB.reduced(CB.get(base)), **CONFIGS[name]))


def _params(cfg, seed=0, dup=False):
    """Router and expert weights as numpy; with ``dup`` every odd router
    column repeats the even one before it (exact ties)."""
    rng = np.random.default_rng(seed)
    D, E, ff = cfg.d_model, cfg.n_experts, cfg.d_ff
    r = 0.1 * rng.normal(size=(D, E))
    if dup:
        r[:, 1::2] = r[:, 0::2]
    f = lambda *s: (0.05 * rng.normal(size=s)).astype(np.float32)
    return dict(router=r.astype(np.float32), w1=f(E, D, ff), w3=f(E, D, ff),
                w2=f(E, ff, D))


def _x(cfg, seed=1, B=2, S=12):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _margin(p, x, k):
    """The smallest gap between the k-th and (k+1)-th router logit."""
    lg = np.sort(x.reshape(-1, x.shape[-1]).astype(np.float64)
                 @ p["router"].astype(np.float64), axis=-1)[:, ::-1]
    return float((lg[:, k - 1] - lg[:, k]).min()) if k < lg.shape[1] else \
        float("inf")


@pytest.mark.parametrize("name", CONFIGS)
def test_router_matches_jax(name):
    jcfg, tcfg = _cfgs(name)
    p, x = _params(tcfg), _x(tcfg)
    je, jg = jmoe.router(_jax(p), jnp.asarray(x), jcfg)
    te, tg = moe.router(_torch(p), torch.from_numpy(x), tcfg)
    k = tcfg.moe_top_k
    assert te.dtype == torch.int32 and tg.dtype == torch.float32
    assert tuple(te.shape) == tuple(tg.shape) == (2, 12, k)
    np.testing.assert_array_equal(
        te.numpy(), np.asarray(je),
        err_msg=f"smallest router margin {_margin(p, x, k)}")
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", CONFIGS)
def test_router_ties_take_the_lower_expert_first(name):
    """Every router column repeated: each pair of experts ties exactly,
    and both packages list the lower one first."""
    jcfg, tcfg = _cfgs(name)
    p, x = _params(tcfg, dup=True), _x(tcfg)
    logits = torch.from_numpy(x) @ torch.from_numpy(p["router"])
    assert torch.equal(logits[..., 0::2], logits[..., 1::2])
    je, jg = jmoe.router(_jax(p), jnp.asarray(x), jcfg)
    te, tg = moe.router(_torch(p), torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
    e = te.numpy()
    # a pair's two experts are next to each other, the even one first
    pos = {v: i for i, v in enumerate(e[0, 0])}
    for v in e[0, 0]:
        if v % 2 == 1 and v - 1 in pos:
            assert pos[v - 1] == pos[v] - 1


def _routes(case, jcfg, p, x):
    """(eid, gate) numpy: the JAX router's, or a constructed route."""
    if case == "router":
        je, jg = jmoe.router(_jax(p), jnp.asarray(x), jcfg)
        return np.array(je), np.array(jg)
    B, S, _ = x.shape
    k, E = jcfg.moe_top_k, jcfg.n_experts
    rng = np.random.default_rng(7)
    if case == "same_experts":          # every token to experts E-1, ..., E-k
        eid = np.broadcast_to(np.arange(E - 1, E - 1 - k, -1), (B, S, k))
    else:       # "empty_expert": expert 1 unused; a token may repeat one
        pool = np.array([e for e in range(E) if e != 1])
        eid = rng.choice(pool, size=(B, S, k))
    gate = rng.dirichlet(np.ones(k), size=(B, S)).astype(np.float32)
    return np.array(eid, dtype=np.int32), gate


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["router", "empty_expert", "same_experts"])
@pytest.mark.parametrize("name", CONFIGS)
def test_moe_dense_ref_matches_jax(name, case, dtype):
    jcfg, tcfg = _cfgs(name)
    p, x = _params(tcfg), _x(tcfg)
    eid, gate = _routes(case, jcfg, p, x)
    if case == "empty_expert":
        assert 1 not in eid
    jy = jmoe.moe_dense_ref(_jax(p), jnp.asarray(x).astype(dtype),
                            jnp.asarray(eid), jnp.asarray(gate), jcfg)
    ty = moe.moe_dense_ref(_torch(p), torch.from_numpy(x).to(
        getattr(torch, dtype)), torch.from_numpy(eid),
        torch.from_numpy(gate), tcfg)
    assert ty.dtype == getattr(torch, dtype) and ty.shape == x.shape
    got, want = ty.float().numpy(), np.asarray(jy.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        rms = float(np.sqrt(np.mean(want ** 2)))
        assert float(np.abs(got - want).max()) <= 2.0 ** -8 * rms


def test_moe_dense_ref_refuses_ids_outside_the_experts():
    _, tcfg = _cfgs("arctic-480b")
    p, x = _torch(_params(tcfg)), torch.from_numpy(_x(tcfg))
    eid, gate = moe.router(p, x, tcfg)
    for bad in (tcfg.n_experts, -1):
        e = eid.clone()
        e[0, 3, 0] = bad
        with pytest.raises(ValueError, match="expert ids"):
            moe.moe_dense_ref(p, x, e, gate, tcfg)


def _loss_grads_jax(p, x, eid, gate, R, jcfg, dtype):
    """`jax.grad` of Σ moe_dense_ref(...)·R in (x, gate, w1, w3, w2)."""
    def loss(x, gate, w1, w3, w2):
        y = jmoe.moe_dense_ref(dict(w1=w1, w3=w3, w2=w2), x,
                               jnp.asarray(eid), gate, jcfg)
        return jnp.sum(y.astype(jnp.float32) * R)
    g = jax.grad(loss, argnums=tuple(range(5)))(
        jnp.asarray(x).astype(dtype), jnp.asarray(gate),
        *(jnp.asarray(p[n]) for n in ("w1", "w3", "w2")))
    return [np.asarray(a.astype(jnp.float32)) for a in g]


def _loss_grads_torch(p, x, eid, gate, R, tcfg, dtype):
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    tg = torch.from_numpy(gate).requires_grad_(True)
    tw = {n: torch.from_numpy(p[n]).requires_grad_(True)
          for n in ("w1", "w3", "w2")}
    y = moe.moe_dense_ref(tw, tx, torch.from_numpy(eid), tg, tcfg)
    (y.float() * torch.from_numpy(R)).sum().backward()
    with torch.no_grad():
        y0 = moe.moe_dense_ref(tw, tx, torch.from_numpy(eid), tg, tcfg)
    assert torch.equal(y0, y.detach())
    return [t.grad.float().numpy() for t in (tx, tg, *tw.values())]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["router", "empty_expert", "same_experts"])
@pytest.mark.parametrize("name", CONFIGS)
def test_moe_dense_ref_grads_match_jax(name, case, dtype):
    jcfg, tcfg = _cfgs(name)
    p, x = _params(tcfg), _x(tcfg)
    eid, gate = _routes(case, jcfg, p, x)
    R = np.random.default_rng(11).normal(size=x.shape).astype(np.float32)
    want = _loss_grads_jax(p, x, eid, gate, R, jcfg, dtype)
    got = _loss_grads_torch(p, x, eid, gate, R, tcfg, dtype)
    rel = 1e-5 if dtype == "float32" else 16 * 2.0 ** -8
    for n, a, b in zip(("x", "gate", "w1", "w3", "w2"), got, want):
        assert a.shape == b.shape, n
        scale = float(np.abs(b).max())
        assert scale > 0, n
        err = float(np.abs(a - b).max())
        assert err <= rel * scale, (n, err / scale)
    unused = sorted(set(range(tcfg.n_experts)) - set(eid.ravel().tolist()))
    assert (case == "empty_expert") <= (1 in unused)
    for e in unused:                  # an expert without a token: all zero
        for a, b in zip(got[2:], want[2:]):
            assert not a[e].any() and not b[e].any()
