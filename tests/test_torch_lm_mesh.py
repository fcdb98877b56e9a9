"""Port vs JAX package: the LM mesh paths on a 2 × 2 ("data", "model")
mesh, the port's four logical CPU cells (``REPRO_TORCH_LOGICAL_DEVICES=4``)
against the reference's four host devices.

The reference runs in subprocesses of `tests/helpers/lm_mesh_ref.py`
(their own XLA device count), all at once, and writes its inputs and
outputs; the port reads the same inputs.

* `moe_ffn` (a2a, ``shard_seq=True``; rep, ``shard_seq=False``) and
  `moe_ffn_ep2d` on the same routes, at capacity 16 (nothing dropped)
  and at 0.5 (slots dropped at the send and the expert capacities):
  the slots kept — the gates whose gradient is not 0 — are exactly the
  reference's, and the port's own dispatch log (its kept-slot mask)
  says so; the
  output within 1e-5 of its max, the gradients in x, the gates and the
  three expert stacks within 1e-4 of each one's max (the rep path's x
  gradient against the reference's forward-mode derivative along three
  directions, within 1e-5 of Σ|terms|: the reference's own reverse-mode
  one is wrong under jax 0.9).  At capacity 16 the output equals
  `moe_dense_ref`'s within 1e-6.
* `make_prefill`, one `make_decode_step` after it and one
  `make_train_step` with the mesh, on reduced dbrx-132b (every token to
  all 4 experts), reduced arctic-480b at capacity 1.0 (slots dropped),
  the same with ``moe_ep2d`` and reduced qwen3-0.6b.  Each moe layer's
  routes first (prefill and decode; a train step's forward is the
  prefill's), then at float32: logits and the decode caches within
  1e-4 of their max, the prefill's bfloat16 caches within one rounding
  (2⁻⁸ of their max), the loss and the norm within 1e-5, each first
  moment within 1e-4 of its max.  At bfloat16 compute: logits within 32u of their max
  (u = 2⁻⁸), the loss and the norm within 4u, first moments within
  32u of each leaf's max; the control, the port's logits without the
  mesh (arctic drops slots, so they differ), lies past the bound.
* For the dense config the mesh equals no mesh, bit for bit.
* A dispatch log keeps only the dispatches of the thread that opened it.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import threading
from contextlib import nullcontext

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch import tree as T
from repro_torch.configs import base as CB
from repro_torch.launch import mesh as M
from repro_torch.models import moe, steps
from repro_torch.models import sharding as SH

ROOT = pathlib.Path(__file__).resolve().parents[1]
HELPER = ROOT / "tests" / "helpers" / "lm_mesh_ref.py"
GROUPS = ("moe", "dbrx", "arctic", "arctic-ep2d", "dense")
REF_TIMEOUT = 400
U = 2.0 ** -8


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every group of the reference, run at once, each in its own
    subprocess → {group: {name: array}} and the helper's case list."""
    d = tmp_path_factory.mktemp("lm_mesh_ref")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = {g: subprocess.Popen(
        [sys.executable, str(HELPER), g, str(d / f"{g}.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for g in GROUPS}
    try:
        for g, p in procs.items():
            _, err = p.communicate(timeout=REF_TIMEOUT)
            assert p.returncode == 0, f"{g}: {err[-4000:]}"
    finally:
        for p in procs.values():
            p.kill()
    out = {g: dict(np.load(d / f"{g}.npz")) for g in GROUPS}
    return out, json.loads(str(out["moe"]["meta"]))


@pytest.fixture
def mesh(monkeypatch):
    monkeypatch.setenv(M.LOGICAL_DEVICES, "4")
    m = M.make_host_mesh(device="cpu")
    return m, SH.mesh_axes(m)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, want, frac, what):
    if torch.is_tensor(got):
        got = got.detach().double().numpy()
    if torch.is_tensor(want):
        want = want.detach().double().numpy()
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= frac * scale, f"{what}: {err:.3g} > {frac:g} x {scale:.3g}"
    return err / max(scale, 1e-30)


def _t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a))
    return t if dtype is None else t.to(dtype)


# --------------------------------------------------------------------------
# moe_ffn / moe_ffn_ep2d
# --------------------------------------------------------------------------

MOE_IDS = [(ci, path) for ci in range(3) for path in ("a2a", "rep", "ep2d")]


@pytest.mark.parametrize("ci,path", MOE_IDS)
def test_moe_dispatch_keeps_the_reference_slots(ref, mesh, ci, path):
    r, meta = ref
    r = r["moe"]
    name, over, cf = meta["moe_cases"][ci]
    cfg = dataclasses.replace(CB.reduced(CB.get(name)), dtype="float32",
                              **over)
    mesh_, axes = mesh
    pre = f"moe{ci}"
    x = _t(r[f"{pre}/x"]).requires_grad_(True)
    gate = _t(r[f"{pre}/gate"]).requires_grad_(True)
    eid = _t(r[f"{pre}/eid"])
    ws = {n: _t(r[f"{pre}/p/{n}"]).requires_grad_(True)
          for n in ("w1", "w3", "w2")}
    with moe.record_dispatches() as log:
        if path == "ep2d":
            y = moe.moe_ffn_ep2d(ws, x, eid, gate, cfg, mesh_, axes,
                                 capacity_factor=cf)
        else:
            y = moe.moe_ffn(ws, x, eid, gate, cfg, mesh_, axes,
                            capacity_factor=cf, shard_seq=path == "a2a")
    assert moe.dispatch_log() is None
    (y * _t(r[f"{pre}/cot"])).sum().backward()
    want_kept = r[f"{pre}/{path}/g_gate"] != 0
    got_kept = gate.grad.numpy() != 0
    np.testing.assert_array_equal(got_kept, want_kept)
    assert len(log) == 1 and log[0]["path"] == path
    assert log[0]["routed"] == eid.numel()
    assert torch.equal(log[0]["eid"], eid)
    assert int(log[0]["kept"]) == int(want_kept.sum())
    np.testing.assert_array_equal(log[0]["mask"].numpy(), want_kept)
    assert int(log[0]["sent"]) >= int(log[0]["kept"])
    if cf >= 16:
        assert want_kept.all()
        p = {"w1": ws["w1"], "w3": ws["w3"], "w2": ws["w2"]}
        _close(y.detach(), moe.moe_dense_ref(p, x.detach(), eid,
                                             gate.detach(), cfg), 1e-6,
               "moe_dense_ref")
    else:
        assert not want_kept.all(), "no slot was dropped"
    _close(y.detach(), r[f"{pre}/{path}/y"], 1e-5, "y")
    grads = dict(x=x.grad, gate=gate.grad, **{n: w.grad
                                              for n, w in ws.items()})
    if path == "rep":
        # the reference's reverse-mode x gradient of this path is wrong
        # under jax 0.9 (ROADMAP "Known differences"): x's gradient
        # against its forward-mode derivative along three directions
        gx = grads.pop("x").double()
        for d, want in zip(r[f"{pre}/rep/dirs"], r[f"{pre}/rep/jvp_x"]):
            terms = gx * _t(d).double()
            assert abs(float(terms.sum()) - float(want)) <= 1e-5 * float(
                terms.abs().sum()), (float(terms.sum()), float(want))
    for n, g in grads.items():
        _close(g, r[f"{pre}/{path}/g_{n}"], 1e-4, f"d{n}")


def test_a_mesh_larger_than_the_devices_raises(monkeypatch):
    monkeypatch.setenv(M.LOGICAL_DEVICES, "3")
    with pytest.raises(ValueError, match="exceeds"):
        M.make_host_mesh(device="cpu")
    monkeypatch.delenv(M.LOGICAL_DEVICES)
    with pytest.raises(ValueError, match="exceeds"):
        M.make_host_mesh(1, 2, device="cpu")
    assert M.make_host_mesh(1, 1, device="cpu").size == 1


def test_dispatch_log_is_the_recording_threads(mesh):
    """`record_dispatches` keeps the dispatches of the thread that opened
    it: a dispatch in another thread, with or without a log of its own,
    does not reach it."""
    mesh_, axes = mesh
    cfg = dataclasses.replace(CB.reduced(CB.get("arctic-480b")),
                              dtype="float32")
    g = torch.Generator().manual_seed(0)
    D, E, ff = cfg.d_model, cfg.n_experts, cfg.d_ff
    p = {n: 0.05 * torch.randn(*s, generator=g)
         for n, s in (("router", (D, E)), ("w1", (E, D, ff)),
                      ("w3", (E, D, ff)), ("w2", (E, ff, D)))}
    x = torch.randn(2, 8, D, generator=g)
    eid, gate = moe.router(p, x, cfg)
    seen = []

    def other(record):
        with moe.record_dispatches() if record else nullcontext() as log:
            moe.moe_ffn(p, x, eid, gate, cfg, mesh_, axes)
        seen.append(log)

    with moe.record_dispatches() as mine:
        for record in (False, True):
            t = threading.Thread(target=other, args=(record,))
            t.start()
            t.join()
        assert mine == []
        moe.moe_ffn_ep2d(p, x, eid, gate, cfg, mesh_, axes)
    assert [d["path"] for d in mine] == ["ep2d"]
    assert seen[0] is None and [d["path"] for d in seen[1]] == ["a2a"]
    assert moe.dispatch_log() is None


# --------------------------------------------------------------------------
# prefill, decode and train step on the mesh
# --------------------------------------------------------------------------


def _model(ref, key, dtype):
    r, meta = ref
    name, over = meta["models"][key]
    cfg = dataclasses.replace(CB.reduced(CB.get(name)), dtype=dtype,
                              **over)
    pre = f"{key}/{dtype}"
    r = {k[len(pre) + 1:]: v for k, v in r[key].items()
         if k.startswith(pre + "/")}
    tree = {}
    for k, v in r.items():
        if k.startswith("p/"):
            node = tree
            *parents, leaf = k[2:].split("/")
            for q in parents:
                node = node.setdefault(q, {})
            node[leaf] = v
    return cfg, convert.lm_params_from_numpy(tree, device="cpu"), r, meta


class _Routes:
    """The port's `moe.router` recording each call's expert ids."""

    def __init__(self, monkeypatch):
        self.ids = []
        orig = moe.router

        def rec(p, x, cfg):
            eid, gate = orig(p, x, cfg)
            self.ids.append(eid.numpy().copy())
            return eid, gate
        monkeypatch.setattr(moe, "router", rec)


def _same_routes(got, r, fn, n):
    want = [r[f"{fn}/eid{i}"] for i in range(n)]
    return len(got) >= n and all(np.array_equal(a, b)
                                 for a, b in zip(got, want))


MODEL_IDS = [(k, d) for k in ("dbrx", "arctic", "arctic-ep2d", "dense")
             for d in ("float32", "bfloat16")]


def _logit_bound(dtype):
    return 1e-4 if dtype == "float32" else 32 * U


@pytest.mark.parametrize("key,dtype", MODEL_IDS)
def test_prefill_on_the_mesh_matches_jax(ref, mesh, monkeypatch, key,
                                         dtype):
    cfg, p, r, _ = _model(ref, key, dtype)
    mesh_, axes = mesh
    routes = _Routes(monkeypatch)
    toks = _t(r["tokens"])
    lg, cache = steps.make_prefill(cfg, mesh_, axes)(p, {"tokens": toks})
    n = cfg.L if cfg.family == "moe" else 0
    assert _same_routes(routes.ids, r, "prefill", n), "routes differ"
    bound = _logit_bound(dtype)
    _close(lg, r["prefill/logits"], bound, "logits")
    assert cache["pos"] == toks.shape[1]
    for kv in ("k", "v"):     # bfloat16: one rounding of float32 values
        assert cache[kv].dtype == torch.bfloat16
        _close(cache[kv].float(), r[f"prefill/{kv}"],
               U if dtype == "float32" else 4 * U, kv)
    plain, _ = steps.make_prefill(cfg)(p, {"tokens": toks})
    if cfg.family != "moe":
        assert torch.equal(plain, lg)          # the mesh changes nothing
    elif key.startswith("arctic"):
        # the control: without the mesh nothing is dropped
        err = np.abs(plain.numpy() - r["prefill/logits"]).max()
        assert err > bound * np.abs(r["prefill/logits"]).max()


@pytest.mark.parametrize("key,dtype", MODEL_IDS)
def test_decode_on_the_mesh_matches_jax(ref, mesh, monkeypatch, key, dtype):
    cfg, p, r, meta = _model(ref, key, dtype)
    mesh_, axes = mesh
    S = meta["S"]
    cache = steps.init_cache(cfg, meta["B"], meta["T_cache"], torch.float32,
                             device="cpu")
    cache["k"][:, :, :S] = _t(r["prefill/k"])
    cache["v"][:, :, :S] = _t(r["prefill/v"])
    cache["pos"] = S
    plain_cache = {k: v.clone() if torch.is_tensor(v) else v
                   for k, v in cache.items()}
    routes = _Routes(monkeypatch)
    nxt = _t(r["next"])
    lg, c1 = steps.make_decode_step(cfg, mesh_, axes)(p, cache, nxt)
    n = cfg.L if cfg.family == "moe" else 0
    assert _same_routes(routes.ids, r, "decode", n), "routes differ"
    _close(lg, r["decode/logits"], _logit_bound(dtype), "logits")
    for kv in ("k", "v"):
        _close(c1[kv], r[f"decode/{kv}"],
               1e-4 if dtype == "float32" else 4 * U, kv)
    assert c1["pos"] == S + 1
    if cfg.family != "moe":
        plain, _ = steps.make_decode_step(cfg)(p, plain_cache, nxt)
        assert torch.equal(plain, lg)


@pytest.mark.parametrize("key,dtype", MODEL_IDS)
def test_train_step_on_the_mesh_matches_jax(ref, mesh, monkeypatch, key,
                                            dtype):
    cfg, p, r, _ = _model(ref, key, dtype)
    mesh_, axes = mesh
    toks = _t(r["tokens"])
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    routes = _Routes(monkeypatch)
    plain = None
    if cfg.family != "moe":
        q = T.tree_map(torch.clone, p)
        plain = steps.make_train_step(cfg)(q, steps.init_opt(cfg, q),
                                           dict(batch))
    _, opt, aux = steps.make_train_step(cfg, mesh_, axes)(
        p, steps.init_opt(cfg, p), batch)
    n = cfg.L if cfg.family == "moe" else 0
    # the step's forward routes as the prefill did on the same tokens
    assert _same_routes(routes.ids, r, "prefill", n), "routes differ"
    tol = 1e-5 if dtype == "float32" else 4 * U
    np.testing.assert_allclose(float(aux["loss"]), float(r["train/loss"]),
                               rtol=tol)
    np.testing.assert_allclose(float(aux["gnorm"]), float(r["train/gnorm"]),
                               rtol=tol)
    for path, m in T.leaves_with_paths(opt["m"]):
        _close(m, r[f"train/m/{path}"],
               1e-4 if dtype == "float32" else 32 * U, path)
    if plain is not None:
        assert torch.equal(plain[2]["loss"], aux["loss"])
        for a, b in zip(T.leaves(plain[1]["m"]), T.leaves(opt["m"])):
            assert torch.equal(a, b)
