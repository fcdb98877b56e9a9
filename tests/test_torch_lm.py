"""Port vs JAX package: the LM side's configs and its serving path
(`configs/`, `models/layers.py`, `models/lm.py`, `models/steps.py`'s
serving half, `launch/serve.py`), on the CPU at the reduced configs.

* Every registered config equals the JAX package's field for field, for
  all ten names, and so do `reduced`, `SHAPES`, `runnable` and `cells`.
* On each reduced config (the dense llama3-8b, llama3-405b, qwen1.5-0.5b
  and qwen3-0.6b, the ssm mamba2-370m, the hybrid zamba2-7b, the moe
  dbrx-132b — every token to all 4 experts —, arctic-480b — top-2 of 4
  and the dense residual MLP — and dbrx-132b with 16 experts, top 4,
  the encdec seamless-m4t-large-v2 and the vlm llava-next-mistral-7b):
  `init_params` draws the JAX package's streams (the same tree and
  shapes, each float within 4 ulp — `prng.normal`'s contract — and ≥
  95 % bit-equal); from the JAX parameters (`convert.
  lm_params_from_numpy`), `forward`, prefill and decode at float32
  within 1e-4 of the JAX package's, every decode cache leaf with its
  dtype — encdec behind frame embeddings, with seeded random cross
  caches, vlm behind an 8-patch prefix.  In bfloat16 the two frontend
  families' forward and prefill agree within 16u·rms (max) and 2u·rms
  (mean), u = 2⁻⁸ (the dense family reads the same: rounding order).
* `test_lm.py::test_dense_decode_matches_forward` on the port, in
  bfloat16 (the JAX test's 3e-2) and float32 (1e-4); and for encdec,
  its cross caches filled from the encoder's K/V.
* `serve`'s greedy tokens equal the JAX `repro.launch.serve.serve`'s
  over 8 steps at float32, from the same parameters and prompts (the
  ssm, hybrid and encdec families prefilled by sequential decode —
  encdec on zero cross caches, as the reference serves it —, dense, moe
  and vlm by one forward).
* (Training every family is held against the JAX package in
  `test_torch_lm_train.py` and, for encdec and vlm,
  `test_torch_frontend_train.py`; bfloat16 parameters — their draw, the
  served llama3-405b and arctic-480b — in `test_torch_bf16.py`.)
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
from repro_torch.models import layers as L
from repro_torch.models import lm, steps

NAMES = JCB.names()
DENSE = ("llama3-8b", "llama3-405b", "qwen1.5-0.5b", "qwen3-0.6b")
# "dbrx-132b:16x4": reduced dbrx-132b with its 16 experts and top 4 (the
# reduced config's 4 experts route every token to all of them)
MOE = ("dbrx-132b", "arctic-480b", "dbrx-132b:16x4")
# the frontend-stub families: serving is ported, training is not
OTHER = ("seamless-m4t-large-v2", "llava-next-mistral-7b")
PORTED = DENSE + ("mamba2-370m", "zamba2-7b") + MOE + OTHER
F32 = dict(rtol=1e-4, atol=1e-4)
U = 2.0 ** -8                            # bfloat16's unit roundoff


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _reduced(name, dtype=None):
    name, _, experts = name.partition(":")
    j, t = JCB.reduced(JCB.get(name)), CB.reduced(CB.get(name))
    if experts:
        E, k = map(int, experts.split("x"))
        j, t = (dataclasses.replace(c, n_experts=E, moe_top_k=k)
                for c in (j, t))
    if dtype:
        j, t = (dataclasses.replace(c, dtype=dtype) for c in (j, t))
    return j, t


def _min_router_margin(cfg, p, toks):
    """The smallest gap between the k-th and (k+1)-th router logit over
    the tokens and layers of the port's forward (inf when k = E): how
    near the routes are to a flip."""
    x = lm.embed_tokens(p, cfg, toks)
    gaps = [torch.tensor([float("inf")])]
    for i in range(cfg.L):
        pl = lm.layer(p["layers"], i)
        x, _ = lm._attn_sublayer(pl, x, cfg, causal=True)
        xn = L.rms_norm(x, pl["ln2"], cfg.norm_eps)
        lg = torch.sort(xn.float() @ pl["router"].float(), dim=-1,
                        descending=True).values
        k = cfg.moe_top_k
        if k < cfg.n_experts:
            gaps.append((lg[..., k - 1] - lg[..., k]).reshape(-1))
        x = lm._ffn_sublayer(pl, x, cfg)
    return float(torch.cat(gaps).min())


def _jax_params(jcfg, seed=0):
    return jlm.init_params(jcfg, jax.random.PRNGKey(seed), model_shards=1)


def _port_params(jp):
    return convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                        device="cpu")


def _tokens(cfg, B=2, S=12, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)


def _batches(cfg, toks, seed=0):
    """(port batch, JAX batch) of ``toks``; with a frontend stub also
    ``frontend_embeds`` drawn as `tests/test_lm.py::_batch` draws them:
    one frame a token for encdec, an 8-patch prefix otherwise."""
    b, jb = {"tokens": torch.from_numpy(toks)}, {"tokens": jnp.asarray(toks)}
    if cfg.frontend == "embed_stub":
        B, S = toks.shape
        P = S if cfg.family == "encdec" else 8
        fe = np.random.default_rng(seed + 1).normal(
            0, 0.02, (B, P, cfg.d_model)).astype(np.float32)
        b["frontend_embeds"] = torch.from_numpy(fe)
        jb["frontend_embeds"] = jnp.asarray(fe)
    return b, jb


def _random_cross(tc, jc, seed=0):
    """Seeded random ``cross_k`` / ``cross_v`` into both packages' encdec
    caches, in each cache's dtype (the reference's `serve` leaves them
    zero, and a zero cross cache adds exactly 0)."""
    rng = np.random.default_rng(seed)
    for n in ("cross_k", "cross_v"):
        r = rng.normal(0, 1, tuple(tc[n].shape)).astype(np.float32)
        tc[n] = torch.from_numpy(r).to(tc[n].dtype)
        jc[n] = jnp.asarray(r, jc[n].dtype)


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


@pytest.mark.parametrize("name", PORTED)
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


@pytest.mark.parametrize("name", PORTED)
def test_forward_prefill_and_decode_match_jax_at_float32(name):
    jcfg, tcfg = _reduced(name, "float32")
    jp = _jax_params(jcfg)
    tp = _port_params(jp)
    toks = _tokens(tcfg, S=80)           # more than one query chunk (64)
    b, jb = _batches(tcfg, toks)
    h = lm.forward(tcfg, tp, b)
    jh = jlm.forward(jcfg, jp, jb)
    assert h.dtype == torch.float32 and h.shape == jh.shape
    margin = (_min_router_margin(tcfg, tp, torch.from_numpy(toks))
              if tcfg.family == "moe" else None)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **F32,
                               err_msg=f"smallest router margin {margin}")
    logits, cache = steps.make_prefill(tcfg)(tp, b)
    jlogits, jcache = jsteps.make_prefill(jcfg)(jp, jb)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **F32)
    # vlm's cache holds the 8-patch prefix too; encdec's pos is the tokens'
    assert cache["pos"] == int(jcache["pos"]) == (
        88 if tcfg.family == "vlm" else 80)
    assert sorted(cache) == sorted(jcache)
    if tcfg.family in lm.KV_FAMILIES:
        for k in ("k", "v"):
            assert cache[k].dtype == torch.bfloat16
            np.testing.assert_allclose(cache[k].float().numpy(),
                                       np.asarray(jcache[k], np.float32),
                                       rtol=1e-2, atol=1e-2)
    else:                                 # no cache: the forward alone
        assert sorted(cache) == ["pos"]
    # three decode steps on a fresh cache.  The moe configs' cache is
    # float32: in bfloat16 one V entry of dbrx-132b:16x4 lies within
    # float32 rounding of a bfloat16 midpoint and rounds to neighbouring
    # values in the two packages (1 ulp, 2^-10), which moves the next
    # step's logits by 1.3e-4; with a float32 cache they agree within
    # 4e-7.  The bfloat16 cache path itself is the dense family's.
    cdt = torch.float32 if tcfg.family == "moe" else torch.bfloat16
    tc = steps.init_cache(tcfg, 2, 8, dtype=cdt, device="cpu")
    jc = jsteps.init_cache(jcfg, 2, 8, dtype=getattr(jnp, str(cdt)[6:]))
    if tcfg.family == "encdec":
        _random_cross(tc, jc)
    dec, jdec = steps.make_decode_step(tcfg), jsteps.make_decode_step(jcfg)
    for t in range(3):
        lg, tc = dec(tp, tc, torch.from_numpy(toks[:, t:t + 1]))
        jlg, jc = jdec(jp, jc, jnp.asarray(toks[:, t:t + 1]))
        assert lg.shape == tuple(jlg.shape) == (2, 1, tcfg.vocab_padded(1))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **F32)
    assert tc["pos"] == int(jc["pos"]) == 3
    # every cache leaf and its dtype: at float32 compute the conv states
    # become float32 after the first step (the reference's leaves are the
    # scan's outputs); the K/V stay bfloat16 (rounded: 1e-2); encdec's
    # cross K/V are read, never written
    assert sorted(tc) == sorted(jc)
    for k in sorted(set(jc) - {"pos"}):
        want = np.asarray(jc[k])
        assert str(tc[k].dtype) == f"torch.{want.dtype}", k
        assert tuple(tc[k].shape) == want.shape, k
        tol = dict(rtol=1e-2, atol=1e-2) if k in ("k", "v") else F32
        if k.startswith("cross_"):
            tol = dict(rtol=0, atol=0)
        np.testing.assert_allclose(tc[k].float().numpy(),
                                   want.astype(np.float32), **tol,
                                   err_msg=k)


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


@pytest.mark.parametrize("name", OTHER)
def test_frontend_families_match_jax_in_bfloat16(name):
    """encdec's forward and `prefill_generic` (frame embeddings, S = 80 >
    the 64-query chunk) and vlm's forward and `prefill_dense` (an
    8-patch prefix) at the configs' own bfloat16 compute: hidden states
    and last-position logits within 16u·rms (max) and 2u·rms (mean) of
    the JAX package's, vlm's cache K/V within 1e-2, ``pos`` equal."""
    jcfg, tcfg = _reduced(name)
    assert tcfg.dtype == "bfloat16"
    jp = _jax_params(jcfg)
    tp = _port_params(jp)
    b, jb = _batches(tcfg, _tokens(tcfg, S=80))

    def close(got, want):
        want = np.asarray(want, np.float32)
        err = np.abs(got.float().numpy() - want)
        rms = float(np.sqrt((want ** 2).mean()))
        assert err.max() <= 16 * U * rms and err.mean() <= 2 * U * rms, (
            err.max() / rms, err.mean() / rms)

    h = lm.forward(tcfg, tp, b)
    assert h.dtype == torch.bfloat16
    close(h, jlm.forward(jcfg, jp, jb))
    logits, cache = steps.make_prefill(tcfg)(tp, b)
    jlogits, jcache = jsteps.make_prefill(jcfg)(jp, jb)
    close(logits, jlogits)
    assert sorted(cache) == sorted(jcache)
    assert cache["pos"] == int(jcache["pos"]) == h.shape[1]
    for k in set(cache) - {"pos"}:
        assert cache[k].dtype == torch.bfloat16
        np.testing.assert_allclose(cache[k].float().numpy(),
                                   np.asarray(jcache[k], np.float32),
                                   rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 3e-2), ("float32", 1e-4)])
def test_encdec_decode_matches_forward(dtype, tol):
    """The decode = forward check for encdec: the cross caches filled
    with each decoder layer's K/V of the encoder's output (computed here
    as the reference's `_forward_encdec` projects them), T = S frames,
    then the tokens decoded one by one (teacher-forced): the logits of
    each step equal the forward's at that position."""
    _, cfg = _reduced("seamless-m4t-large-v2", dtype)
    p = lm.init_params(cfg, prng.PRNGKey(0), model_shards=1, device="cpu")
    B, S = 2, 12
    b, _ = _batches(cfg, _tokens(cfg, B, S))
    toks = b["tokens"]
    full_logits = steps.logits_of(cfg, p, lm.forward(cfg, p, b))
    cdt = getattr(torch, dtype)
    cache = steps.init_cache(cfg, B, S, dtype=cdt, device="cpu")
    xe = lm._encode(cfg, p, b["frontend_embeds"])
    for n, w in (("cross_k", "wk"), ("cross_v", "wv")):
        cache[n] = torch.stack([
            torch.einsum("bsd,dhk->bshk", xe, W.to(xe.dtype))
            for W in p["dec_cross"][w]]).to(cdt)
    dec = steps.make_decode_step(cfg)
    outs = []
    for t in range(S):
        lg, cache = dec(p, cache, toks[:, t:t + 1])
        outs.append(lg[:, 0])
    got = torch.stack(outs, dim=1)
    np.testing.assert_allclose(got.numpy(), full_logits.numpy(), rtol=tol,
                               atol=tol)


def test_vlm_decode_after_the_prefix_matches_forward():
    """vlm at float32 behind an 8-patch prefix: prefill's cache (its K/V
    in bfloat16, as the reference stores them) copied into a float32
    cache, then 4 tokens decoded one by one from position P + S: each
    step's logits within 2e-3 of the forward's over the whole sequence
    (the K/V rounding; a decode that lost the prefix's slots reads
    ~0.08)."""
    _, cfg = _reduced("llava-next-mistral-7b", "float32")
    p = lm.init_params(cfg, prng.PRNGKey(0), model_shards=1, device="cpu")
    B, S, G = 2, 12, 4
    b, _ = _batches(cfg, _tokens(cfg, B, S + G))
    P = b["frontend_embeds"].shape[1]
    full = steps.logits_of(cfg, p, lm.forward(cfg, p, b))    # [B, P+S+G, V]
    _, pc = steps.make_prefill(cfg)(p, {"tokens": b["tokens"][:, :S],
                                        "frontend_embeds":
                                        b["frontend_embeds"]})
    assert pc["pos"] == P + S and pc["k"].dtype == torch.bfloat16
    cache = steps.init_cache(cfg, B, P + S + G, dtype=torch.float32,
                             device="cpu")
    for n in ("k", "v"):
        cache[n][:, :, :P + S] = pc[n]
    cache["pos"] = pc["pos"]
    dec = steps.make_decode_step(cfg)
    for t in range(S, S + G):
        lg, cache = dec(p, cache, b["tokens"][:, t:t + 1])
        np.testing.assert_allclose(lg[:, 0].numpy(),
                                   full[:, P + t].detach().numpy(),
                                   rtol=0, atol=2e-3)
    assert cache["pos"] == P + S + G


@pytest.mark.parametrize("name", ["llama3-8b", "qwen3-0.6b", "mamba2-370m",
                                  "zamba2-7b", *MOE, *OTHER])
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


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b"])
def test_serve_cli_runs_the_ssm_families_on_the_cpu(arch, capsys):
    toks, stats = tserve.main(["--arch", arch, "--reduced", "--batch", "2",
                               "--prompt-len", "8", "--gen", "4",
                               "--device", "cpu"])
    assert toks.shape == (2, 5) and stats["tok_per_s"] > 0
    assert "tok/s batched" in capsys.readouterr().out


def test_serve_cli_runs_the_moe_family_on_the_cpu(capsys):
    toks, stats = tserve.main(["--arch", "dbrx-132b", "--reduced",
                               "--batch", "2", "--prompt-len", "8",
                               "--gen", "4", "--device", "cpu"])
    assert toks.shape == (2, 5) and stats["tok_per_s"] > 0
    assert "tok/s batched" in capsys.readouterr().out


@pytest.mark.parametrize("arch", OTHER)
def test_serve_cli_runs_the_frontend_families_on_the_cpu(arch, capsys):
    toks, stats = tserve.main(["--arch", arch, "--reduced", "--batch", "2",
                               "--prompt-len", "8", "--gen", "4",
                               "--device", "cpu"])
    assert toks.shape == (2, 5) and stats["tok_per_s"] > 0
    assert "tok/s batched" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "dbrx-132b",
                                  "arctic-480b", *OTHER])
def test_lm_params_from_numpy_keeps_the_tree(name):
    """Every leaf carried across bit for bit: the moe layers' [L, E, ...]
    expert stacks, router and arctic's dense residual ``w*d`` too, and
    encdec's nested ``enc`` / ``dec`` / ``dec_cross`` stacks."""
    jcfg, _ = _reduced(name)
    jp = _jax_params(jcfg)
    tp = _port_params(jp)
    assert sorted(tp) == sorted(jp)
    stacks = sorted(k for k, v in jp.items() if isinstance(v, dict))
    assert stacks == (["dec", "dec_cross", "enc"]
                      if jcfg.family == "encdec" else ["layers"])
    for k in stacks:
        assert sorted(tp[k]) == sorted(jp[k])
        for n, v in jp[k].items():
            assert tuple(tp[k][n].shape) == v.shape, (k, n)
            np.testing.assert_array_equal(tp[k][n].numpy(), np.asarray(v))
    if jcfg.family == "encdec":
        assert tp["enc"]["wq"].shape[0] == jcfg.enc_layers
        assert sorted(tp["dec_cross"]) == ["ln1", "wk", "wo", "wq", "wv"]
    if jcfg.family == "moe":
        E, D, ff = jcfg.n_experts, jcfg.d_model, jcfg.d_ff
        assert tp["layers"]["w1"].shape == (jcfg.L, E, D, ff)
        assert tp["layers"]["w2"].shape == (jcfg.L, E, ff, D)
        assert tp["layers"]["router"].shape == (jcfg.L, D, E)
        assert ("w1d" in tp["layers"]) == bool(jcfg.moe_dense_ff)
    half = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                        device="cpu", dtype="bfloat16")
    assert half["embed"].dtype == torch.bfloat16


def test_lm_params_from_numpy_keeps_the_hybrid_tree():
    """The hybrid's unstacked ``shared_attn`` dense layer beside the
    stacked Mamba2 layers: every leaf carried across bit for bit."""
    jcfg, _ = _reduced("zamba2-7b")
    jp = _jax_params(jcfg)
    tp = _port_params(jp)
    assert sorted(tp) == sorted(jp) == ["embed", "final_norm", "layers",
                                        "out_embed", "shared_attn"]
    for k in ("layers", "shared_attn"):
        assert sorted(tp[k]) == sorted(jp[k])
        for n, v in jp[k].items():
            assert tuple(tp[k][n].shape) == v.shape
            np.testing.assert_array_equal(tp[k][n].numpy(), np.asarray(v))
    assert tp["shared_attn"]["wq"].ndim == 3          # one layer, no L dim
    assert tp["layers"]["z_proj"].shape[0] == jcfg.L


def test_serve_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.serve(CB.reduced(CB.get("llama3-8b")), batch=1, prompt_len=2,
                     gen=1)
