"""Port vs JAX package: bfloat16 parameters (`prng`'s bfloat16 draws,
`models/lm.py::init_params` in ``cfg.param_dtype``, `convert`,
`steps.logits_of`, `launch/serve.py`), on the CPU at the reduced configs
with ``param_dtype="bfloat16"`` in both packages (`reduced` itself forces
float32).

* `jax.random.uniform` / `normal` in bfloat16 draw 8 bits an element and
  keep 7: each value is one of 128, and the port's table
  (`prng._bf16_table`) equals JAX's at every index, bit for bit, as do
  whole draws (`normal`, `normal_chunked` on its int32 cipher, `uniform`
  over several ranges) and ``0.02 · normal`` under `jax.jit`.
* `init_params` at bfloat16 for every ported family: the same tree, every
  leaf bfloat16 and bit-equal, the ``ones`` / ``zeros`` leaves included.
* Reduced llama3-405b and arctic-480b from the same bfloat16 parameters:
  forward, prefill and decode logits within 1e-4 at float32 compute (the
  float32 test's tolerance); at bfloat16 compute within 16u·rms (max) and
  2u·rms (mean), u = 2⁻⁸, the bfloat16 cases' bounds; arctic's routes,
  layer by layer, equal before its values are compared.  `serve`'s greedy
  tokens equal the JAX `serve`'s.
* At bfloat16 compute no bfloat16 weight is converted (a dispatch-level
  record of `_to_copy`): only the reference's float32 upcasts remain.
* `convert.lm_params_from_numpy` keeps a bfloat16 tree bit for bit;
  `steps.logits_of` on a bfloat16 table equals the float32 product bit
  for bit at its default block, and within float32 reordering in small
  vocab blocks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import base as JCB
from repro.launch import serve as jserve
from repro.models import layers as jL
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models import steps as jsteps
from repro_torch import convert, prng
from repro_torch.configs import base as CB
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as L
from repro_torch.models import lm, steps
from repro_torch.models import moe as MOE

PORTED = ("llama3-8b", "llama3-405b", "qwen1.5-0.5b", "qwen3-0.6b",
          "mamba2-370m", "zamba2-7b", "dbrx-132b", "arctic-480b",
          "dbrx-132b:16x4", "seamless-m4t-large-v2", "llava-next-mistral-7b")
SERVED = ("llama3-405b", "arctic-480b")
F32 = dict(rtol=1e-4, atol=1e-4)
U = 2.0 ** -8                            # bfloat16's unit roundoff


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _reduced(name, dtype=None):
    """(JAX config, port config): reduced, with bfloat16 parameters."""
    name, _, experts = name.partition(":")
    kw = dict(param_dtype="bfloat16")
    if experts:
        E, k = map(int, experts.split("x"))
        kw |= dict(n_experts=E, moe_top_k=k)
    if dtype:
        kw["dtype"] = dtype
    return tuple(dataclasses.replace(c, **kw) for c in (
        JCB.reduced(JCB.get(name)), CB.reduced(CB.get(name))))


def _bits16(x):
    """A bfloat16 array or tensor → its raw int16 words (numpy)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def _jax_params(jcfg, seed=0):
    return jlm.init_params(jcfg, jax.random.PRNGKey(seed), model_shards=1)


def _port_params(jp):
    return convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                        device="cpu")


def _tokens(cfg, B=2, S=12, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)


def _close_bf16(got, want):
    """Within 16u·rms (max) and 2u·rms (mean) of ``want``."""
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want)
    rms = float(np.sqrt((want ** 2).mean()))
    assert err.max() <= 16 * U * rms and err.mean() <= 2 * U * rms, (
        err.max() / rms, err.mean() / rms)


# --------------------------------------------------------------------------
# the draws
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind,lo,hi", [("normal", None, None),
                                        ("uniform", 0.0, 1.0),
                                        ("uniform", -3.0, 5.0),
                                        ("uniform", 0.1, 0.7)])
def test_table_equals_jax_at_all_128_indices(kind, lo, hi):
    """Every 7-bit index's value: JAX's draw at the elements whose
    ``bits(key, uint8) >> 1`` is that index equals the table's entry."""
    key = jax.random.PRNGKey(11)
    n = 1 << 14
    idx = np.asarray(jax.random.bits(key, (n,), jnp.uint8)) >> 1
    assert set(idx.tolist()) == set(range(128))
    if kind == "normal":
        vals = jax.random.normal(key, (n,), jnp.bfloat16)
        table = prng._bf16_table("cpu", normal=True)
    else:
        vals = jax.random.uniform(key, (n,), jnp.bfloat16, lo, hi)
        table = prng._bf16_table("cpu", lo, hi)
    assert table.dtype == torch.bfloat16 and table.shape == (128,)
    np.testing.assert_array_equal(_bits16(table)[idx], _bits16(vals))


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1, -7])
@pytest.mark.parametrize("shape", [(7,), (5, 3), (2, 3, 5), (4099,)])
def test_bfloat16_normal_and_uniform_equal_jax(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    want = _bits16(jax.random.normal(jk, shape, jnp.bfloat16))
    got = prng.normal(tk, shape, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    np.testing.assert_array_equal(_bits16(got), want)
    for chunk in (1000, 1 << 24):
        np.testing.assert_array_equal(_bits16(prng.normal_chunked(
            tk, shape, dtype=torch.bfloat16, chunk=chunk)), want)
    np.testing.assert_array_equal(
        _bits16(prng.uniform(tk, shape, -2.0, 3.0, dtype=torch.bfloat16)),
        _bits16(jax.random.uniform(jk, shape, jnp.bfloat16, -2.0, 3.0)))


@pytest.mark.parametrize("start", [0, 2 ** 31 - 500, 2 ** 32 - 500,
                                   3 * 2 ** 32 + 17])
def test_int32_cipher_equals_the_int64_one(start):
    """`_low7_i32` (int32 words, wrapping adds) against `threefry2x32` on
    int64 words, across the int32 sign and the counter's high word (an
    expert stack of arctic-480b has 4.46·10⁹ elements)."""
    k1, k2 = prng.split(prng.PRNGKey(5))[1].tolist()
    hi, lo = prng._counter(1000, "cpu", start=start)
    b1, b2 = prng.threefry2x32(torch.tensor(k1), torch.tensor(k2), hi, lo)
    got = prng._low7_i32(k1, k2, start, 1000, "cpu")
    assert got.dtype == torch.int32
    assert torch.equal(got.long(), ((b1 ^ b2) >> 1) & 0x7F)


def test_scaled_draw_equals_jax_under_jit():
    """``0.02 · normal`` as `init_params` draws it: the product with
    bf16(0.02) rounded once, eagerly and under `jax.jit`, and `vmap`ped
    over layer keys as `_stack_init` is."""
    keys = jax.random.split(jax.random.PRNGKey(2), 3)
    f = lambda k: 0.02 * jax.random.normal(k, (3000,), jnp.bfloat16)
    leaf = lm._Leaf((3000,), None)
    for want in (jax.vmap(f)(keys), jax.jit(jax.vmap(f))(keys)):
        for i, k in enumerate(prng.split(prng.PRNGKey(2), 3)):
            got = lm._draw(leaf._replace(key=k), 0.02, torch.bfloat16, "cpu")
            np.testing.assert_array_equal(_bits16(got), _bits16(want[i]))


def test_draw_into_a_slice_refuses_a_wrong_target():
    out = torch.empty(4, 6, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        prng.normal_chunked(prng.PRNGKey(0), (4, 3), dtype=torch.bfloat16,
                            out=out[:, :3])
    with pytest.raises(ValueError, match="contiguous"):
        prng.normal_chunked(prng.PRNGKey(0), (4, 6), out=out)
    with pytest.raises(NotImplementedError, match="float16"):
        prng.normal(prng.PRNGKey(0), (3,), dtype=torch.float16)


# --------------------------------------------------------------------------
# init_params, convert, logits_of
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", PORTED)
def test_init_params_in_bfloat16_is_bit_equal_to_jax(name):
    jcfg, tcfg = _reduced(name)
    jp = _jax_params(jcfg, seed=3)
    tp = lm.init_params(tcfg, prng.PRNGKey(3), model_shards=1, device="cpu")
    jl, jdef = jax.tree.flatten(jax.tree.map(np.asarray, jp))
    tl, tdef = jax.tree.flatten(tp)
    assert tdef == jdef
    consts = 0
    for a, b in zip(tl, jl):
        assert a.dtype == torch.bfloat16 and b.dtype.name == "bfloat16"
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(_bits16(a), _bits16(b))
        consts += bool((b.astype(np.float32) == 1).all()
                       or (b.astype(np.float32) == 0).all())
    assert consts >= 1                      # the norms' ones at least


@pytest.mark.parametrize("name", ["llama3-405b", "arctic-480b", "zamba2-7b",
                                  "seamless-m4t-large-v2"])
def test_lm_params_from_numpy_keeps_a_bfloat16_tree(name):
    jcfg, _ = _reduced(name)
    jp = jax.tree.map(np.asarray, _jax_params(jcfg))
    tp = convert.lm_params_from_numpy(jp, device="cpu")
    jl, jdef = jax.tree.flatten(jp)
    tl, tdef = jax.tree.flatten(tp)
    assert tdef == jdef
    for a, b in zip(tl, jl):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits16(a), _bits16(b))
    f32 = convert.lm_params_from_numpy(jp, device="cpu", dtype="float32")
    assert f32["embed"].dtype == torch.float32
    np.testing.assert_array_equal(f32["embed"].numpy(),
                                  jp["embed"].astype(np.float32))


@pytest.mark.parametrize("B,S,chunk", [(2, 12, None), (4, 1, None),
                                       (2, 12, 1000), (4, 1, 64 * 7),
                                       (1, 5, 64)])
def test_logits_of_a_bfloat16_table_equals_the_float32_product(
        B, S, chunk, monkeypatch):
    """At the default block (2²⁸ elements: the reduced table is one
    block) bit-equal to one float32 product of the bfloat16 operands; in
    smaller vocab blocks (one row of 64 at the smallest) the CPU's BLAS
    may sum in another order, so within the reordering bound 2·D·2⁻²⁴ ·
    Σ|h||E| of each entry.  Both within float32 rounding of the JAX
    package's `logits_of`."""
    jcfg, cfg = _reduced("llama3-405b")
    jp = _jax_params(jcfg)
    p = _port_params(jp)
    assert p["out_embed"].dtype == torch.bfloat16
    h = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (B, S, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    if chunk is not None:
        monkeypatch.setattr(steps, "LOGITS_CHUNK", chunk)
    got = steps.logits_of(cfg, p, h)
    E32 = p["out_embed"].float()
    want = h.float() @ E32.T
    assert got.dtype == torch.float32 and got.shape == want.shape
    if chunk is None:
        assert torch.equal(got, want)
    bound = 2 * cfg.d_model * 2.0 ** -24 * (h.float().abs() @ E32.abs().T)
    assert bool(((got - want).abs() <= bound).all())
    jh = jnp.asarray(h.float().numpy(), jnp.bfloat16)
    jwant = jnp.einsum("bsd,vd->bsv", jh, jp["out_embed"].astype(jcfg.dtype),
                       preferred_element_type=jnp.float32)
    assert bool(((got - torch.from_numpy(np.array(jwant))).abs()
                 <= bound).all())


class _Copies(TorchDispatchMode):
    """Records the names of the parameter stacks that an op reads from
    through a dtype conversion (``aten._to_copy``)."""

    def __init__(self, names_by_storage):
        super().__init__()
        self.names, self.copied = names_by_storage, set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._to_copy.default:
            ptr = args[0].untyped_storage().data_ptr()
            if ptr in self.names:
                self.copied.add(self.names[ptr])
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", SERVED)
def test_bfloat16_weights_are_not_copied_at_bfloat16_compute(name):
    """A prefill and two decode steps at bfloat16 compute on bfloat16
    weights convert no weight: only the float32 upcasts the reference
    makes remain — the norms' weights (`rms_norm`), the router's logits,
    the output table's float32 product (`logits_of`)."""
    _, cfg = _reduced(name)
    assert cfg.dtype == "bfloat16"
    p = lm.init_params(cfg, prng.PRNGKey(0), model_shards=1, device="cpu")
    names = {t.untyped_storage().data_ptr(): k for k, t in p.items()
             if k != "layers"}
    names |= {t.untyped_storage().data_ptr(): k
              for k, t in p["layers"].items()}
    toks = torch.from_numpy(_tokens(cfg, S=8))
    rec = _Copies(names)
    with rec:
        _, pc = steps.make_prefill(cfg)(p, {"tokens": toks})
        cache = steps.init_cache(cfg, 2, 10, device="cpu")
        cache["k"][:, :, :8], cache["v"][:, :, :8] = pc["k"], pc["v"]
        cache["pos"] = 8
        dec = steps.make_decode_step(cfg)
        for t in range(2):
            _, cache = dec(p, cache, toks[:, t:t + 1])
    allowed = {"ln1", "ln2", "final_norm", "router", "out_embed",
               "q_norm", "k_norm"}
    assert rec.copied and rec.copied <= allowed, rec.copied - allowed


# --------------------------------------------------------------------------
# the served configurations
# --------------------------------------------------------------------------


def _routes(cfg, p, toks):
    """Each layer's expert ids through the port's forward, composed."""
    x, eids = lm.embed_tokens(p, cfg, toks), []
    for i in range(cfg.L):
        pl = lm.layer(p["layers"], i)
        x, _ = lm._attn_sublayer(pl, x, cfg, causal=True)
        eids.append(MOE.router(pl, L.rms_norm(x, pl["ln2"], cfg.norm_eps),
                               cfg)[0].numpy())
        x = lm._ffn_sublayer(pl, x, cfg)
    return eids


def _jax_routes(cfg, p, toks):
    """Each layer's expert ids through the JAX package's forward."""
    x, eids = jlm.embed_tokens(p, cfg, toks), []
    for i in range(cfg.L):
        pl = jax.tree.map(lambda a: a[i], p["layers"])
        x, _ = jlm._attn_sublayer(pl, x, cfg, causal=True)
        eids.append(np.asarray(jmoe.router(
            pl, jL.rms_norm(x, pl["ln2"], cfg.norm_eps), cfg)[0]))
        x = jlm._ffn_sublayer(pl, x, cfg, None, None)
    return eids


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", SERVED)
def test_forward_prefill_and_decode_match_jax(name, dtype):
    """From the same bfloat16 parameters: arctic's routes first, then the
    hidden states, prefill logits and three decode steps' logits (on a
    float32 cache for the moe family, as the float32 test decodes it)."""
    jcfg, tcfg = _reduced(name, dtype)
    jp = _jax_params(jcfg)
    tp = _port_params(jp)
    toks = _tokens(tcfg, S=80)           # more than one query chunk (64)
    b, jb = {"tokens": torch.from_numpy(toks)}, {"tokens": jnp.asarray(toks)}
    if tcfg.family == "moe":
        got, want = (_routes(tcfg, tp, b["tokens"]),
                     _jax_routes(jcfg, jp, jb["tokens"]))
        assert len(got) == tcfg.L
        for i, (a, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(a, w, err_msg=f"layer {i}")
    close = ((lambda g, w: np.testing.assert_allclose(
        g.numpy(), np.asarray(w), **F32)) if dtype == "float32"
        else _close_bf16)
    h = lm.forward(tcfg, tp, b)
    assert h.dtype == getattr(torch, dtype)
    close(h, jlm.forward(jcfg, jp, jb))
    logits, cache = steps.make_prefill(tcfg)(tp, b)
    jlogits, jcache = jsteps.make_prefill(jcfg)(jp, jb)
    close(logits, jlogits)
    assert cache["pos"] == int(jcache["pos"]) == 80
    cdt = torch.float32 if tcfg.family == "moe" else torch.bfloat16
    tc = steps.init_cache(tcfg, 2, 8, dtype=cdt, device="cpu")
    jc = jsteps.init_cache(jcfg, 2, 8, dtype=getattr(jnp, str(cdt)[6:]))
    dec, jdec = steps.make_decode_step(tcfg), jsteps.make_decode_step(jcfg)
    for t in range(3):
        lg, tc = dec(tp, tc, torch.from_numpy(toks[:, t:t + 1]))
        jlg, jc = jdec(jp, jc, jnp.asarray(toks[:, t:t + 1]))
        assert lg.shape == tuple(jlg.shape) == (2, 1, tcfg.vocab_padded(1))
        close(lg, jlg)


@pytest.mark.parametrize("name", SERVED)
def test_serve_greedy_tokens_equal_jax(name):
    jcfg, tcfg = _reduced(name, "float32")
    jp = _jax_params(jcfg, seed=1)
    logs = []
    want, _ = jserve.serve(jcfg, batch=2, prompt_len=16, gen=8, seed=1,
                           log=logs.append)
    got, stats = tserve.serve(tcfg, batch=2, prompt_len=16, gen=8, seed=1,
                              log=logs.append, device="cpu",
                              params=_port_params(jp))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (2, 9) and got.dtype == torch.int32
    assert stats["tok_per_s"] > 0


@pytest.mark.parametrize("name", SERVED)
def test_serve_draws_its_own_bfloat16_parameters(name):
    """Without ``params``, `serve` draws the seed's bfloat16 tree itself:
    the same tokens as from the JAX package's draw of that seed."""
    jcfg, tcfg = _reduced(name, "float32")
    want, _ = jserve.serve(jcfg, batch=2, prompt_len=8, gen=4, seed=1,
                           log=lambda *_: None)
    got, _ = tserve.serve(tcfg, batch=2, prompt_len=8, gen=4, seed=1,
                          log=lambda *_: None, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
