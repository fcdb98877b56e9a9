"""Port vs JAX package: `launch/specs.py` and the analytic half of
`launch/roofline.py`, and `lm.init_params` on the meta device.

* `param_counts` (total, active) for every config at ``model_shards`` 1,
  8 and 16, `model_flops` for every config × `SHAPES` cell (skips
  included) and `analytic_hbm_bytes` at the axes {1, 1}, {2, 8} and
  {16, 16}: each equal to the reference's (``==``).
* The meta parameter tree: leaf paths, shapes and dtypes equal to
  ``jax.eval_shape(init_params)``'s for all ten configs, each built at
  full depth in well under 2 s, and no value read to the host on the
  way (no ``aten._local_scalar_dense``).
* `specs.py`'s batch, prefill and decode trees leaf by leaf against the
  reference's ``ShapeDtypeStruct`` trees (the decode cache's ``pos`` is
  the port decode step's Python int, the reference's an int32 scalar).
* `roofline`'s times are the reference's times scaled by the ratio of
  the two packages' constants, with the same bound wherever that ratio
  does not change the largest term.
* `forward_flops` (FlopCounterMode on meta tensors) equals
  `dense_forward_flops`'s derivation on reduced dense configs, and that
  derivation equals `model_flops` plus its three stated differences.
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import base as JCB
from repro.launch import roofline as JR
from repro.launch import specs as JS
from repro.models import lm as jlm
from repro_torch import prng
from repro_torch import tree as T
from repro_torch.configs import base as CB
from repro_torch.device import resolve_device
from repro_torch.launch import roofline as R
from repro_torch.launch import specs as S
from repro_torch.models import lm

NAMES = CB.names()
AXES = ({"ndp": 1, "ntp": 1}, {"ndp": 2, "ntp": 8}, {"ndp": 16, "ntp": 16})
DENSE = ("llama3-8b", "qwen3-0.6b", "qwen1.5-0.5b", "llama3-405b")


def _dtype(x):
    return str(x.dtype).replace("torch.", "")


def _jax_paths(tree):
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out.append(("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                             for k in path), leaf))
    return out


def _same_tree(got, want):
    """Leaf paths, shapes and dtypes of a meta tree against an SDS tree."""
    g, w = T.leaves_with_paths(got), _jax_paths(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.is_meta, path
        assert tuple(a.shape) == tuple(b.shape), path
        assert _dtype(a) == str(b.dtype), path


def test_the_config_grids_agree():
    assert NAMES == JCB.names()
    assert CB.cells(include_skips=True) == JCB.cells(include_skips=True)


@pytest.mark.parametrize("model_shards", [1, 8, 16])
@pytest.mark.parametrize("name", NAMES)
def test_param_counts_equal_jax(name, model_shards):
    got = R.param_counts(CB.get(name), model_shards)
    assert got == JR.param_counts(JCB.get(name), model_shards)
    assert got[1] <= got[0]


@pytest.mark.parametrize("name", NAMES)
def test_model_flops_equal_jax_on_every_cell(name):
    for shape in CB.SHAPES:
        for ms in (1, 16):
            assert R.model_flops(CB.get(name), CB.SHAPES[shape], ms) == \
                JR.model_flops(JCB.get(name), JCB.SHAPES[shape], ms), shape


@pytest.mark.parametrize("axes", AXES, ids=lambda a: f"{a['ndp']}x{a['ntp']}")
@pytest.mark.parametrize("name", NAMES)
def test_analytic_hbm_bytes_equal_jax(name, axes):
    for shape in CB.SHAPES:
        assert R.analytic_hbm_bytes(CB.get(name), CB.SHAPES[shape], axes) == \
            JR.analytic_hbm_bytes(JCB.get(name), JCB.SHAPES[shape], axes), \
            shape


@pytest.mark.parametrize("name", NAMES)
def test_meta_tree_matches_eval_shape(name):
    for ms in (1, 16):
        want = jax.eval_shape(lambda k: jlm.init_params(
            JCB.get(name), k, model_shards=ms), jax.random.PRNGKey(0))
        t = time.perf_counter()
        got = lm.init_params(CB.get(name), prng.PRNGKey(0), model_shards=ms,
                             device="meta")
        assert time.perf_counter() - t < 2.0
        _same_tree(got, want)


def test_ssm_helpers_equal_jax():
    for name in NAMES:
        assert R.SSM_n_heads(CB.get(name)) == JR.SSM_n_heads(JCB.get(name))
        assert R.bf16_coll_correction(CB.get(name)) == \
            JR.bf16_coll_correction(JCB.get(name))
    for dt in ("float32", "bfloat16", "float16", "int8"):
        assert R._dtype_bytes(dt) == JR._dtype_bytes(dt)


class _HostReads(TorchDispatchMode):
    """Records every op that reads a tensor's value to the host, and every
    tensor made off the meta device that is larger than a key."""

    def __init__(self):
        super().__init__()
        self.reads, self.big = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten._local_scalar_dense.default:
            self.reads.append(func)
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and not t.is_meta \
                    and t.numel() > 64:
                self.big.append((func, tuple(t.shape)))
        return out


@pytest.mark.parametrize("name", NAMES)
def test_meta_shortcut_reads_nothing_to_the_host(name):
    """Building the meta tree and every spec tree makes no value: no
    `.item()` / `.tolist()` on the way and no tensor off the meta device
    beyond the keys (a few words)."""
    cfg = CB.get(name)
    with _HostReads() as mode:
        lm.init_params(cfg, prng.PRNGKey(0), device="meta")
        for arch, shape, ok, _ in CB.cells():
            if arch == name and ok:
                S.input_specs(cfg, CB.SHAPES[shape])
    assert mode.reads == [] and mode.big == []


def test_resolve_device_accepts_meta_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("meta") == torch.device("meta")
    assert resolve_device(torch.device("meta")).type == "meta"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)


@pytest.mark.parametrize("shape", list(CB.SHAPES))
@pytest.mark.parametrize("name", NAMES)
def test_specs_match_jax(name, shape):
    cfg, jcfg = CB.get(name), JCB.get(name)
    got = S.input_specs(cfg, CB.SHAPES[shape])
    want = JS.input_specs(jcfg, JCB.SHAPES[shape])
    assert sorted(got) == sorted(want)
    if "cache" in want:
        assert got["cache"].pop("pos") == 0
        jpos = want["cache"].pop("pos")
        assert jpos.shape == () and jpos.dtype == jnp.int32
    _same_tree(got, want)
    if CB.SHAPES[shape].kind == "train":
        batch = S.batch_specs_for(dataclasses.replace(cfg, lsh_softmax=True),
                                  CB.SHAPES[shape])
        jbatch = JS.batch_specs_for(dataclasses.replace(
            jcfg, lsh_softmax=True), JCB.SHAPES[shape])
        _same_tree(batch, jbatch)
        prefill = S.prefill_specs_for(cfg, CB.SHAPES[shape])
        assert "labels" not in prefill
        _same_tree(prefill, JS.prefill_specs_for(jcfg, JCB.SHAPES[shape]))
    assert S.VLM_PATCHES == JS.VLM_PATCHES


COSTS = [dict(flops=f, bytes=b, coll_bytes=c)
         for f in (0.0, 1e9, 3.3e12, 7e15) for b in (0.0, 2e8, 4e11, 9e13)
         for c in (0.0, 1e6, 5e10)]


@pytest.mark.parametrize("cost", COSTS[::3] + COSTS[1::7])
def test_roofline_times_scale_by_the_constants(cost):
    got, want = R.roofline(cost, 1), JR.roofline(cost, 1)
    assert sorted(got) == sorted(want)
    ratio = dict(t_compute=JR.PEAK_FLOPS / R.PEAK_FLOPS,
                 t_memory=JR.HBM_BW / R.HBM_BW,
                 t_collective=JR.ICI_BW / R.NVLINK_BW)
    for k, r in ratio.items():
        np.testing.assert_allclose(got[k], want[k] * r, rtol=1e-15)
    terms = ("compute", "memory", "collective")
    scaled = [want[f"t_{n}"] * ratio[f"t_{n}"] for n in terms]
    assert got["bound"] == terms[int(np.argmax(scaled))]
    assert got["t_step"] == max(scaled) or np.isclose(got["t_step"],
                                                      max(scaled), rtol=1e-15)
    ref = [want[f"t_{n}"] for n in terms]
    if int(np.argmax(ref)) == int(np.argmax(scaled)):
        assert got["bound"] == want["bound"]


def test_h100_constants():
    assert (R.PEAK_FLOPS, R.HBM_BW, R.NVLINK_BW) == (989e12, 3.35e12, 450e9)


@pytest.mark.parametrize("name", NAMES)
def test_analytic_cell_on_one_card(name):
    """Every runnable cell at one card's axes: the record's counts are
    `model_flops` and `analytic_hbm_bytes` at ``model_shards = 1``, the
    reference's at the same axes, and there is no collective term."""
    cfg, jcfg = CB.get(name), JCB.get(name)
    for arch, shape, ok, _ in CB.cells(include_skips=True):
        if arch != name or not ok:
            continue
        rec = R.analytic_cell(cfg, CB.SHAPES[shape])
        assert rec["model_flops"] == JR.model_flops(jcfg, JCB.SHAPES[shape], 1)
        assert rec["hbm_bytes"] == JR.analytic_hbm_bytes(
            jcfg, JCB.SHAPES[shape], R.ONE_CARD)
        assert rec["t_collective"] == 0.0 and rec["bound"] != "collective"
        assert rec["t_step"] == max(rec["t_compute"], rec["t_memory"]) > 0


@pytest.mark.parametrize("BS", [(2, 16), (1, 100), (3, 130)],
                         ids=lambda bs: f"B{bs[0]}xS{bs[1]}")
@pytest.mark.parametrize("name", DENSE)
def test_forward_flops_match_the_derivation(name, BS):
    """FlopCounterMode's count of a reduced dense forward + logits on
    meta tensors equals the derivation, and the derivation is
    `model_flops` of the same prefill cell plus its three differences
    (S = 130 pads the last of three 64-query chunks)."""
    B, Sq = BS
    for cfg in (CB.reduced(CB.get(name)), dataclasses.replace(
            CB.reduced(CB.get(name)), tie_embeddings=True, qkv_bias=True,
            qk_norm=True, head_pad=8)):
        batch = {"tokens": S.meta((B, Sq), torch.int32)}
        d = R.dense_forward_flops(cfg, B, Sq, model_shards=1)
        assert R.forward_flops(cfg, batch, model_shards=1) == d["total"]
        mf = R.model_flops(cfg, CB.ShapeSpec("cut", Sq, B, "prefill"), 1)
        assert mf + d["tied_table"] + d["vector_params"] + d["attention"] \
            == d["total"]


def test_llama3_8b_forward_count():
    """The module docstring's numbers: llama3-8b's full-width forward at
    B 1 × S 128, counted on meta tensors."""
    cfg = CB.get("llama3-8b")
    batch = {"tokens": S.meta((1, 128), torch.int32)}
    n = R.forward_flops(cfg, batch, model_shards=1)
    assert n == R.dense_forward_flops(cfg, 1, 128, 1)["total"] \
        == 2_064_268_656_640
    assert 2 * R.param_counts(cfg, 1)[0] * 128 == 2_055_746_879_488
    with pytest.raises(ValueError, match="dense"):
        R.dense_forward_flops(CB.get("mamba2-370m"), 1, 8)
