"""Port vs JAX package: the dry-run tools (`launch/dryrun.py`,
`launch/perf.py`, `launch/report.py`) and `launch/roofline.py`'s
count-based half.

The reference's compiled numbers need four XLA host devices, so they
come from one run of `tests/helpers/dryrun_ref.py` per group (``coll``,
``cost``), both at once in subprocesses of their own; the port runs on
a 2 × 2 mesh of logical cells of the meta device
(``REPRO_TORCH_LOGICAL_DEVICES``).  Everything else is compared in
process.

* Bit-exact: `parse_override`, `fmt_bytes`, `dryrun_table` and
  `roofline_table` on the same records, `MAX_COST_QC`, `_cost_cfg` field
  for field, `_layer_counts`, `micro_shape` and `_attn_chunk_correction`
  on all 40 cells at the 16 × 16 and 2 × 16 × 16 axes, `Cost`'s
  arithmetic (hypothesis), the skip list and its records, and
  `build_cell`'s layouts, argument shapes and dtypes and donations
  against the reference's on an `AbstractMesh`.
* The composition is exact: `extract_cost`'s mesh-wide products
  (``flops_global``) `==` one direct count of the whole step at full
  depth (the train step with its µ microbatches and Adam), and its
  collectives the same, as integers — dense train at µ = 2, moe prefill
  and train, a hybrid with a partial group, encdec.
* Collectives against the reference's HLO (reduced arctic-480b,
  `moe_ffn` a2a / rep and `moe_ffn_ep2d`, forward and gradient, each
  compiled alone).  The relation found, and why:
  - all-to-all: equal at float32; at bfloat16 the reference's count is
    2 × the port's less the int32 ids (XLA-CPU moves bfloat16 at float32
    width — the reason for its `bf16_coll_correction` — and the ids are
    int32 in both);
  - all-reduce: the reference's = widen × the port's + the expert
    stacks' gradient blocks (3·E_loc·D·ff float32 bytes) in a gradient,
    + the gate's gradient block in the rep path's gradient.  The
    reference reduces the gradients of inputs a mesh axis replicates
    (the stacks over the data axes, x and the gates over "model") with
    all-reduces XLA places in the transpose; the port's cells take views
    of those blocks and autograd adds their gradients, moving nothing
    (the same class as the dense families' GSPMD collectives, which
    count 0), while its `psum_over` backward reduces the output's
    gradient, whose block is x's.
* Argument bytes: the port's meta `device_bytes` of the reduced dense
  train cell `==` the reference's `memory_analysis` for the argument and
  alias; its outputs are 8 bytes a leaf fewer (the pointer table of the
  reference's output tuple).
* Operations against XLA: the port's per-chip products are 0.85–1.0 of
  the reference's `extract_cost` flops on the reduced cells.  XLA
  counts elementwise work (norms, softmax, SiLU, rope, Adam) beside the
  products; the port counts products only, so it never exceeds XLA, and
  at these widths (d_model 128) elementwise work is under 15 % of
  XLA's count.
* The entry points on the CPU: `run_cell` on a reduced config per family
  (its analytic fields `==` `roofline.py`'s functions), `perf.run`
  without ``--mem`` and raising with it when there is no card, `main`
  exiting 0 (1 when a cell fails) and leaving ``os.environ`` as it was,
  and no module of the three changing it at import.
"""
import dataclasses
import importlib
import json
import os
import pathlib
import subprocess
import sys

import jax
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import AbstractMesh

from repro.configs import base as JCB
from repro.launch import report as jreport
from repro.launch import roofline as JRL
from repro_torch import tree as T
from repro_torch.configs import base as CB
from repro_torch.core import scatter
from repro_torch.launch import dryrun, perf, report
from repro_torch.launch import mesh as M
from repro_torch.launch import roofline as RL
from repro_torch.models import sharding as SH

ROOT = pathlib.Path(__file__).resolve().parents[1]
HELPER = ROOT / "tests" / "helpers" / "dryrun_ref.py"
GROUPS = ("coll", "cost")
REF_TIMEOUT = 300
CELLS = (("dense-train", "llama3-8b", {"microbatches": 2},
          ("train_s", 64, 8, "train")),
         ("moe-prefill", "arctic-480b", {}, ("prefill_s", 64, 4, "prefill")),
         ("moe-train", "arctic-480b", {}, ("train_s", 64, 4, "train")),
         ("hybrid-prefill", "zamba2-7b", {"L": 5},
          ("prefill_s", 64, 4, "prefill")),
         ("encdec-train", "seamless-m4t-large-v2", {},
          ("train_s", 64, 4, "train")))
AXES = {"16x16": ((16, 16), ("data", "model")),
        "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
ALL_CELLS = CB.cells(include_skips=True)


def _jax_module(name):
    """A reference launch module imported with ``os.environ`` restored
    (`dryrun` and `perf` set ``XLA_FLAGS`` when imported)."""
    env = dict(os.environ)
    try:
        return importlib.import_module(name)
    finally:
        os.environ.clear()
        os.environ.update(env)


@pytest.fixture(scope="module", autouse=True)
def _ref_runs(tmp_path_factory):
    """Both reference groups started at once when the module's first test
    starts (they run beside the in-process tests) → (dir, processes)."""
    d = tmp_path_factory.mktemp("dryrun_ref")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = {g: subprocess.Popen(
        [sys.executable, str(HELPER), g, str(d / f"{g}.json")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for g in GROUPS}
    try:
        yield d, procs
    finally:
        for p in procs.values():
            p.kill()


@pytest.fixture(scope="module")
def ref(_ref_runs):
    """The reference groups' records, once they are written → {group:
    record}."""
    d, procs = _ref_runs
    for g, p in procs.items():
        _, err = p.communicate(timeout=REF_TIMEOUT)
        assert p.returncode == 0, f"{g}: {err[-4000:]}"
    return {g: json.loads((d / f"{g}.json").read_text()) for g in GROUPS}


@pytest.fixture
def mesh(monkeypatch):
    """The 2 × 2 ("data", "model") mesh of logical meta cells."""
    monkeypatch.setenv(M.LOGICAL_DEVICES, "4")
    m = M.make_host_mesh(device="meta")
    return m, SH.mesh_axes(m)


def _cell(arch, over, shp):
    return (dataclasses.replace(CB.reduced(CB.get(arch)), **over),
            CB.ShapeSpec(*shp))


# --------------------------------------------------------------------------
# pure functions, bit for bit
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kv", ["L=2", "microbatches=4", "lr=3e-4",
                                "moe_capacity=1.5", "x=1e3", "remat=true",
                                "fsdp=false", "dtype=bfloat16", "name=a=b",
                                "query_chunk=-7", "flag=True"])
def test_parse_override_matches_reference(kv):
    jperf = _jax_module("repro.launch.perf")
    got, want = perf.parse_override(kv), jperf.parse_override(kv)
    assert got == want and type(got[1]) is type(want[1])


@pytest.mark.parametrize("b", [0, 1, 2 ** 30, 123456789, 3.5e12, 2 ** 40 - 1])
def test_fmt_bytes_matches_reference(b):
    assert report.fmt_bytes(b) == jreport.fmt_bytes(b)


def _reference_shaped_records(root):
    """Records in the reference's shape (compile seconds, temporaries)."""
    d = root / "reports" / "dryrun" / "16x16"
    d.mkdir(parents=True)
    recs = [dict(arch="a-1", shape="train_4k", mesh="16x16", skipped=False,
                 skip_reason="", lower_s=1.2, compile_s=33.4,
                 device_bytes=dict(argument=3 * 2 ** 30, output=2 ** 30,
                                   temp=5 * 2 ** 29, alias=2 ** 30,
                                   peak_gib=5.5),
                 collectives_in_module={"all-gather": 3 * 2 ** 31,
                                        "all-reduce": 0,
                                        "all-to-all": 12345678},
                 roofline=dict(bound="compute", t_compute=0.0123,
                               t_memory=0.00456, t_collective=0.0789,
                               useful_ratio=0.8765, mfu_bound=0.4321)),
            dict(arch="a-1", shape="long_500k", mesh="16x16", skipped=True,
                 skip_reason="long_500k needs sub-quadratic attention "
                             "(DESIGN.md §4)"),
            dict(arch="b-2", shape="decode_32k", mesh="16x16", skipped=False,
                 skip_reason="", lower_s=0.1, compile_s=2.6,
                 device_bytes=dict(argument=7, output=3, temp=1, alias=0,
                                   peak_gib=0.0),
                 collectives_in_module={}),
            ]
    for r in recs:
        (d / f"{r['arch']}__{r['shape']}.json").write_text(json.dumps(r))


def test_tables_byte_equal_on_reference_records(tmp_path, monkeypatch):
    _reference_shaped_records(tmp_path)
    monkeypatch.chdir(tmp_path)
    assert report.dryrun_table("16x16") == jreport.dryrun_table("16x16")
    assert report.roofline_table("16x16") == jreport.roofline_table("16x16")
    assert report.load("16x16") == jreport.load("16x16")


def test_tables_on_the_ports_records(tmp_path, mesh, monkeypatch):
    """The port's records: the roofline table byte-equal to the
    reference's renderer; the dry-run table's seconds are the count's,
    its header says so, and its meta peaks are marked."""
    m, axes = mesh
    out = tmp_path / "reports" / "dryrun"
    cfg, shape = _cell("qwen3-0.6b", {}, ("decode_s", 64, 4, "decode"))
    with _registered(cfg, shape):
        dryrun.run_cell(cfg.name, shape.name, m, do_roofline=True,
                        outdir=str(out), mesh_tag="2x2")
    monkeypatch.chdir(tmp_path)
    assert report.roofline_table("2x2") == jreport.roofline_table("2x2")
    got = report.dryrun_table("2x2").splitlines()
    assert "| count s |" in got[0] and "compile s" not in got[0]
    assert got[2].split("|")[4].strip().endswith("†")
    assert got[-1] == report.NO_TEMP_NOTE


def test_max_cost_qc_matches_reference():
    assert RL.MAX_COST_QC == JRL.MAX_COST_QC


@pytest.mark.parametrize("name", CB.names())
def test_cost_cfg_matches_reference(name):
    cfg, jcfg = CB.get(name), JCB.get(name)
    for L, enc, seq in ((1, None, 0), (2, 2, 4096), (6, None, 32768),
                        (3, 1, 1), (12, None, 100)):
        got = dataclasses.asdict(RL._cost_cfg(cfg, L, enc, seq))
        want = dataclasses.asdict(JRL._cost_cfg(jcfg, L, enc, seq))
        assert got == want


@pytest.mark.parametrize("arch,shape_name,ok,why", ALL_CELLS)
def test_layer_counts_micro_shape_chunk_correction_match_reference(
        arch, shape_name, ok, why):
    cfg, jcfg = CB.get(arch), JCB.get(arch)
    shape, jshape = CB.SHAPES[shape_name], JCB.SHAPES[shape_name]
    assert RL._layer_counts(cfg) == JRL._layer_counts(jcfg)
    assert (dataclasses.asdict(RL.micro_shape(shape, cfg))
            == dataclasses.asdict(JRL.micro_shape(jshape, jcfg)))
    for sizes, names in AXES.values():
        axes = SH.mesh_axes(M.LMMesh(names, sizes, ()))   # no cells needed
        for s, js in ((shape, jshape),
                      (RL.micro_shape(shape, cfg),
                       JRL.micro_shape(jshape, jcfg))):
            assert (RL._attn_chunk_correction(cfg, s, axes)
                    == JRL._attn_chunk_correction(jcfg, js, axes))


_COLL = st.dictionaries(
    st.sampled_from(["all-reduce", "all-gather", "reduce-scatter",
                     "all-to-all", "collective-permute"]),
    st.integers(-2 ** 40, 2 ** 40), max_size=5)
_NUM = st.one_of(st.integers(-2 ** 62, 2 ** 62),
                 st.floats(-1e18, 1e18, allow_nan=False))


@settings(max_examples=200, deadline=None)
@given(a=st.tuples(_NUM, _NUM, _COLL), b=st.tuples(_NUM, _NUM, _COLL),
       s=st.one_of(st.integers(-64, 64), st.floats(-8, 8, allow_nan=False)))
def test_cost_arithmetic_matches_reference(a, b, s):
    ca, cb = RL.Cost(*a), RL.Cost(*b)
    ja, jb = JRL.Cost(*a), JRL.Cost(*b)
    for got, want in ((ca + cb, ja + jb), (ca - cb, ja - jb),
                      (ca * s, ja * s), (cb * s, jb * s)):
        assert (got.flops, got.bytes, got.coll, got.coll_bytes) == (
            want.flops, want.bytes, want.coll, want.coll_bytes)
    assert ca.coll_bytes == ja.coll_bytes


def test_collective_bytes_and_schedule_shapes():
    sched = [("all-to-all", 10), ("all-reduce", 4), ("all-to-all", 6)]
    assert RL.collective_bytes(sched) == {"all-to-all": 16, "all-reduce": 4}
    assert RL.collective_schedule(sched, 2) == sched[:2]
    assert RL.collective_schedule(sched) == sched


def test_skip_list_and_records_match_reference(tmp_path):
    """The same 40 cells with the same skips and reasons; a skipped
    cell's record is the reference's, byte for byte."""
    assert ALL_CELLS == JCB.cells(include_skips=True)
    skips = [c for c in ALL_CELLS if not c[2]]
    assert len(ALL_CELLS) == 40 and len(skips) == 8
    jdry = _jax_module("repro.launch.dryrun")
    for arch, shape_name, _, _ in skips:
        for mod, sub in ((dryrun, "port"), (jdry, "ref")):
            mod.run_cell(arch, shape_name, None, do_roofline=True,
                         outdir=str(tmp_path / sub), mesh_tag="16x16")
        name = f"16x16/{arch}__{shape_name}.json"
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "ref" / name).read_bytes())


def _jax_flat(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), leaf) for path, leaf in flat]


@pytest.mark.parametrize("mesh_name", list(AXES))
@pytest.mark.parametrize("arch,shape_name", [c[:2] for c in ALL_CELLS
                                             if c[2]])
def test_build_cell_matches_reference(arch, shape_name, mesh_name,
                                      monkeypatch):
    """Each argument leaf's layout `==` the reference's spec, its shape
    and dtype `==` the reference's `eval_shape` tree, and the donations
    equal (the port's cache ``pos`` is a Python int, the reference's an
    int32 scalar: both replicated)."""
    monkeypatch.setenv(M.LOGICAL_DEVICES, "512")
    sizes, names = AXES[mesh_name]
    m = M.compat_mesh(sizes, names, device="meta")
    amesh = AbstractMesh(sizes, names)
    jdry = _jax_module("repro.launch.dryrun")
    from repro.models import sharding as JSH
    cfg, jcfg = CB.get(arch), JCB.get(arch)
    shape, jshape = CB.SHAPES[shape_name], JCB.SHAPES[shape_name]
    _, in_sh, args, donate = dryrun.build_cell(cfg, shape, m,
                                               SH.mesh_axes(m))
    _, jin_sh, jargs, jdonate = jdry.build_cell(jcfg, jshape, amesh,
                                                JSH.mesh_axes(amesh))
    assert donate == jdonate
    got_sh, want_sh = T.leaves_with_paths(in_sh), _jax_flat(jin_sh)
    got_a, want_a = T.leaves_with_paths(args), _jax_flat(jargs)
    assert [p for p, _ in got_sh] == [p for p, _ in want_sh]
    assert [p for p, _ in got_a] == [p for p, _ in want_a]
    assert [p for p, _ in got_a] == [p for p, _ in got_sh]
    for (path, s), (_, js) in zip(got_sh, want_sh):
        assert tuple(s.spec) == tuple(js.spec), path
    for (path, a), (_, ja) in zip(got_a, want_a):
        if path.endswith("pos"):
            assert a == 0 and ja.shape == ()
            continue
        assert tuple(a.shape) == tuple(ja.shape), path
        assert str(a.dtype).removeprefix("torch.") == ja.dtype.name, path
        assert a.device.type == "meta"


# --------------------------------------------------------------------------
# the count: composition, outputs, collectives
# --------------------------------------------------------------------------


def test_index_add_det_on_meta_computes_shapes_only():
    """The meta branch: `index_add_`'s shapes, no launch; 1-D and 2-D;
    `gather_rows`' backward through it too."""
    before = scatter.LAUNCHES
    dst = torch.empty((7, 3), device="meta")
    out = scatter.index_add_det_(dst, torch.empty(5, dtype=torch.long,
                                                  device="meta"),
                                 torch.empty((5, 3), device="meta"))
    assert out is dst and out.shape == (7, 3) and out.device.type == "meta"
    v = scatter.index_add_det(torch.empty(4, device="meta"),
                              torch.empty(9, dtype=torch.long, device="meta"),
                              torch.empty(9, device="meta"))
    assert v.shape == (4,) and v.device.type == "meta"
    E = torch.empty((6, 2), device="meta", requires_grad=True)
    g, = torch.autograd.grad(scatter.gather_rows(
        E, torch.empty((3, 2), dtype=torch.long, device="meta")).sum(), E)
    assert g.shape == (6, 2) and g.device.type == "meta"
    assert scatter.LAUNCHES == before


@pytest.mark.parametrize("name,arch,over,shp", CELLS,
                         ids=[c[0] for c in CELLS])
def test_composition_equals_the_direct_count(name, arch, over, shp, mesh,
                                             ref):
    """``fixed + L·layer`` × µ + Adam on the L1/L2 probes `==` one count
    of the whole step at full depth, products and collectives alike."""
    assert [list(c[:3]) + [list(c[3])] for c in CELLS] == [
        list(c) for c in ref["cost"]["meta"]["cells"]]
    m, axes = mesh
    cfg, shape = _cell(arch, over, shp)
    cost = RL.extract_cost(cfg, shape, m, axes)
    fn, in_sh, args, _ = dryrun.build_cell(cfg, shape, m, axes)
    direct = RL._count_cost(fn, in_sh, args, m)
    assert isinstance(cost["flops_global"], int)
    assert cost["flops_global"] == direct.flops > 0
    assert cost["flops"] == direct.flops / m.size
    assert cost["coll"] == direct.coll
    assert (cost["coll"].get("all-to-all", 0) > 0) == (cfg.family == "moe")
    assert cost["bytes_xla_upper"] is None
    assert cost["coll_bytes"] == cost["coll_bytes_raw"]
    assert cost["bytes"] == RL.analytic_hbm_bytes(cfg, shape, axes)
    assert RL._opt_cost(cfg, m, axes).flops == 0


@pytest.mark.parametrize("name,arch,over,shp", CELLS,
                         ids=[c[0] for c in CELLS])
def test_products_against_xla_within_the_band(name, arch, over, shp, mesh,
                                              ref):
    m, axes = mesh
    cfg, shape = _cell(arch, over, shp)
    got = RL.extract_cost(cfg, shape, m, axes)["flops"]
    want = ref["cost"][name]["flops"]
    assert 0.85 <= got / want <= 1.0, (got, want, got / want)


def test_argument_bytes_against_memory_analysis(mesh, ref):
    m, axes = mesh
    meta = ref["cost"]["meta"]
    name, arch, over, shp = next(c for c in meta["cells"]
                                 if c[0] == meta["mem_cell"])
    cfg, shape = _cell(arch, over, shp)
    _, in_sh, args, donate = dryrun.build_cell(cfg, shape, m, axes)
    outs, out_sh = dryrun.output_specs(cfg, shape, args, in_sh, m, axes)
    want = ref["cost"]["mem"]
    assert dryrun.device_bytes(args, in_sh) == want["argument"]
    assert sum(dryrun.device_bytes(args[i], in_sh[i])
               for i in donate) == want["alias"]
    n_out = len(T.leaves(outs))
    assert dryrun.device_bytes(outs, out_sh) + 8 * n_out == want["output"]


OUT_CELLS = CELLS + (
    ("dense-decode", "llama3-8b", {}, ("decode_s", 64, 4, "decode")),
    ("vlm-prefill", "llava-next-mistral-7b", {},
     ("prefill_s", 64, 4, "prefill")),
    ("moe-decode", "dbrx-132b", {}, ("decode_s", 64, 4, "decode")),
    ("ssm-decode", "mamba2-370m", {}, ("decode_s", 64, 4, "decode")),
    ("dense-prefill", "qwen3-0.6b", {}, ("prefill_s", 64, 4, "prefill")))


@pytest.mark.parametrize("name,arch,over,shp", OUT_CELLS,
                         ids=[c[0] for c in OUT_CELLS])
def test_output_specs_match_the_step_run_on_meta(name, arch, over, shp,
                                                 mesh):
    """`output_specs` (the step's contract) `==` the outputs of the cell's
    step run on meta at full depth, leaf for leaf, and every layout
    fits."""
    m, axes = mesh
    cfg, shape = _cell(arch, over, shp)
    fn, in_sh, args, _ = dryrun.build_cell(cfg, shape, m, axes)
    with M.use_mesh(m):
        got = fn(*args)
    want, out_sh = dryrun.output_specs(cfg, shape, args, in_sh, m, axes)
    gl, wl = T.leaves_with_paths(got), T.leaves_with_paths(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, a), (_, b) in zip(gl, wl):
        if isinstance(b, torch.Tensor):
            assert (tuple(a.shape), a.dtype) == (tuple(b.shape), b.dtype), \
                path
        else:
            assert not isinstance(a, torch.Tensor), path
    dryrun.device_bytes(want, out_sh)


def _moe_inputs(cfg, B, S, dev="meta"):
    D, E, ff, k = cfg.d_model, cfg.n_experts, cfg.d_ff, cfg.moe_top_k
    e = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device=dev)
    p = dict(w1=e(E, D, ff), w3=e(E, D, ff), w2=e(E, ff, D))
    from repro_torch.models import layers as L
    return (p, e(B, S, D, dt=L.torch_dtype(cfg.dtype)),
            e(B, S, k, dt=torch.int32), e(B, S, k))


@pytest.mark.parametrize("mode", ["fwd", "grad"])
@pytest.mark.parametrize("path", ["a2a", "rep", "ep2d"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_collectives_against_the_reference_hlo(dtype, path, mode, mesh,
                                                   ref):
    """The counter's bytes per kind against `collective_bytes` of the
    reference's compiled HLO (the relation in the module docstring)."""
    from repro_torch.models import moe
    m, axes = mesh
    meta = ref["coll"]["meta"]
    cfg = dataclasses.replace(CB.reduced(CB.get(meta["coll_arch"])),
                              dtype=dtype)
    B, S = meta["coll_bs"]
    cf = meta["coll_capacity"]
    p, x, eid, gate = _moe_inputs(cfg, B, S)

    def fwd(p_, x_, g_):
        with M.use_mesh(m):
            if path == "ep2d":
                return moe.moe_ffn_ep2d(p_, x_, eid, g_, cfg, m, axes,
                                        capacity_factor=cf)
            return moe.moe_ffn(p_, x_, eid, g_, cfg, m, axes,
                               capacity_factor=cf, shard_seq=path == "a2a")

    with M.count_collectives() as log:
        if mode == "fwd":
            fwd(p, x, gate)
        else:
            leaves = [t.requires_grad_(True) for t in
                      (p["w1"], p["w3"], p["w2"], x, gate)]
            torch.autograd.grad(fwd(p, x, gate).float().sum(), leaves)
    got = RL.collective_bytes(log)
    want = ref["coll"][f"{dtype}/{path}/{mode}"]
    widen = 2 if dtype == "bfloat16" else 1
    n = axes["ndp"] if path == "ep2d" else axes["ntp"]
    E_loc = cfg.n_experts // n
    D, ff, k = cfg.d_model, cfg.d_ff, cfg.moe_top_k
    b = B // axes["ndp"]
    s = S // axes["ntp"] if path != "rep" else S
    C_send = max(1, int(round(b * s * k / n * cf)))
    ids = n * C_send * 4 if path != "rep" else 0
    assert set(got) <= {"all-to-all", "all-reduce"}
    assert want.get("all-to-all", 0) == widen * got.get("all-to-all", 0) \
        - (widen - 1) * ids
    stacks = 3 * E_loc * D * ff * 4 if mode == "grad" else 0
    gates = b * s * k * 4 if (mode == "grad" and path == "rep") else 0
    assert want.get("all-reduce", 0) == widen * got.get("all-reduce", 0) \
        + stacks + gates
    if path != "rep":      # the formula phase 34 prints
        fwd_b = n * C_send * (2 * D * x.element_size() + 4)
        bwd_b = n * C_send * 2 * D * x.element_size()
        assert got["all-to-all"] == fwd_b + (bwd_b if mode == "grad" else 0)


def test_dispatch_log_masks_are_not_counted(mesh):
    """The kept-slot masks a dispatch log sends are not collectives of
    the program; the expert ids travel as int32."""
    from repro_torch.models import moe
    m, axes = mesh
    cfg = CB.reduced(CB.get("arctic-480b"))
    p, x, eid, gate = _moe_inputs(cfg, 4, 16)
    runs = []
    for log in (False, True):
        with M.use_mesh(m), M.count_collectives() as sched:
            if log:
                with moe.record_dispatches():
                    moe.moe_ffn(p, x, eid, gate, cfg, m, axes)
                    moe.moe_ffn(p, x[:, :1], eid[:, :1], gate[:, :1], cfg,
                                m, axes, shard_seq=False)
            else:
                moe.moe_ffn(p, x, eid, gate, cfg, m, axes)
                moe.moe_ffn(p, x[:, :1], eid[:, :1], gate[:, :1], cfg, m,
                            axes, shard_seq=False)
        runs.append(sched)
    assert runs[0] == runs[1]
    assert [k for k, _ in runs[0]] == ["all-to-all"] * 3 + ["all-reduce"]
    n, C_send = axes["ntp"], 32
    assert runs[0][1] == ("all-to-all", n * C_send * 4)


def test_collectives_backward_values_equal_autograds_copies(monkeypatch):
    """`all_to_all` / `psum_over` as autograd functions give the values
    and gradients of the plain copies they replace (on the CPU)."""
    monkeypatch.setenv(M.LOGICAL_DEVICES, "4")
    m = M.make_host_mesh(device="cpu")
    g = torch.Generator().manual_seed(0)
    parts = {c: torch.randn(4, 6, generator=g, dtype=torch.float64,
                            requires_grad=True) for c in m.cells()}
    plain = {c: p.detach().clone().requires_grad_(True)
             for c, p in parts.items()}
    for op in ("a2a", "psum"):
        run = ((lambda x, **k: M.all_to_all(x, m, "model", 0, 1, **k))
               if op == "a2a" else
               (lambda x, **k: M.psum_over(x, m, "model", **k)))
        out = run(parts)
        cot = {c: torch.randn(out[c].shape, generator=g, dtype=torch.float64)
               for c in m.cells()}
        gs = torch.autograd.grad(sum((out[c] * cot[c]).sum()
                                     for c in m.cells()),
                                 list(parts.values()))
        with torch.no_grad():
            bare = run(parts, count=False)
        if op == "a2a":
            ref_out = M._a2a(plain, m, "model", 0, 1)
        else:
            ref_out = {}
            for grp in m.groups("model"):
                tot = sum(plain[c] for c in grp)
                ref_out |= {c: tot for c in grp}
        ref_gs = torch.autograd.grad(
            sum((ref_out[c] * cot[c]).sum() for c in m.cells()),
            list(plain.values()))
        for c in m.cells():
            assert torch.equal(out[c].detach(), ref_out[c].detach())
            assert torch.equal(bare[c], ref_out[c].detach())
        for a, b in zip(gs, ref_gs):
            assert torch.allclose(a, b, rtol=0, atol=1e-12)


# --------------------------------------------------------------------------
# entry points on the CPU
# --------------------------------------------------------------------------


class _registered:
    """``cfg`` under its name and ``shape`` in `SHAPES` for the block."""

    def __init__(self, cfg, shape):
        self.cfg, self.shape = cfg, shape

    def __enter__(self):
        self.get, CB.get = CB.get, lambda n: (
            self.cfg if n == self.cfg.name else self.get(n))
        CB.SHAPES[self.shape.name] = self.shape
        return self

    def __exit__(self, *exc):
        CB.get = self.get
        CB.SHAPES.pop(self.shape.name)


@pytest.mark.parametrize("arch", ["llama3-8b", "arctic-480b", "mamba2-370m",
                                  "zamba2-7b", "seamless-m4t-large-v2",
                                  "llava-next-mistral-7b"])
def test_run_cell_records_equal_the_analytic_functions(arch, mesh, tmp_path):
    m, axes = mesh
    cfg = dataclasses.replace(CB.reduced(CB.get(arch)),
                              **({"L": 5} if arch == "zamba2-7b" else {}))
    for shp in (("train_s", 64, 8, "train"), ("prefill_s", 64, 4, "prefill"),
                ("decode_s", 64, 4, "decode")):
        shape = CB.ShapeSpec(*shp)
        with _registered(cfg, shape):
            rec = dryrun.run_cell(arch, shape.name, m, do_roofline=True,
                                  outdir=str(tmp_path), mesh_tag="2x2")
        on_disk = json.loads((tmp_path / "2x2" / f"{arch}__{shape.name}.json"
                              ).read_text())
        assert on_disk == json.loads(json.dumps(rec))
        r = rec["roofline"]
        assert r["model_flops_global"] == RL.model_flops(cfg, shape,
                                                         axes["ntp"])
        assert (r["params_total"], r["params_active"]) == RL.param_counts(
            cfg, axes["ntp"])
        assert r["hbm_bytes_per_chip"] == RL.analytic_hbm_bytes(cfg, shape,
                                                                 axes)
        assert rec["cost_analysis"]["bytes_accessed"] == \
            r["hbm_bytes_per_chip"]
        assert rec["cost_analysis"]["flops"] == r["hlo_flops_per_chip"] > 0
        db = rec["device_bytes"]
        assert db["temp"] is None and db["peak_source"] == \
            "meta, no temporaries"
        assert db["peak_gib"] == round(
            (db["argument"] + db["output"] - db["alias"]) / 2 ** 30, 3)
        assert rec["nchips"] == 4 and "count_s" in rec
        assert set(rec["sources"]) >= {"cost_analysis.flops",
                                       "device_bytes.argument"}
        if cfg.family == "moe" and shape.kind != "decode":
            assert rec["collective_schedule_head"][0][0] == "all-to-all"


def test_perf_run_without_and_with_mem(tmp_path, monkeypatch):
    monkeypatch.delenv(M.LOGICAL_DEVICES, raising=False)
    env = dict(os.environ)
    rec = perf.run("qwen3-0.6b", "decode_32k", [("L", 2)], "t", False,
                   outdir=str(tmp_path))
    assert dict(os.environ) == env
    assert json.loads((tmp_path / "qwen3-0.6b__decode_32k__t.json")
                      .read_text())["flops"] == rec["flops"] > 0
    assert rec["overrides"] == {"L": 2} and "peak_gib" not in rec
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="card"):
        perf.run("qwen3-0.6b", "decode_32k", [("L", 2)], "t", True,
                 outdir=str(tmp_path))
    with pytest.raises(RuntimeError, match="card"):
        perf.measure_peak(CB.get("qwen3-0.6b"), CB.SHAPES["decode_32k"])


def test_dryrun_main_exit_codes_and_environment(tmp_path, monkeypatch,
                                                capsys):
    monkeypatch.delenv(M.LOGICAL_DEVICES, raising=False)
    env = dict(os.environ)
    out = str(tmp_path / "dr")
    assert dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k",
                        "--roofline", "--out", out]) == 0
    assert dryrun.main(["--arch", "qwen3-0.6b", "--shape", "long_500k",
                        "--out", out]) == 0
    assert dict(os.environ) == env
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("OK   qwen3-0.6b") and lines[1].startswith(
        "SKIP qwen3-0.6b")
    monkeypatch.setattr(dryrun, "run_cell", lambda *a, **k: 1 / 0)
    assert dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k",
                        "--out", out]) == 1
    assert capsys.readouterr().out.startswith("FAIL qwen3-0.6b")
    assert dict(os.environ) == env
    rec = json.loads((tmp_path / "dr" / "16x16" /
                      "qwen3-0.6b__decode_32k.json").read_text())
    assert rec["nchips"] == 256 and rec["mesh"] == "16x16"


def test_modules_leave_the_environment_at_import():
    code = ("import os, sys; before = dict(os.environ); "
            "import repro_torch.launch.dryrun, repro_torch.launch.perf, "
            "repro_torch.launch.report; "
            "sys.exit(0 if dict(os.environ) == before else 3)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop(M.LOGICAL_DEVICES, None)
    assert subprocess.run([sys.executable, "-c", code], env=env,
                          timeout=120).returncode == 0
