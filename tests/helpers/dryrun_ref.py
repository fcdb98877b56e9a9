"""The JAX package's dry-run numbers on a 2 × 2 ("data", "model") mesh of
four host devices: the reference side of `tests/test_torch_dryrun.py`.

Run as ``python tests/helpers/dryrun_ref.py <group> <out.json>`` (own
XLA device count, so in a subprocess of its own); writes its cases and
numbers as JSON.  Groups:

* ``coll``: `moe_ffn` a2a and rep and `moe_ffn_ep2d` on reduced
  arctic-480b (`COLL_DTYPES`), forward and gradient, each jitted and
  compiled alone: `roofline.collective_bytes` of the compiled HLO, per
  kind;
* ``cost``: `roofline.extract_cost` of each reduced cell in `CELLS`,
  and the `memory_analysis` of `MEM_CELL`'s whole-step compile
  (`dryrun.build_cell`, donated as the dry run donates).
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import dataclasses  # noqa: E402
import json  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))
from repro.configs import base as CB  # noqa: E402
from repro.launch import roofline as RL  # noqa: E402
from repro.launch.mesh import compat_mesh, use_mesh  # noqa: E402
from repro.models import moe  # noqa: E402
from repro.models import sharding as SH  # noqa: E402

# (name, arch, overrides of reduced(arch), (shape name, seq, batch, kind))
CELLS = (("dense-train", "llama3-8b", {"microbatches": 2},
          ("train_s", 64, 8, "train")),
         ("moe-prefill", "arctic-480b", {}, ("prefill_s", 64, 4, "prefill")),
         ("moe-train", "arctic-480b", {}, ("train_s", 64, 4, "train")),
         ("hybrid-prefill", "zamba2-7b", {"L": 5},
          ("prefill_s", 64, 4, "prefill")),
         ("encdec-train", "seamless-m4t-large-v2", {},
          ("train_s", 64, 4, "train")))
MEM_CELL = "dense-train"
COLL_ARCH = "arctic-480b"
COLL_DTYPES = ("float32", "bfloat16")
COLL_PATHS = ("a2a", "rep", "ep2d")
COLL_BS = (4, 16)
COLL_CAPACITY = 2.0


def cell_cfg(arch, over):
    return dataclasses.replace(CB.reduced(CB.get(arch)), **over)


def moe_fn(path, cfg, mesh, axes):
    def f(p, x, eid, gate):
        if path == "ep2d":
            return moe.moe_ffn_ep2d(p, x, eid, gate, cfg, mesh, axes,
                                    capacity_factor=COLL_CAPACITY)
        return moe.moe_ffn(p, x, eid, gate, cfg, mesh, axes,
                           capacity_factor=COLL_CAPACITY,
                           shard_seq=path == "a2a")
    return f


def coll_group(mesh, axes):
    out = {}
    for dtype in COLL_DTYPES:
        cfg = dataclasses.replace(CB.reduced(CB.get(COLL_ARCH)), dtype=dtype)
        D, E, ff, k = cfg.d_model, cfg.n_experts, cfg.d_ff, cfg.moe_top_k
        sds = jax.ShapeDtypeStruct
        f32 = jnp.float32
        p = dict(w1=sds((E, D, ff), f32), w3=sds((E, D, ff), f32),
                 w2=sds((E, ff, D), f32))
        x = sds((*COLL_BS, D), jnp.dtype(dtype))
        eid = sds((*COLL_BS, k), jnp.int32)
        gate = sds((*COLL_BS, k), f32)
        for path in COLL_PATHS:
            fwd = moe_fn(path, cfg, mesh, axes)
            grad = jax.grad(
                lambda p_, x_, g_, e_, fwd=fwd: jnp.sum(
                    fwd(p_, x_, e_, g_).astype(f32)), argnums=(0, 1, 2))
            for mode, fn, args in (("fwd", fwd, (p, x, eid, gate)),
                                   ("grad", grad, (p, x, gate, eid))):
                txt = jax.jit(fn).lower(*args).compile().as_text()
                out[f"{dtype}/{path}/{mode}"] = RL.collective_bytes(txt)
    return out


def cost_group(mesh, axes):
    from repro.launch import dryrun   # sets XLA_FLAGS as this file did
    out = {}
    for name, arch, over, shp in CELLS:
        cfg = cell_cfg(arch, over)
        shape = CB.ShapeSpec(*shp)
        c = RL.extract_cost(cfg, shape, mesh, axes)
        out[name] = dict(flops=c["flops"], coll=c["coll"],
                         coll_bytes_raw=c["coll_bytes_raw"])
        if name == MEM_CELL:
            fn, in_sh, args, donate = dryrun.build_cell(cfg, shape, mesh,
                                                        axes)
            ma = jax.jit(fn, in_shardings=in_sh, donate_argnums=donate
                         ).lower(*args).compile().memory_analysis()
            out["mem"] = dict(argument=ma.argument_size_in_bytes,
                              output=ma.output_size_in_bytes,
                              alias=ma.alias_size_in_bytes,
                              temp=ma.temp_size_in_bytes)
    return out


def main(group, path):
    mesh = compat_mesh((2, 2), ("data", "model"))
    axes = SH.mesh_axes(mesh)
    with use_mesh(mesh):
        out = coll_group(mesh, axes) if group == "coll" else cost_group(
            mesh, axes)
    out["meta"] = dict(cells=CELLS, mem_cell=MEM_CELL, coll_arch=COLL_ARCH,
                       coll_dtypes=COLL_DTYPES, coll_paths=COLL_PATHS,
                       coll_bs=COLL_BS, coll_capacity=COLL_CAPACITY)
    with open(path, "w") as f:
        json.dump(out, f)
    print(f"PASS {group} {len(out)} entries")


if __name__ == "__main__":
    main(*sys.argv[1:3])
