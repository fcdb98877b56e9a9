"""Multi-pod dry run: count every (arch × shape × mesh) cell on meta
tensors (`repro/launch/dryrun.py`).

For each cell:
  * parameters, optimiser state, batches and caches are meta tensors
    (`launch/specs.py`: nothing is allocated) with their
    `sharding.to_named` layouts on the production mesh of logical cells
    — 16 × 16 on one pod, 2 × 16 × 16 over two;
  * the cell's products and collectives are counted on the mesh
    (`roofline.extract_cost`: the reference's L1/L2 composition of
    probes, see `launch/roofline.py`), and its per-device argument,
    output and donated bytes read from the meta shard shapes;
  * the record goes to ``<out>/<mesh>/<arch>__<shape>.json``, in the
    reference's keys wherever they have a counterpart.

The reference compiles each cell with XLA and reads
`memory_analysis()`, `cost_analysis()` and the collectives of the HLO
text.  The port's record takes each field from one of these sources
and says which in its ``sources`` map: products counted on meta tensors
(per chip = the mesh-wide count / nchips), bytes from
`analytic_hbm_bytes`, collective bytes counted from the port's own
`all_to_all` / `psum_over`, argument / output / alias bytes from the
meta shard shapes.  Temporaries are unknown without a card: ``temp`` is
null and ``peak_gib`` = (argument + output − alias) / 2³⁰, marked
``"meta, no temporaries"``; `launch/perf.py --mem` measures a peak on
the card.  ``lower_s`` / ``compile_s`` become ``count_s``.

`main` sets ``REPRO_TORCH_LOGICAL_DEVICES`` (512) while it runs, as the
reference sets ``XLA_FLAGS``: the production meshes are logical cells
of the meta device.  Importing this module changes nothing.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--roofline]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback

import torch

from repro_torch import tree as T
from repro_torch.configs import base as CB
from repro_torch.launch import roofline as RL
from repro_torch.launch import specs as SPECS
from repro_torch.launch.mesh import LOGICAL_DEVICES, make_production_mesh
from repro_torch.models import lm, sharding, steps

DRYRUN_DEVICES = "512"      # the multi-pod mesh's cells

SOURCES = {
    "cost_analysis.flops": "products counted on meta tensors "
                           "(FlopCounterMode), fixed + L·layer over the L1/L2 "
                           "probes × µ, mesh-wide / nchips",
    "cost_analysis.flops_global": "the same count, mesh-wide (an integer)",
    "cost_analysis.bytes_accessed": "analytic_hbm_bytes",
    "collectives_in_module": "the port's all_to_all / psum_over counted "
                             "(count_collectives), per device, composed as "
                             "the products",
    "collective_schedule_head": "count_collectives of the L1 probe, in "
                                "program order",
    "device_bytes.argument": "shard_shape of the meta arguments",
    "device_bytes.output": "shard_shape of the outputs' meta tree",
    "device_bytes.alias": "the donated arguments",
    "device_bytes.temp": "unknown without a card",
    "device_bytes.peak_gib": "meta, no temporaries",
    "roofline": "roofline.py at the H100 SXM data-sheet rates",
}


def build_cell(cfg, shape, mesh, axes):
    """(fn, in_shardings, args, donate) for the full config: meta
    arguments and their `NamedSharding` trees."""
    params = SPECS.param_specs(cfg, axes["ntp"])
    psp = sharding.to_named(sharding.param_specs(cfg, params, axes), mesh)
    if shape.kind == "train":
        opt = steps.init_opt(cfg, params)
        osp = dict(m=psp, v=psp, count=sharding.to_named(sharding.P(), mesh))
        batch = SPECS.batch_specs_for(cfg, shape)
        bsp = sharding.to_named(sharding.batch_specs(cfg, batch, axes), mesh)
        fn = steps.make_train_step(cfg, mesh, axes)
        return (fn, (psp, osp, bsp), (params, opt, batch), (0, 1))
    if shape.kind == "prefill":
        batch = SPECS.prefill_specs_for(cfg, shape)
        bsp = sharding.to_named(sharding.batch_specs(cfg, batch, axes), mesh)
        fn = steps.make_prefill(cfg, mesh, axes)
        return (fn, (psp, bsp), (params, batch), ())
    cache, tokens = SPECS.decode_specs_for(cfg, shape)
    csp = sharding.to_named(sharding.cache_specs(cfg, cache, axes), mesh)
    tsp = sharding.to_named(
        sharding.batch_specs(cfg, {"tokens": tokens}, axes), mesh)["tokens"]
    fn = steps.make_decode_step(cfg, mesh, axes)
    return (fn, (psp, csp, tsp), (params, cache, tokens), (1,))


def output_specs(cfg, shape, args, in_shardings, mesh, axes):
    """(the cell's outputs as a meta tree, their `NamedSharding`s), from
    the step's contract rather than a run: a train step returns the
    parameters and moments in their own layouts and two float32 scalars;
    prefill the last position's float32 logits [B, V] and, for the K/V
    families, the K/V cache of the prompt (`cache_specs`); a decode step
    the logits [B, 1, V] and its cache.  The logits are laid out as the
    vocab-sharded table (`lm.shard_vocab`), the batch over the data axes
    where they divide it."""
    rep = sharding.to_named(sharding.P(), mesh)
    if shape.kind == "train":
        params, opt, _ = args
        psp, osp, _ = in_shardings
        scalar = SPECS.meta((), torch.float32)
        return ((params, opt, {"loss": scalar, "gnorm": scalar}),
                (psp, osp, {"loss": rep, "gnorm": rep}))
    B, V = shape.global_batch, cfg.vocab_padded(axes["ntp"])
    b_ax = sharding._b_ax(B, axes)
    if shape.kind == "prefill":
        logits = SPECS.meta((B, V), torch.float32)
        lsp = sharding.P(b_ax, axes["tp"])
        cache = {"pos": 0}
        T_all = sum(args[1][k].shape[1] for k in ("frontend_embeds", "tokens")
                    if k in args[1])
        if cfg.family in lm.KV_FAMILIES:
            full = steps.init_cache(cfg, B, T_all, device="meta")
            cache |= {k: full[k] for k in ("k", "v")}
        csp = sharding.to_named(sharding.cache_specs(cfg, cache, axes), mesh)
        return ((logits, cache), (sharding.to_named(lsp, mesh), csp))
    _, cache, _ = args
    _, csp, _ = in_shardings
    logits = SPECS.meta((B, 1, V), torch.float32)
    lsp = sharding.to_named(sharding.P(b_ax, None, axes["tp"]), mesh)
    return ((logits, cache), (lsp, csp))


def device_bytes(tree, shardings) -> int:
    """The bytes one device holds of ``tree``'s tensors under
    ``shardings`` (a tree of `NamedSharding`s of the same structure;
    `shard_shape` raises where a block would not be whole).  A leaf that is not a tensor (a cache's ``pos``) holds none."""
    total = 0
    for leaf, sh in zip(T.leaves(tree), T.leaves(shardings), strict=True):
        if isinstance(leaf, torch.Tensor):
            n = 1
            for d in sh.shard_shape(leaf.shape):
                n *= d
            total += n * leaf.element_size()
    return total


def run_cell(arch: str, shape_name: str, mesh, *, do_roofline: bool,
             outdir: str, mesh_tag: str) -> dict:
    cfg = CB.get(arch)
    shape = CB.SHAPES[shape_name]
    ok, why = CB.runnable(cfg, shape)
    rec = dict(arch=arch, shape=shape_name, mesh=mesh_tag, skipped=not ok,
               skip_reason=why)
    if ok:
        axes = sharding.mesh_axes(mesh)
        t0 = time.time()
        fn, in_sh, args, donate = build_cell(cfg, shape, mesh, axes)
        outs, out_sh = output_specs(cfg, shape, args, in_sh, mesh, axes)
        arg_b = device_bytes(args, in_sh)
        out_b = device_bytes(outs, out_sh)
        alias_b = sum(device_bytes(args[i], in_sh[i]) for i in donate)
        cost = RL.extract_cost(cfg, shape, mesh, axes)
        t_count = time.time() - t0
        nchips = mesh.size
        rec |= dict(
            count_s=round(t_count, 1),
            device_bytes=dict(
                argument=arg_b, output=out_b, temp=None, alias=alias_b,
                peak_gib=round((arg_b + out_b - alias_b) / 2**30, 3),
                peak_source="meta, no temporaries"),
            cost_analysis=dict(
                flops=cost["flops"],
                flops_global=cost["flops_global"],
                bytes_accessed=cost["bytes"],
                note="per chip: products counted on meta tensors, the "
                     "mesh-wide count / nchips, composed over the full "
                     "depth; bytes analytic"),
            collectives_in_module=cost["coll"],
            collective_schedule_head=RL.collective_schedule(
                cost["schedule"], 40),
            nchips=nchips,
            sources=SOURCES,
        )
        if do_roofline:
            mf = RL.model_flops(cfg, shape, axes["ntp"])
            total_p, active_p = RL.param_counts(cfg, axes["ntp"])
            rl = RL.roofline(cost, nchips)
            rec |= dict(
                roofline=dict(
                    **rl,
                    hlo_flops_per_chip=cost["flops"],
                    hbm_bytes_per_chip=cost["bytes"],
                    hbm_bytes_xla_upper=cost.get("bytes_xla_upper"),
                    coll_bytes_raw=cost.get("coll_bytes_raw"),
                    coll_bytes_per_chip=cost["coll_bytes"],
                    coll_by_kind=cost["coll"],
                    model_flops_global=mf,
                    params_total=total_p, params_active=active_p,
                    useful_ratio=(mf / nchips) / max(cost["flops"], 1.0),
                    mfu_bound=(mf / nchips / RL.PEAK_FLOPS)
                    / max(rl["t_step"], 1e-12),
                ))
    os.makedirs(f"{outdir}/{mesh_tag}", exist_ok=True)
    path = f"{outdir}/{mesh_tag}/{arch}__{shape_name}.json"
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


@contextlib.contextmanager
def production_cells():
    """``REPRO_TORCH_LOGICAL_DEVICES`` at 512 for the block (the
    production meshes' logical cells), restored after it."""
    prev = os.environ.get(LOGICAL_DEVICES)
    os.environ[LOGICAL_DEVICES] = DRYRUN_DEVICES
    try:
        yield
    finally:
        if prev is None:
            del os.environ[LOGICAL_DEVICES]
        else:
            os.environ[LOGICAL_DEVICES] = prev


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--roofline", action="store_true")
    ap.add_argument("--out", default="reports/dryrun")
    args = ap.parse_args(argv)

    cells = (CB.cells(include_skips=True) if args.all
             else [(args.arch, args.shape, *CB.runnable(
                 CB.get(args.arch), CB.SHAPES[args.shape]))])
    mesh_tag = "2x16x16" if args.multi_pod else "16x16"
    failed = 0
    with production_cells():
        mesh = make_production_mesh(multi_pod=args.multi_pod, device="meta")
        for (arch, shape_name, ok, why) in cells:
            try:
                rec = run_cell(arch, shape_name, mesh,
                               do_roofline=args.roofline, outdir=args.out,
                               mesh_tag=mesh_tag)
                if rec.get("skipped"):
                    print(f"SKIP {arch:24s} {shape_name:12s} {why}")
                else:
                    r = rec.get("roofline", {})
                    print(f"OK   {arch:24s} {shape_name:12s} "
                          f"peak={rec['device_bytes']['peak_gib']:7.2f}GiB "
                          f"count={rec['count_s']:6.1f}s "
                          + (f"bound={r.get('bound', '')}" if r else ""),
                          flush=True)
            except Exception as e:
                failed += 1
                print(f"FAIL {arch:24s} {shape_name:12s} "
                      f"{type(e).__name__}: {e}", flush=True)
                traceback.print_exc()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
