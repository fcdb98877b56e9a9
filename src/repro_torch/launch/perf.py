"""Perf hillclimbing driver (`repro/launch/perf.py`).

Re-derives the roofline terms for one (arch × shape) cell under config
overrides, so each hypothesis → change → measure iteration is one
command:

  PYTHONPATH=src python -m repro_torch.launch.perf --arch llama3-405b \\
      --shape train_4k --tag mb4 --set microbatches=4 [--mem]

Writes ``reports/perf/<arch>__<shape>__<tag>.json`` and prints the
terms.  The cost terms are `roofline.extract_cost`'s on the meta
production mesh (`launch/dryrun.py` says where each comes from).

``--mem`` is where the card comes in.  The reference compiles the cell
for XLA's `memory_analysis`; here the cell's parameters are drawn at
the overrides (``--set L=2``) on the card at one card's axes, with no
mesh, its inputs made there, and one step of the cell run.  The record's
``peak_gib`` is `torch.cuda.max_memory_allocated` above what was
resident before the draw (``peak_source`` names the card), beside the
meta argument bytes of the same cut (``argument_gib``; ``temp_gib`` =
peak − arguments).  Without a card ``--mem`` raises: it never falls back
to the CPU or to the meta estimate.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch import prng
from repro_torch import tree as T
from repro_torch.configs import base as CB
from repro_torch.launch import roofline as RL
from repro_torch.launch import specs as SPECS
from repro_torch.launch.dryrun import production_cells
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm, sharding, steps


def parse_override(kv: str):
    k, v = kv.split("=", 1)
    for cast in (int, float):
        try:
            return k, cast(v)
        except ValueError:
            pass
    if v in ("true", "false"):
        return k, v == "true"
    return k, v


def _on_card(cfg, shape, seed: int = 0):
    """(step, args) of the cell at one card's axes, no mesh: parameters
    drawn on the card, the batch's token ids uniform over the vocab, its
    frontend embeddings N(0, 0.02²), a decode cache of zeros."""
    dev = torch.device("cuda")
    params = lm.init_params(cfg, prng.PRNGKey(seed), model_shards=1,
                            device=dev)
    rng = np.random.default_rng(seed)

    def real(t):
        if t.dtype.is_floating_point:
            return torch.from_numpy(rng.normal(0, 0.02, tuple(t.shape)).astype(
                np.float32)).to(device=dev, dtype=t.dtype)
        return torch.from_numpy(rng.integers(0, cfg.vocab, tuple(t.shape))
                                .astype(np.int32)).to(dev)

    if shape.kind == "train":
        batch = T.tree_map(real, SPECS.batch_specs_for(cfg, shape))
        return steps.make_train_step(cfg), (params, steps.init_opt(cfg, params),
                                            batch)
    if shape.kind == "prefill":
        batch = T.tree_map(real, SPECS.prefill_specs_for(cfg, shape))
        return steps.make_prefill(cfg), (params, batch)
    _, tokens = SPECS.decode_specs_for(cfg, shape)
    cache = steps.init_cache(cfg, shape.global_batch, shape.seq_len,
                             device=dev)
    return steps.make_decode_step(cfg), (params, cache, real(tokens))


def _meta_argument_bytes(cfg, shape) -> int:
    """The bytes of the cell's arguments at one card's axes (meta)."""
    args = [SPECS.param_specs(cfg, 1)]
    if shape.kind == "train":
        args += [steps.init_opt(cfg, args[0]),
                 SPECS.batch_specs_for(cfg, shape)]
    elif shape.kind == "prefill":
        args.append(SPECS.prefill_specs_for(cfg, shape))
    else:
        args += list(SPECS.decode_specs_for(cfg, shape))
    return sum(t.numel() * t.element_size() for t in T.leaves(args)
               if isinstance(t, torch.Tensor))


def _require_card() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("--mem measures the peak on the card, and CUDA is "
                           "not available (no CPU or meta fallback)")


def measure_peak(cfg, shape) -> dict:
    """One step of the cell on the card (module docstring) → its peak
    and the meta argument bytes of the same config."""
    _require_card()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step, args = _on_card(cfg, shape)
    step(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del step, args
    torch.cuda.empty_cache()
    arg_b = _meta_argument_bytes(cfg, shape)
    props = torch.cuda.get_device_properties(0)
    return dict(peak_gib=round(peak / 2**30, 3), peak_bytes=peak,
                peak_source=f"measured on {props.name}, one card",
                argument_gib=round(arg_b / 2**30, 3), argument_bytes=arg_b,
                temp_gib=round((peak - arg_b) / 2**30, 3))


def run(arch, shape_name, overrides, tag, do_mem, multi_pod=False, *,
        outdir: str = "reports/perf"):
    cfg = CB.get(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **dict(overrides))
    shape = CB.SHAPES[shape_name]
    if do_mem:
        _require_card()
    with production_cells():
        mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
        axes = sharding.mesh_axes(mesh)
        t0 = time.time()
        cost = RL.extract_cost(cfg, shape, mesh, axes)
    mf = RL.model_flops(cfg, shape, axes["ntp"])
    rl = RL.roofline(cost, mesh.size)
    rec = dict(arch=arch, shape=shape_name, tag=tag,
               overrides=dict(overrides), **rl,
               flops=cost["flops"], hbm_bytes=cost["bytes"],
               coll_bytes=cost["coll_bytes"], coll=cost["coll"],
               useful_ratio=(mf / mesh.size) / max(cost["flops"], 1.0),
               mfu_bound=(mf / mesh.size / RL.PEAK_FLOPS)
               / max(rl["t_step"], 1e-12))
    if do_mem:
        rec |= measure_peak(cfg, shape)
    rec["wall_s"] = round(time.time() - t0, 1)
    os.makedirs(outdir, exist_ok=True)
    with open(f"{outdir}/{arch}__{shape_name}__{tag}.json", "w") as f:
        json.dump(rec, f, indent=1, default=str)
    print(f"{arch} {shape_name} [{tag}] bound={rec['bound']} "
          f"t_comp={rec['t_compute']*1e3:.1f}ms t_mem={rec['t_memory']*1e3:.1f}ms "
          f"t_coll={rec['t_collective']*1e3:.1f}ms mfu={rec['mfu_bound']:.3f} "
          + (f"peak={rec.get('peak_gib')}GiB" if do_mem else ""))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--mem", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    run(args.arch, args.shape, [parse_override(s) for s in args.set],
        args.tag, args.mem, args.multi_pod)


if __name__ == "__main__":
    main()
