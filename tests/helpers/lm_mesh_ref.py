"""The JAX package's LM mesh paths on a 2 × 2 ("data", "model") mesh of
four host devices: the reference side of `tests/test_torch_lm_mesh.py`.

Run as ``python tests/helpers/lm_mesh_ref.py <group> <out.npz>`` (own
XLA device count, so in a subprocess of its own); writes every input it
drew and every output the port is compared with.  Groups: ``moe``
(`moe_ffn` a2a and rep, `moe_ffn_ep2d`, with their gradients) and one a
model config (`MODELS`): `make_prefill`, one `make_decode_step` after
it and one `make_train_step`, at float32 and bfloat16 compute, each
jitted under `use_mesh`.  Layers are unrolled (``unroll_layers``, the
same values as the scan) so that each layer's routes can be returned
beside the logits.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import dataclasses  # noqa: E402
import json  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))
from repro.configs import base as CB  # noqa: E402
from repro.launch.mesh import compat_mesh, use_mesh  # noqa: E402
from repro.models import lm, moe, steps  # noqa: E402
from repro.models import sharding as SH  # noqa: E402

# moe_ffn cases: (config, overrides, capacity factor); x is [B, S, D]
MOE_CASES = (("arctic-480b", {}, 16.0), ("arctic-480b", {}, 0.5),
             ("dbrx-132b", dict(n_experts=16, moe_top_k=4), 0.5))
MOE_BS = (4, 16)
N_DIRS = 3
PATHS = ("a2a", "rep", "ep2d")
# model cases: name → (config, overrides); arctic at capacity 1.0, where
# its dispatch drops slots at this batch
MODELS = {"dbrx": ("dbrx-132b", {}),
          "arctic": ("arctic-480b", dict(moe_capacity=1.0)),
          "arctic-ep2d": ("arctic-480b", dict(moe_capacity=1.0,
                                              moe_ep2d=True)),
          "dense": ("qwen3-0.6b", {})}
DTYPES = ("float32", "bfloat16")
B, S, T_CACHE = 4, 16, 24


def flat(tree, prefix):
    """A nested dict of arrays → {prefix/path: float32 or int numpy}."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        a = np.asarray(leaf)
        out[f"{prefix}/{key}"] = (a.astype(np.float32)
                                  if a.dtype == jnp.bfloat16 else a)
    return out


class Routes:
    """`moe.router` wrapped to keep each call's expert ids (traced values
    of the jitted function being built, returned as its outputs)."""

    def __init__(self):
        self.orig, self.ids = moe.router, []

    def __enter__(self):
        def rec(p, x, cfg):
            eid, gate = self.orig(p, x, cfg)
            self.ids.append(eid)
            return eid, gate
        moe.router = rec
        return self

    def __exit__(self, *exc):
        moe.router = self.orig


def with_routes(fn):
    """``fn`` → a function returning (fn's result, the routes of its
    router calls, in call order)."""
    def run(*args):
        with Routes() as r:
            out = fn(*args)
        return out, r.ids
    return run


def moe_group(mesh, axes):
    out = {}
    for ci, (name, over, cf) in enumerate(MOE_CASES):
        cfg = dataclasses.replace(CB.reduced(CB.get(name)), dtype="float32",
                                  **over)
        rng = np.random.default_rng(100 + ci)
        D, E, ff = cfg.d_model, cfg.n_experts, cfg.d_ff
        f = lambda *s, sd=0.05: (sd * rng.normal(size=s)).astype(np.float32)
        p = dict(router=f(D, E, sd=0.1), w1=f(E, D, ff), w3=f(E, D, ff),
                 w2=f(E, ff, D))
        x, cot = f(*MOE_BS, D, sd=1.0), f(*MOE_BS, D, sd=1.0)
        jp = {k: jnp.asarray(v) for k, v in p.items()}
        eid, gate = jax.jit(lambda p_, x_: moe.router(p_, x_, cfg))(
            jp, jnp.asarray(x))
        pre = f"moe{ci}"
        out |= {f"{pre}/x": x, f"{pre}/cot": cot, f"{pre}/eid":
                np.asarray(eid), f"{pre}/gate": np.asarray(gate)}
        out |= {f"{pre}/p/{k}": v for k, v in p.items()}
        for path in PATHS:
            def loss(x_, g_, w1, w3, w2, path=path):
                q = dict(jp, w1=w1, w3=w3, w2=w2)
                if path == "ep2d":
                    y = moe.moe_ffn_ep2d(q, x_, eid, g_, cfg, mesh, axes,
                                         capacity_factor=cf)
                else:
                    y = moe.moe_ffn(q, x_, eid, g_, cfg, mesh, axes,
                                    capacity_factor=cf,
                                    shard_seq=path == "a2a")
                return jnp.sum(y * jnp.asarray(cot)), y
            (_, y), g = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(
                jnp.asarray(x), gate, jp["w1"], jp["w3"], jp["w2"])
            out[f"{pre}/{path}/y"] = np.asarray(y)
            for n, a in zip(("x", "gate", "w1", "w3", "w2"), g):
                out[f"{pre}/{path}/g_{n}"] = np.asarray(a)
            if path == "rep":
                # under jax 0.9 the rep path's reverse-mode x gradient
                # disagrees with finite differences; its forward-mode
                # derivative agrees with them: keep it along N_DIRS
                # directions
                dirs = f(N_DIRS, *MOE_BS, D, sd=1.0)
                fx = lambda x_: loss(x_, gate, jp["w1"], jp["w3"],
                                     jp["w2"])[0]
                jvp = jax.jit(lambda d_: jax.jvp(
                    fx, (jnp.asarray(x),), (d_,))[1])
                out[f"{pre}/rep/dirs"] = dirs
                out[f"{pre}/rep/jvp_x"] = np.asarray(
                    [jvp(jnp.asarray(d)) for d in dirs])
    return out


def model_group(key, mesh, axes):
    name, over = MODELS[key]
    out = {}
    for dtype in DTYPES:
        cfg = dataclasses.replace(CB.reduced(CB.get(name)), dtype=dtype,
                                  unroll_layers=True, **over)
        pre = f"{key}/{dtype}"
        params = lm.init_params(cfg, jax.random.PRNGKey(7), model_shards=1)
        rng = np.random.default_rng(200)
        toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        nxt = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        out |= flat(params, f"{pre}/p")
        out |= {f"{pre}/tokens": toks, f"{pre}/next": nxt}
        (lg, cache), eids = jax.jit(with_routes(steps.make_prefill(
            cfg, mesh, axes)))(params, {"tokens": jnp.asarray(toks)})
        out[f"{pre}/prefill/logits"] = np.asarray(lg)
        out[f"{pre}/prefill/k"] = np.asarray(cache["k"], np.float32)
        out[f"{pre}/prefill/v"] = np.asarray(cache["v"], np.float32)
        for i, e in enumerate(eids):
            out[f"{pre}/prefill/eid{i}"] = np.asarray(e)
        c0 = steps.init_cache(cfg, B, T_CACHE, jnp.float32)
        c0 = c0 | {"k": c0["k"].at[:, :, :S].set(cache["k"]),
                   "v": c0["v"].at[:, :, :S].set(cache["v"]),
                   "pos": jnp.asarray(S, jnp.int32)}
        (lg, c1), eids = jax.jit(with_routes(steps.make_decode_step(
            cfg, mesh, axes)))(params, c0, jnp.asarray(nxt))
        out[f"{pre}/decode/logits"] = np.asarray(lg)
        out[f"{pre}/decode/k"] = np.asarray(c1["k"])
        out[f"{pre}/decode/v"] = np.asarray(c1["v"])
        for i, e in enumerate(eids):
            out[f"{pre}/decode/eid{i}"] = np.asarray(e)
        batch = {"tokens": jnp.asarray(toks),
                 "labels": jnp.asarray(np.roll(toks, -1, axis=1))}
        _, opt, aux = jax.jit(steps.make_train_step(cfg, mesh, axes))(
            params, steps.init_opt(cfg, params), batch)
        out[f"{pre}/train/loss"] = np.asarray(aux["loss"])
        out[f"{pre}/train/gnorm"] = np.asarray(aux["gnorm"])
        out |= flat(opt["m"], f"{pre}/train/m")
    return out


def main(group, path):
    mesh = compat_mesh((2, 2), ("data", "model"))
    axes = SH.mesh_axes(mesh)
    with use_mesh(mesh):
        out = moe_group(mesh, axes) if group == "moe" else model_group(
            group, mesh, axes)
    out["meta"] = np.asarray(json.dumps(dict(
        moe_cases=MOE_CASES, paths=PATHS, models=MODELS, dtypes=DTYPES,
        B=B, S=S, T_cache=T_CACHE)))
    np.savez(path, **out)
    print(f"PASS {group} {len(out)} arrays")


if __name__ == "__main__":
    main(*sys.argv[1:3])
