"""NCF baselines the paper compares against in Table 10 — GMF, MLP, NeuMF
(He et al. 2017), implicit feedback with BCE loss and HR@K evaluation
(`repro/core/ncf.py`).

The JAX package computes them with plain XLA products, so the port's
counterpart is plain PyTorch (``@``, `relu`): no kernel.  Parameters are
a dict of float32 tensors with the JAX package's keys (``mlp_w`` /
``mlp_b`` are lists), drawn from the same threefry streams
(`repro_torch.prng`), so one key gives both packages the same model.
The gradient comes from `torch.autograd`; the Adam update is written
out, with the reference's bias correction and ε = 1e-8.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import prng
from repro_torch import tree as T
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class NCFConfig:
    M: int
    N: int
    F: int = 16
    mlp_layers: tuple = (64, 32, 16)
    kind: str = "neumf"  # gmf | mlp | neumf


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(np.float32(x), device=device)


def init(cfg: NCFConfig, key: torch.Tensor, device=None) -> dict:
    """The JAX package's `init`: N(0, 0.01²) embeddings, a He-scaled
    tower, zero biases.  ``key`` is a `prng` key (on the CPU)."""
    dev = resolve_device(device)
    ks = prng.split(key, 8)
    s = _f32(0.01, dev)
    normal = lambda k, shape: prng.normal(k, shape, device=dev)
    p = {}
    if cfg.kind in ("gmf", "neumf"):
        p["gmf_u"] = s * normal(ks[0], (cfg.M, cfg.F))
        p["gmf_v"] = s * normal(ks[1], (cfg.N, cfg.F))
        p["gmf_h"] = s * normal(ks[2], (cfg.F,))
    if cfg.kind in ("mlp", "neumf"):
        p["mlp_u"] = s * normal(ks[3], (cfg.M, cfg.F))
        p["mlp_v"] = s * normal(ks[4], (cfg.N, cfg.F))
        dims = (2 * cfg.F,) + tuple(cfg.mlp_layers)
        # sqrt(2 / fan_in) in float32, as `jnp.sqrt` of a weak float
        p["mlp_w"] = [torch.sqrt(_f32(2.0 / dims[li], dev))
                      * normal(prng.fold_in(ks[5], li),
                               (dims[li], dims[li + 1]))
                      for li in range(len(dims) - 1)]
        p["mlp_b"] = [torch.zeros((d,), dtype=torch.float32, device=dev)
                      for d in dims[1:]]
        p["mlp_h"] = (torch.sqrt(_f32(1.0 / cfg.mlp_layers[-1], dev))
                      * normal(ks[6], (cfg.mlp_layers[-1],)))
    return p


def logits(p: dict, cfg: NCFConfig, i, j) -> torch.Tensor:
    """The model's logit for each (user ``i``, item ``j``) pair; ``i`` and
    ``j`` may have any (equal) shape."""
    i, j = i.long(), j.long()
    parts = []
    if cfg.kind in ("gmf", "neumf"):
        parts.append((p["gmf_u"][i] * p["gmf_v"][j]) @ p["gmf_h"])
    if cfg.kind in ("mlp", "neumf"):
        x = torch.cat([p["mlp_u"][i], p["mlp_v"][j]], dim=-1)
        for w, b in zip(p["mlp_w"], p["mlp_b"]):
            x = torch.relu(x @ w + b)
        parts.append(x @ p["mlp_h"])
    return sum(parts)


def bce(z, y) -> torch.Tensor:
    """Mean binary cross-entropy of logits ``z`` against labels ``y``, in
    the numerically stable form."""
    return torch.mean(torch.maximum(z, torch.zeros_like(z)) - z * y
                      + torch.log1p(torch.exp(-torch.abs(z))))


def bce_loss(p: dict, cfg: NCFConfig, i, j, y) -> torch.Tensor:
    return bce(logits(p, cfg, i, j), y)


def grads(p: dict, cfg: NCFConfig, i, j, y) -> dict:
    """∂ `bce_loss` / ∂p by autograd, as a dict shaped like ``p``."""
    q = T.tree_map(lambda a: a.detach().requires_grad_(True), p)
    return T.unflatten(q, list(torch.autograd.grad(
        bce_loss(q, cfg, i, j, y), T.leaves(q))))


def adam_update(p, m, v, g, t, lr=1e-3, b1=0.9, b2=0.999):
    """One Adam update of ``p`` from gradients ``g`` at step ``t`` (≥ 1),
    in float32 as the JAX package computes it → (p, m, v)."""
    dev = T.leaves(p)[0].device
    t = _f32(float(t), dev)
    b1_, b2_ = _f32(b1, dev), _f32(b2, dev)
    m = T.tree_map(lambda a, b: b1 * a + (1 - b1) * b, m, g)
    v = T.tree_map(lambda a, b: b2 * a + (1 - b2) * b * b, v, g)
    c1, c2 = 1 - b1_ ** t, 1 - b2_ ** t
    mh = T.tree_map(lambda a: a / c1, m)
    vh = T.tree_map(lambda a: a / c2, v)
    p = T.tree_map(lambda a, mm, vv: a - lr * mm / (torch.sqrt(vv) + 1e-8),
                 p, mh, vh)
    return p, m, v


def adam_step(p, m, v, t, cfg: NCFConfig, i, j, y, lr=1e-3, b1=0.9,
              b2=0.999):
    """One full-batch Adam step on the BCE loss → (p, m, v)."""
    g = grads(p, cfg, i, j, y)
    with torch.no_grad():
        return adam_update(p, m, v, g, t, lr=lr, b1=b1, b2=b2)


@torch.no_grad()
def hit_ratio(p: dict, cfg: NCFConfig, users, pos_items, cand_items,
              topk: int = 10) -> torch.Tensor:
    """HR@K with the standard 1-positive + sampled-negatives protocol: a
    user hits when fewer than ``topk`` candidates score strictly above
    the held-out positive."""
    items = torch.cat([pos_items[:, None], cand_items], dim=1)
    z = logits(p, cfg, users[:, None].expand_as(items), items)
    rank = (z > z[:, :1]).sum(1)
    return (rank < topk).float().mean()
