"""Training and serving steps for the dense family
(`repro/models/steps.py`): the loss, Adam, the microbatched train step,
KV caches, prefill and decode.

The JAX package's `make_*` factories close over the config and return
functions for `jax.jit`; these return plain functions.  The other
families' caches and steps raise `NotImplementedError`.

Differences from the JAX package's functional steps, each where the JAX
launch scripts donate the buffers: `adam_update` (and so a train step)
updates the parameters and moments it was given in place, and a decode
step writes the new K/V into the cache it was given; the cache's
``pos`` is a host int.
"""
from __future__ import annotations

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.core import scatter
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import lm

# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------


class _GatherRows(torch.autograd.Function):
    """``E[idx]`` whose backward adds the rows' gradients into ``E``'s in
    index order (`core/scatter.py::index_add_det_`): the ids repeat (a
    label token, a candidate drawn twice), and autograd's own backward
    of an index adds them with atomics on the card, in an order that
    changes from run to run."""

    @staticmethod
    def forward(ctx, E, idx):
        ctx.save_for_backward(idx)
        ctx.rows = E.shape[0]
        return E[idx.long()]

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        gE = torch.zeros((ctx.rows, g.shape[-1]), dtype=g.dtype,
                         device=g.device)
        scatter.index_add_det_(gE, idx.reshape(-1).long(),
                               g.reshape(-1, g.shape[-1]))
        return gE, None


def gather_rows(E: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``E[idx]`` ([*idx.shape, D]) with a deterministic backward."""
    return _GatherRows.apply(E, idx)


def lm_loss(cfg: ArchConfig, p, batch):
    """Mean next-token NLL over ``batch["mask"]`` (default: every token).
    With ``cfg.lsh_softmax`` and ``batch["cands"]`` the normaliser runs
    over the candidates and the label (the paper's technique at the
    softmax, `models/lsh_softmax.py`), else over the whole vocabulary."""
    h = lm.forward(cfg, p, batch)                            # [B, S_all, D]
    labels = batch["labels"]
    S_txt = labels.shape[1]
    if h.shape[1] != S_txt:                                  # frontend prefix
        h = h[:, h.shape[1] - S_txt:]
    E = lm.out_embedding(p, cfg)
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    dt = L.torch_dtype(cfg.dtype)
    # the products of cfg.dtype operands are exact in float32, as the
    # reference's ``preferred_element_type``
    h32 = h.float()
    if cfg.lsh_softmax and "cands" in batch:
        cands = batch["cands"]
        Ec = gather_rows(E, cands).to(dt)                    # [C, D]
        logits_c = h32 @ Ec.float().T
        e_lab = gather_rows(E, labels).to(dt)                # [B, S, D]
        logit_lab = (h32 * e_lab.float()).sum(-1)
        # exclude accidental label hits among the candidates
        hit = cands[None, None, :] == labels[..., None]
        logits_c = torch.where(hit, -1e30, logits_c)
        lse = torch.logaddexp(torch.logsumexp(logits_c, -1), logit_lab)
    else:
        logits = logits_of(cfg, p, h)
        lse = torch.logsumexp(logits, -1)
        # the reference's masked one-hot sum: every other term is an
        # exact 0, so the gathered label column is the same float
        logit_lab = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - logit_lab
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def value_and_grad(cfg: ArchConfig, params, batch):
    """(`lm_loss`, ∂ `lm_loss` / ∂params as a tree shaped like
    ``params``) by autograd; ``params`` itself is left without grad."""
    tp = T.tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss = lm_loss(cfg, tp, batch)
    g = torch.autograd.grad(loss, T.leaves(tp))
    return loss.detach(), T.unflatten(params, list(g))


# --------------------------------------------------------------------------
# Adam (moments in cfg.moment_dtype — bf16 = optimizer-state compression)
# --------------------------------------------------------------------------


def init_opt(cfg: ArchConfig, params):
    md = L.torch_dtype(cfg.moment_dtype)
    zeros = lambda x: torch.zeros(x.shape, dtype=md, device=x.device)
    dev = T.leaves(params)[0].device
    return dict(m=T.tree_map(zeros, params), v=T.tree_map(zeros, params),
                count=torch.zeros((), dtype=torch.int32, device=dev))


@torch.no_grad()
def adam_update(cfg: ArchConfig, params, grads, opt, *, lr=3e-4, b1=0.9,
                b2=0.95, eps=1e-8, wd=0.0, clip=1.0):
    """One Adam step with global-norm clipping → (params, opt, gnorm), in
    float32 as the reference computes it (its moments in
    ``cfg.moment_dtype``, rounded to nearest even).  The parameters and
    moments are updated in place (the JAX train loop donates them) and
    returned."""
    gnorm = torch.zeros((), dtype=torch.float32, device=opt["count"].device)
    for g in T.leaves(grads):
        gnorm = gnorm + torch.sum(g.float() ** 2)
    gnorm = torch.sqrt(gnorm)
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    count = opt["count"] + 1
    c1 = 1.0 - b1 ** count.float()
    c2 = 1.0 - b2 ** count.float()
    for p_, g_, m_, v_ in zip(*(T.leaves(t) for t in (
            params, grads, opt["m"], opt["v"]))):
        g32 = g_.float() * scale
        m32 = b1 * m_.float() + (1 - b1) * g32
        v32 = b2 * v_.float() + (1 - b2) * g32 * g32
        step = (m32 / c1) / (torch.sqrt(v32 / c2) + eps)
        p_.copy_(p_.float() * (1 - lr * wd) - lr * step)
        m_.copy_(m32)
        v_.copy_(v32)
    return params, dict(opt, count=count), gnorm


# --------------------------------------------------------------------------
# train step (microbatched gradient accumulation)
# --------------------------------------------------------------------------


def make_train_step(cfg: ArchConfig, lr=3e-4):
    """→ ``train_step(params, opt, batch) → (params, opt, {"loss",
    "gnorm"})``.  With ``cfg.microbatches`` µ > 1 every batch entry whose
    leading dim is a multiple of µ (``cands`` too, as in the reference) is
    split into µ microbatches whose gradients accumulate in
    ``cfg.grad_dtype``; ``batch["mb_mask"]`` [µ] weights them (a dropped
    straggler gets 0) and the sums renormalise over the survivors."""
    lm.check_family(cfg)
    nmicro = max(1, cfg.microbatches)

    def train_step(params, opt, batch):
        if nmicro == 1:
            loss, grads = value_and_grad(cfg, params, batch)
        else:
            batch = dict(batch)
            mb_mask = batch.pop("mb_mask", None)
            dev = batch["tokens"].device
            if mb_mask is None:
                mb_mask = torch.ones((nmicro,), dtype=torch.float32,
                                     device=dev)
            mbs = {k: v.reshape(nmicro, v.shape[0] // nmicro, *v.shape[1:])
                   for k, v in batch.items()
                   if v.ndim > 0 and v.shape[0] >= nmicro
                   and v.shape[0] % nmicro == 0}
            rest = {k: v for k, v in batch.items() if k not in mbs}
            gd = L.torch_dtype(cfg.grad_dtype)
            grads = T.tree_map(lambda x: torch.zeros(
                x.shape, dtype=gd, device=x.device), params)
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(nmicro):
                w = mb_mask[i]
                l_i, g = value_and_grad(
                    cfg, params, {k: v[i] for k, v in mbs.items()} | rest)
                grads = T.tree_map(lambda a, b: a + (w * b).to(a.dtype),
                                   grads, g)
                loss = loss + w * l_i
            denom = torch.clamp(mb_mask.sum(), min=1.0)
            # a grad_dtype accumulator over a float32 denominator is a
            # float32 quotient in the reference (JAX's type promotion)
            grads = T.tree_map(lambda g: g.float() / denom, grads)
            loss = loss / denom
        params, opt, gnorm = adam_update(cfg, params, grads, opt, lr=lr)
        return params, opt, dict(loss=loss, gnorm=gnorm)

    return train_step


# --------------------------------------------------------------------------
# serving: prefill + decode with caches
# --------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, B: int, T: int, dtype=torch.bfloat16,
               device=None):
    """Empty caches sized for total context T."""
    lm.check_family(cfg)
    dev = resolve_device(device)
    shape = (cfg.L, B, T, cfg.n_kv, cfg.hd)
    return {"pos": 0,
            "k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def logits_of(cfg: ArchConfig, p, h):
    """h [..., D] against the output embedding in ``cfg.dtype`` → float32
    logits (the products of ``cfg.dtype`` operands are exact in float32,
    as the reference's ``preferred_element_type``)."""
    E = lm.out_embedding(p, cfg).to(L.torch_dtype(cfg.dtype))
    return h.float() @ E.float().T


def make_decode_step(cfg: ArchConfig):
    """→ ``decode(params, cache, tokens [B, 1]) → (logits [B, 1, V]
    float32, cache)``."""
    lm.check_family(cfg)

    @torch.no_grad()
    def decode_dense(params, cache, tokens):
        x = lm.embed_tokens(params, cfg, tokens)                     # [B,1,D]
        pos = cache["pos"]
        h = x
        for i in range(cfg.L):
            pl = lm.layer(params["layers"], i)
            h, _ = lm._attn_sublayer(
                pl, h, cfg, causal=True, q_offset=pos,
                kv_cache=(cache["k"][i], cache["v"][i]), cache_pos=pos)
            h = lm._ffn_sublayer(pl, h, cfg)
        h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
        return logits_of(cfg, params, h), dict(cache, pos=pos + 1)

    return decode_dense


def make_prefill(cfg: ArchConfig):
    """Forward over the prompt → (last-token logits [B, V] float32, cache
    of the prompt's K/V in bfloat16)."""
    lm.check_family(cfg)

    @torch.no_grad()
    def prefill_dense(params, batch):
        x = lm.embed_tokens(params, cfg, batch["tokens"])
        T = x.shape[1]
        h, ks, vs = x, [], []
        for i in range(cfg.L):
            pl = lm.layer(params["layers"], i)
            h, info = lm._attn_sublayer(pl, h, cfg, causal=True)
            k, v = info["kv"]
            h = lm._ffn_sublayer(pl, h, cfg)
            ks.append(k.to(torch.bfloat16))
            vs.append(v.to(torch.bfloat16))
        h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
        logits = logits_of(cfg, params, h[:, -1])
        return logits, {"k": torch.stack(ks), "v": torch.stack(vs),
                        "pos": T}

    return prefill_dense
