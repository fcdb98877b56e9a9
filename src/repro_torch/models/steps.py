"""Training and serving steps (`repro/models/steps.py`): the loss,
Adam, the microbatched train step, caches, prefill and decode.

The JAX package's `make_*` factories close over the config and return
functions for `jax.jit`; these return plain functions.  Every family
serves and trains; the vlm family's loss runs over the text positions
behind its patch prefix, and encdec's over the decoder's states.

Differences from the JAX package's functional steps, each where the JAX
launch scripts donate the buffers: `adam_update` (and so a train step)
updates the parameters and moments it was given in place, and a decode
step writes the new K/V, SSM and conv states into the cache it was
given; the cache's ``pos`` is a host int.  A microbatched step whose
parameters are all in ``cfg.grad_dtype`` accumulates its gradients in
place (`_accumulate_in_place`), and `adam_update` divides a bfloat16
sum slice by slice.
"""
from __future__ import annotations

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.core import scatter
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models import ssm as SSM

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
    lm.check_family(cfg)
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
    lm.check_family(cfg)
    tp = T.tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss = lm_loss(cfg, tp, batch)
    g = torch.autograd.grad(loss, T.leaves(tp))
    return loss.detach(), T.unflatten(params, list(g))


# --------------------------------------------------------------------------
# Adam (moments in cfg.moment_dtype — bf16 = optimizer-state compression)
# --------------------------------------------------------------------------

# elements of a leaf that `adam_update` updates at once: its float32
# temporaries stay ≤ 1 GB each (an expert stack of dbrx-132b is 1.06·10⁹)
ADAM_SLICE = 1 << 28


def init_opt(cfg: ArchConfig, params):
    lm.check_family(cfg)
    md = L.torch_dtype(cfg.moment_dtype)
    zeros = lambda x: torch.zeros(x.shape, dtype=md, device=x.device)
    dev = T.leaves(params)[0].device
    return dict(m=T.tree_map(zeros, params), v=T.tree_map(zeros, params),
                count=torch.zeros((), dtype=torch.int32, device=dev))


def _slices(*ts):
    """Aligned slices of `ADAM_SLICE` elements of same-shape leaves (the
    leaves whole where one is not contiguous)."""
    if all(t.is_contiguous() for t in ts):
        return zip(*(t.view(-1).split(ADAM_SLICE) for t in ts))
    return (ts,)


@torch.no_grad()
def adam_update(cfg: ArchConfig, params, grads, opt, *, lr=3e-4, b1=0.9,
                b2=0.95, eps=1e-8, wd=0.0, clip=1.0, denom=None):
    """One Adam step with global-norm clipping → (params, opt, gnorm), in
    float32 as the reference computes it (its moments in
    ``cfg.moment_dtype``, rounded to nearest even).  The parameters and
    moments are updated in place (the JAX train loop donates them) and
    returned.

    Every leaf is read in slices of `ADAM_SLICE` elements, the global
    norm's squares too, so no float32 copy of a whole leaf is made; the
    squares are float32 as in the reference, summed in float64, so the
    slicing changes no bit of the norm.  With ``denom`` the gradients
    are ``grads / denom``, each slice upcast and divided as it is read:
    the float32 quotient tree the reference makes of a bfloat16
    accumulator (`make_train_step`) never exists, and its elements are
    the same."""
    if denom is None:
        quot = lambda g: g.float()
    else:
        quot = lambda g: g.float() / denom
    sq = torch.zeros((), dtype=torch.float64, device=opt["count"].device)
    for g in T.leaves(grads):
        for g_, in _slices(g):
            sq += torch.sum(quot(g_) ** 2, dtype=torch.float64)
    gnorm = torch.sqrt(sq.float())
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    count = opt["count"] + 1
    c1 = 1.0 - b1 ** count.float()
    c2 = 1.0 - b2 ** count.float()
    for ts in zip(*(T.leaves(t) for t in (params, grads, opt["m"],
                                          opt["v"]))):
        # elementwise, so slices of ADAM_SLICE give the same bits
        for p_, g_, m_, v_ in _slices(*ts):
            g32 = quot(g_) * scale
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


def _accumulate_in_place(cfg, params, mbs, rest, mb_mask):
    """(Σ w_i·loss_i, Σ w_i·∂loss_i/∂params) over the microbatches, the
    gradients summed into one tree in the parameters' dtype as the
    backward passes make them: each leaf's ``.grad`` starts at zeros and
    autograd adds each leaf's gradient into it (``grad += g``, rounded
    once an addend in bfloat16) the moment it is complete, so no second
    gradient tree is ever held beside the sum.  Microbatch i's backward
    is seeded with w_i in place of 1: for w_i ∈ {0, 1} the sum is the
    reference's ``0 + (w_0·g_0).astype(gd) + (w_1·g_1).astype(gd) + …``
    bit for bit."""
    tp = T.tree_map(lambda t: t.detach().requires_grad_(True), params)
    leaves = T.leaves(tp)
    for t in leaves:
        t.grad = torch.zeros_like(t)
    dev = leaves[0].device
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    for i, w in enumerate(mb_mask.to(dev)):
        l_i = lm_loss(cfg, tp, {k: v[i] for k, v in mbs.items()} | rest)
        torch.autograd.backward(l_i, grad_tensors=w, inputs=leaves)
        loss = loss + w * l_i.detach()
    return loss, T.unflatten(params, [t.grad for t in leaves])


def make_train_step(cfg: ArchConfig, lr=3e-4):
    """→ ``train_step(params, opt, batch) → (params, opt, {"loss",
    "gnorm"})``.  With ``cfg.microbatches`` µ > 1 every batch entry whose
    leading dim is a multiple of µ (``cands`` too, as in the reference) is
    split into µ microbatches whose gradients accumulate in
    ``cfg.grad_dtype``; ``batch["mb_mask"]`` [µ] weights them (a dropped
    straggler gets 0) and the sums renormalise over the survivors.

    Where every parameter leaf is in ``cfg.grad_dtype`` (float32, or
    llama3-405b's and arctic-480b's bfloat16 throughout) the sum is made
    in place in the leaves' ``.grad`` (`_accumulate_in_place`); otherwise
    (float32 parameters under a bfloat16 accumulator) each weighted
    microbatch gradient is rounded into a ``grad_dtype`` tree, as the
    reference does.  A float32 sum is divided by Σw in place; a bfloat16
    one, whose quotient is float32 in the reference (JAX's type
    promotion), is divided slice by slice inside `adam_update`."""
    lm.check_family(cfg)
    nmicro = max(1, cfg.microbatches)

    def train_step(params, opt, batch):
        denom = None
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
            denom = torch.clamp(mb_mask.sum(), min=1.0)
            if all(t.dtype == gd for t in T.leaves(params)):
                loss, grads = _accumulate_in_place(cfg, params, mbs, rest,
                                                   mb_mask)
            else:
                grads = T.tree_map(lambda x: torch.zeros(
                    x.shape, dtype=gd, device=x.device), params)
                loss = torch.zeros((), dtype=torch.float32, device=dev)
                for i in range(nmicro):
                    w = mb_mask[i]
                    l_i, g = value_and_grad(
                        cfg, params, {k: v[i] for k, v in mbs.items()}
                        | rest)
                    grads = T.tree_map(
                        lambda a, b: a + (w * b).to(a.dtype), grads, g)
                    loss = loss + w * l_i
            loss = loss / denom
            if gd == torch.float32:
                for g in T.leaves(grads):
                    g.div_(denom)
                denom = None
        params, opt, gnorm = adam_update(cfg, params, grads, opt, lr=lr,
                                         denom=denom)
        return params, opt, dict(loss=loss, gnorm=gnorm)

    return train_step


# --------------------------------------------------------------------------
# serving: prefill + decode with caches
# --------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, B: int, T: int, dtype=torch.bfloat16,
               device=None):
    """Empty caches sized for total context T: the dense, moe and vlm
    families' K/V [L, B, T, Hkv, hd]; encdec's too, and its cross K/V
    ``cross_k`` / ``cross_v`` of the same shape (zeros: nothing here
    fills them, as in the reference); the ssm family's float32 SSM
    states [L, B, H, P, N] and conv states [L, B, K−1, ·] in ``dtype``;
    the hybrid's also one K/V slot per group, a window of
    `_hybrid_window` positions at long context (a ring buffer)."""
    lm.check_family(cfg)
    dev = resolve_device(device)
    zeros = lambda *s, dt=dtype: torch.zeros(s, dtype=dt, device=dev)
    cache = {"pos": 0}
    if cfg.family in lm.KV_FAMILIES or cfg.family == "encdec":
        names = ("k", "v") + (("cross_k", "cross_v")
                              if cfg.family == "encdec" else ())
        for n in names:
            cache[n] = zeros(cfg.L, B, T, cfg.n_kv, cfg.hd)
        return cache
    H, Pd, N = SSM.n_heads(cfg), cfg.ssm_headdim, cfg.ssm_state
    K, di = cfg.ssm_conv, SSM.d_inner(cfg)
    cache["ssm"] = zeros(cfg.L, B, H, Pd, N, dt=torch.float32)
    cache["conv_x"] = zeros(cfg.L, B, K - 1, di)
    cache["conv_b"] = zeros(cfg.L, B, K - 1, N)
    cache["conv_c"] = zeros(cfg.L, B, K - 1, N)
    if cfg.family == "hybrid":
        napp = len(lm._hybrid_groups(cfg))
        Tw = min(T, _hybrid_window(cfg, T) or T)
        cache["k"] = zeros(napp, B, Tw, cfg.n_kv, cfg.hd)
        cache["v"] = zeros(napp, B, Tw, cfg.n_kv, cfg.hd)
    return cache


def _hybrid_window(cfg: ArchConfig, T: int):
    """Windowed attention for the shared blocks at extreme context
    (long_500k) — the documented sub-quadratic adaptation."""
    return 8192 if T >= 100_000 else 0


LOGITS_CHUNK = 1 << 28      # elements of the output table upcast at once


class _BlockedLogits(torch.autograd.Function):
    """``h32 @ E.to(dt).float().T`` with ``E`` read in blocks of ``rows``
    rows, each block cast, upcast and multiplied on its own, its product
    written into its columns of the logits.  The backward upcasts each
    block again and writes its gradient, rounded to ``E``'s dtype as
    autograd's two casts round it, into its rows of one ``E``-shaped
    gradient, and sums ``h32``'s over the blocks.  Autograd's own
    backward of the blocks' slices would make an ``E``-sized zero tensor
    for each block: 8 of 4.2 GB a microbatch at llama3-405b."""

    @staticmethod
    def forward(ctx, h32, E, dt, rows):
        out = h32.new_empty((*h32.shape[:-1], E.shape[0]))
        for r in range(0, E.shape[0], rows):
            out[..., r:r + rows] = h32 @ E[r:r + rows].to(dt).float().T
        ctx.save_for_backward(h32, E)
        ctx.dt, ctx.rows = dt, rows
        return out

    @staticmethod
    def backward(ctx, g):
        h32, E = ctx.saved_tensors
        dt, rows = ctx.dt, ctx.rows
        h2 = h32.reshape(-1, h32.shape[-1])
        g2 = g.reshape(-1, g.shape[-1])
        gh = torch.zeros_like(h2)
        gE = torch.empty_like(E)
        for r in range(0, E.shape[0], rows):
            gb = g2[:, r:r + rows]
            gh += gb @ E[r:r + rows].to(dt).float()
            gE[r:r + rows] = (gb.T @ h2).to(dt).to(E.dtype)
        return gh.reshape(h32.shape), gE, None, None


def logits_of(cfg: ArchConfig, p, h):
    """h [..., D] against the output embedding in ``cfg.dtype`` → float32
    logits (the products of ``cfg.dtype`` operands are exact in float32,
    as the reference's ``preferred_element_type``).  A table that is not
    float32 is cast and upcast `LOGITS_CHUNK` elements of rows at a time
    (`_BlockedLogits`): llama3-405b's bfloat16 ``out_embed`` would be an
    8.4 GB float32 copy at once."""
    E, dt = lm.out_embedding(p, cfg), L.torch_dtype(cfg.dtype)
    h32 = h.float()
    if E.dtype == torch.float32 or E.numel() <= LOGITS_CHUNK:
        return h32 @ E.to(dt).float().T
    return _BlockedLogits.apply(h32, E, dt,
                                max(1, LOGITS_CHUNK // E.shape[1]))


_SSM_LEAVES = ("ssm", "conv_x", "conv_b", "conv_c")


def _decode_ssm_layer(pl, h, cfg, cache, i):
    """Layer ``i``'s Mamba2 decode step from ``cache``'s states, which it
    overwrites with the new ones.  A conv leaf in another dtype than the
    step's first takes the step's (the reference's cache leaves are the
    scan's outputs, so at float32 compute a bfloat16 conv cache becomes
    float32 after one step); the SSM state is always float32."""
    xn = L.rms_norm(h, pl["ln"], cfg.norm_eps)
    y, (state, conv) = SSM.mamba_block(
        pl, xn, cfg, state=cache["ssm"][i],
        conv_state=tuple(cache[n][i] for n in _SSM_LEAVES[1:]))
    for name, new in zip(_SSM_LEAVES, (state, *conv)):
        if cache[name].dtype != new.dtype:
            cache[name] = cache[name].to(new.dtype)
        cache[name][i] = new
    return h + y


def make_decode_step(cfg: ArchConfig):
    """→ ``decode(params, cache, tokens [B, 1]) → (logits [B, 1, V]
    float32, cache)``.  encdec's step writes its self-attention K/V at
    ``pos`` and reads the cross K/V (``cross_k`` / ``cross_v``, all T
    slots) without changing them."""
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

    @torch.no_grad()
    def decode_ssm(params, cache, tokens):
        h = lm.embed_tokens(params, cfg, tokens)
        cache = dict(cache)
        for i in range(cfg.L):
            h = _decode_ssm_layer(lm.layer(params["layers"], i), h, cfg,
                                  cache, i)
        h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
        cache["pos"] += 1
        return logits_of(cfg, params, h), cache

    @torch.no_grad()
    def decode_hybrid(params, cache, tokens):
        h = lm.embed_tokens(params, cfg, tokens)
        cache = dict(cache)
        pos = cache["pos"]
        Tw = cache["k"].shape[2]
        for gi, (start, size) in enumerate(lm._hybrid_groups(cfg)):
            # the shared block, its K/V slot a ring buffer of Tw positions
            h, _ = lm._attn_sublayer(
                params["shared_attn"], h, cfg, causal=True, q_offset=pos,
                kv_cache=(cache["k"][gi], cache["v"][gi]),
                cache_pos=pos % Tw)
            h = lm._ffn_sublayer(params["shared_attn"], h, cfg)
            for i in range(start, start + size):
                h = _decode_ssm_layer(lm.layer(params["layers"], i), h, cfg,
                                      cache, i)
        h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
        cache["pos"] = pos + 1
        return logits_of(cfg, params, h), cache

    @torch.no_grad()
    def decode_encdec(params, cache, tokens):
        h = lm.embed_tokens(params, cfg, tokens)
        pos = cache["pos"]
        for i in range(cfg.L):
            pl = lm.layer(params["dec"], i)
            h, _ = lm._attn_sublayer(
                pl, h, cfg, causal=True, q_offset=pos,
                kv_cache=(cache["k"][i], cache["v"][i]), cache_pos=pos)
            # cross-attention on all T slots of the encoder's K/V
            h = lm._cross_sublayer(
                lm.layer(params["dec_cross"], i), h,
                cache["cross_k"][i].to(h.dtype),
                cache["cross_v"][i].to(h.dtype), cfg)
            h = lm._ffn_sublayer(pl, h, cfg)
        h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
        return logits_of(cfg, params, h), dict(cache, pos=pos + 1)

    return {"dense": decode_dense, "moe": decode_dense, "vlm": decode_dense,
            "ssm": decode_ssm, "hybrid": decode_hybrid,
            "encdec": decode_encdec}[cfg.family]


def make_prefill(cfg: ArchConfig):
    """Forward over the prompt → (last-token logits [B, V] float32, cache).
    The dense, moe and vlm families' cache holds the K/V of the prompt —
    behind ``batch["frontend_embeds"]`` [B, P, D] when given, so T = P +
    S positions — in bfloat16, and ``pos`` = T.  The ssm, hybrid and
    encdec families' is ``{"pos": S}`` alone, as in the reference: their
    prefill is the forward, and it fills no cache (`launch/serve.py`
    prefills them by sequential decode)."""
    lm.check_family(cfg)

    @torch.no_grad()
    def prefill_dense(params, batch):
        x = lm.embed_tokens(params, cfg, batch["tokens"])
        if "frontend_embeds" in batch:
            x = torch.cat([L.cast(batch["frontend_embeds"], cfg), x], dim=1)
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

    @torch.no_grad()
    def prefill_generic(params, batch):
        h = lm.forward(cfg, params, batch)
        return (logits_of(cfg, params, h[:, -1]),
                {"pos": batch["tokens"].shape[1]})

    return prefill_dense if cfg.family in lm.KV_FAMILIES else prefill_generic
