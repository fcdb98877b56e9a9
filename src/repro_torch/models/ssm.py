"""Mamba2 — the SSD (state-space duality) block, chunked scan formulation
(`repro/models/ssm.py`).

As in Dao & Gu 2024 (arXiv:2405.21060) §6: within chunks of length Q the
recurrence is a masked attention-like quadratic form; across chunks a
[H, P, N] state is carried by a short sequential scan (a Python loop
over the S/Q chunks, the reference's `lax.scan`).

Decode is the O(1) recurrence: S ← S·exp(dt·A) + dt·(B ⊗ x);  y = C·S + D·x.

The JAX package computes all of this with einsums outside any Pallas
kernel, so the port computes it with plain `torch` products.  Tensors
carry their dtype explicitly, as in `models/layers.py`; dt, A, the SSD's
arithmetic and its state are float32 wherever the reference puts them
there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig


def d_inner(cfg: ArchConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def n_heads(cfg: ArchConfig) -> int:
    return d_inner(cfg) // cfg.ssm_headdim


def _conv1d(x, w, state=None):
    """Depthwise causal conv. x [B,S,C], w [K,C]. state [B,K-1,C] for
    decode → (out [B,S,C], new state [B,K-1,C]), both in ``x``'s dtype.
    The taps are summed in order in ``x``'s dtype, as the reference's
    Python ``sum`` (in bfloat16 the order is part of the result)."""
    K, S = w.shape[0], x.shape[1]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    wx = w.to(x.dtype)
    out = xp[:, 0:S] * wx[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * wx[i]
    return out, xp[:, -(K - 1):]


def ssd_chunked(xs, dt, A, B, C, D, chunk: int):
    """SSD over a sequence.

    xs [B,S,H,P], dt [B,S,H] (post-softplus), A [H] (negative), B/C [B,S,N]
    (single group, broadcast over heads), D [H].  Returns y [B,S,H,P] in
    ``xs``'s dtype.
    """
    b, S, H, Pd = xs.shape
    N = B.shape[-1]
    Q = min(chunk, S)
    nc = S // Q
    if nc * Q != S:
        raise AssertionError("seq must divide the ssd chunk")
    f32 = torch.float32

    xs_c = xs.reshape(b, nc, Q, H, Pd).to(f32)
    dt_c = dt.reshape(b, nc, Q, H).to(f32)
    B_c = B.reshape(b, nc, Q, N).to(f32)
    C_c = C.reshape(b, nc, Q, N).to(f32)

    dA = dt_c * A.to(f32)[None, None, None, :]              # [b,nc,Q,H] (≤0)
    cum = torch.cumsum(dA, dim=2)                           # within-chunk
    seg_end = torch.exp(cum[:, :, -1:, :] - cum)            # decay t→chunk end
    chunk_decay = torch.exp(cum[:, :, -1, :])               # whole-chunk decay

    # ---- intra-chunk (quadratic, masked) --------------------------------
    # L[s,t] = exp(cum_s − cum_t) for s ≥ t.  The exponent is masked
    # before the exp, the reference masks after it: above the diagonal
    # cum_s − cum_t sums |dt·A| over up to Q − 1 steps, which passes
    # float32's exp range near Q = 128, and the backward of a masked inf
    # is NaN there.  The forward is the same either way (ROADMAP Queue 3).
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xs.device))
    Ldec = torch.exp(torch.where(
        mask[None, None, :, :, None],
        cum[:, :, :, None, :] - cum[:, :, None, :, :], float("-inf")))
    scores = torch.einsum("bcsn,bctn->bcst", C_c, B_c)       # [b,nc,Q,Q]
    G = scores[..., None] * Ldec * dt_c[:, :, None, :, :]    # [b,nc,s,t,H]
    y_intra = torch.einsum("bcsth,bcthp->bcshp", G, xs_c)

    # ---- chunk states + inter-chunk scan --------------------------------
    # state contribution of chunk c: Σ_t seg_end[t]·dt_t·(B_t ⊗ x_t)
    Sc = torch.einsum("bcthp,bctn->bchpn",
                      xs_c * (seg_end * dt_c)[..., None], B_c)
    carry = torch.zeros((b, H, Pd, N), dtype=f32, device=xs.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + Sc[:, c]
    S_prev = torch.stack(prev, dim=1)                       # [b,nc,H,P,N]

    # y_inter[s] = exp(cum_s) · C_s · S_prev
    in_decay = torch.exp(cum)                               # [b,nc,Q,H]
    y_inter = torch.einsum("bcsn,bchpn->bcshp", C_c, S_prev) \
        * in_decay[..., None]

    y = (y_intra + y_inter).reshape(b, S, H, Pd)
    y = y + xs.to(f32) * D.to(f32)[None, None, :, None]
    return y.to(xs.dtype)


def ssd_decode(x1, dt1, A, B1, C1, D, state):
    """One-token recurrence.  x1 [B,H,P], dt1 [B,H], B1/C1 [B,N],
    state [B,H,P,N] (f32).  Returns (y [B,H,P], state')."""
    f32 = torch.float32
    dt32 = dt1.to(f32)
    dA = torch.exp(dt32 * A.to(f32)[None, :])                # [B,H]
    upd = (dt32[:, :, None, None] * B1.to(f32)[:, None, None, :]
           * x1.to(f32)[:, :, :, None])
    state = state * dA[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", C1.to(f32), state)
    y = y + x1.to(f32) * D.to(f32)[None, :, None]
    return y.to(x1.dtype), state


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` = max(x, 0) +
    log1p(exp(−|x|)) (`torch.nn.functional.softplus` returns ``x`` itself
    above its threshold of 20)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def mamba_block(p, x, cfg: ArchConfig, *, chunk: int = 256, state=None,
                conv_state=None):
    """Full Mamba2 block.  Train/prefill: ``state=None`` → (y, (None,
    new conv states)).  Decode: x [B,1,D] with (state, conv_state)
    carried → (y, (state', conv states')).

    The fused mamba2 in_proj is split into per-output projections (z, x,
    B, C, dt), column-block identical to the fused matmul, as in the
    reference; the depthwise conv splits the same way exactly.
    """
    di, H = d_inner(cfg), n_heads(cfg)
    w = lambda name: p[name].to(x.dtype)
    z = torch.einsum("bsd,de->bse", x, w("z_proj"))
    xs = torch.einsum("bsd,de->bse", x, w("x_proj"))
    B_ = torch.einsum("bsd,dn->bsn", x, w("b_proj"))
    C_ = torch.einsum("bsd,dn->bsn", x, w("c_proj"))
    dt = torch.einsum("bsd,dh->bsh", x, w("dt_proj"))

    cs = conv_state if conv_state is not None else (None, None, None)
    xs, ncx = _conv1d(xs, p["conv_x"], cs[0])
    B_, ncb = _conv1d(B_, p["conv_b"], cs[1])
    C_, ncc = _conv1d(C_, p["conv_c"], cs[2])
    new_conv = (ncx, ncb, ncc)
    silu = lambda t: F.silu(t.float()).to(x.dtype)
    xs, B_, C_ = silu(xs), silu(B_), silu(C_)

    dt = softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    bsz, S, _ = x.shape
    xs_h = xs.reshape(bsz, S, H, cfg.ssm_headdim)
    if state is None:
        y = ssd_chunked(xs_h, dt, A, B_, C_, p["D"], chunk)
        new_state = None
    else:
        y1, new_state = ssd_decode(xs_h[:, 0], dt[:, 0], A, B_[:, 0],
                                   C_[:, 0], p["D"], state)
        y = y1[:, None]

    y = y.reshape(bsz, S, di)
    # gated RMSNorm (mamba2's norm-then-gate)
    y = y.float() * F.silu(z.float())
    yn = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True)
                         + cfg.norm_eps)
    y = (yn * p["norm_w"].float()).to(x.dtype)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"].to(x.dtype))
    return out, (new_state, new_conv)
