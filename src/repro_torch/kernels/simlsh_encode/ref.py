"""Plain PyTorch version of the simlsh_encode kernel
(`repro/kernels/simlsh_encode/ref.py`).  The kernel wrapper runs it on
CPU tensors, and the card's kernel is compared with it."""
from __future__ import annotations

import torch


def simlsh_encode_ref(psi, phi):
    """psi [N, deg], phi [N, deg, bits] → S [N, bits] f32, the
    contraction ``einsum("nd,ndb->nb")`` of the JAX package's ref, summed
    over ``d`` in order.

    That is the order of the CUDA kernel's per-lane FMA chain, so with
    Φ = ±1 (every product exact) the two agree bit for bit.  Ψ = r² terms
    reach 25 and partial sums 10³, where a float32 ulp is 6e-5, so a
    contraction in another order (cuBLAS, XLA) differs from both by more
    than the kernel tolerance's 1e-5 wherever the sum cancels."""
    psi = psi.to(torch.float32)
    phi = phi.to(torch.float32)
    S = torch.zeros((phi.shape[0], phi.shape[2]), dtype=torch.float32,
                    device=phi.device)
    for d in range(phi.shape[1]):
        S = S + psi[:, d, None] * phi[:, d]
    return S
