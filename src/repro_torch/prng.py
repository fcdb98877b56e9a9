"""`jax.random`'s threefry2x32 draws, reproduced bit for bit in PyTorch.

The fit draws every random choice from `jax.random` keys: the Φ hash rows
of simLSH, the random fill of J^K, the initial factors and each epoch's
batch order.  For the port to give the same signatures, neighbours and
schedule as the JAX package from the same seed, it reproduces those
draws here rather than taking a `torch.Generator`.  The algorithms are
those of jax 0.9's `jax/_src/prng.py` (`threefry_2x32`,
`_threefry_split_foldlike`, `threefry_fold_in`,
`_threefry_random_bits_partitionable`) and `jax/_src/random.py`
(`_uniform`, `_randint`, `_shuffle`, `_normal_real`, `_rademacher`), in
the ``jax_threefry_partitionable = True`` mode that jax 0.9 defaults to.

A key is an int64 tensor of shape ``[..., 2]`` holding two uint32 words,
the layout of JAX's legacy ``uint32[2]`` keys.  Every uint32 operation is
done on int64 tensors and masked to 32 bits, so nothing relies on
unsigned tensor types.  Integer draws (keys, bits, `randint`,
`permutation`, `rademacher`) equal JAX's exactly; the float32 `normal`
goes through `log1p`, which may differ from XLA's by a few ulp.

A bfloat16 draw (``dtype=torch.bfloat16``) is exact: `jax.random.uniform`
takes 8 random bits for a float of fewer than 8 mantissa bits, so a
bfloat16 `uniform` or `normal` is one of 128 values picked by bits 1–7 of
each 32-bit draw.  The 128 values are computed once a draw, rounded to
bfloat16 after every step as XLA rounds them (`_bf16_table`), and each
element gathers its own.
"""
from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher (20 rounds) on uint32 words held in
    int64 tensors or ints; all four operands broadcast."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x1, x2


def _words(key: torch.Tensor, device):
    """A key's two words as int64 tensors shaped ``[..., 1]`` on
    ``device`` (a batch of keys broadcasts against a counter vector)."""
    key = key.to(device=device, dtype=torch.int64)
    return key[..., 0:1], key[..., 1:2]


def _counter(n: int, device, start: int = 0):
    """`iota_2x32_shape`: the flat index start..start+n-1 as (high, low)
    words."""
    idx = torch.arange(start, start + n, dtype=torch.int64, device=device)
    return idx >> 32, idx & M32


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """`jax.random.PRNGKey(seed)`: ``[0, seed mod 2³²]`` for a seed that
    fits in int32 (JAX's 32-bit mode)."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed must fit in int32, got {seed}")
    return torch.tensor([0, seed & M32], dtype=torch.int64, device=device)


def split(key: torch.Tensor, num=2) -> torch.Tensor:
    """`jax.random.split(key, num)` → keys ``[*shape, 2]``.  A batch of
    keys ``[..., 2]`` splits each (→ ``[..., *shape, 2]``), as a `vmap`
    of `split` would."""
    shape = (num,) if isinstance(num, int) else tuple(num)
    k1, k2 = _words(key, key.device)
    hi, lo = _counter(math.prod(shape), key.device)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return torch.stack([b1, b2], dim=-1).reshape(*key.shape[:-1], *shape, 2)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in(key, data)`.  ``data`` may be a tensor of ids,
    which folds each into the same key (→ ``[*data.shape, 2]``), as a
    `vmap` of `fold_in` over the ids would."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & M32
    k1, k2 = (w[..., 0] for w in _words(key, key.device))
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(d), d)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """32 random bits per element (`jax.random.bits(key, shape)`) as an
    int64 tensor in [0, 2³²).  A batch of keys ``[..., 2]`` gives
    ``[..., *shape]``, one draw per key."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    device = key.device if device is None else torch.device(device)
    k1, k2 = _words(key, device)
    hi, lo = _counter(math.prod(shape), device)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return (b1 ^ b2).reshape(*key.shape[:-1], *shape)


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def uniform(key, shape, minval=0.0, maxval=1.0, device=None,
            dtype=torch.float32) -> torch.Tensor:
    """`jax.random.uniform` in float32: the top 23 bits become the
    mantissa of a float in [1, 2), shifted and scaled to [minval, maxval).
    In bfloat16 bits 1–7 of each draw pick one of `_bf16_table`'s 128
    values."""
    bits = random_bits(key, shape, device)
    if dtype == torch.bfloat16:
        return _bf16_pick(_bf16_table(bits.device, minval, maxval), bits)
    _check_dtype(dtype)
    return _uniform_bits(bits, minval, maxval)


def _check_dtype(dtype) -> None:
    if dtype != torch.float32:
        raise NotImplementedError(
            f"draws in {dtype}: only float32 and bfloat16 are ported")


def _uniform_bits(bits: torch.Tensor, minval, maxval) -> torch.Tensor:
    """`uniform`'s float32 values from its 32-bit draws."""
    one = 0x3F800000
    f = ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0
    lo, hi = _f32(minval).to(f.device), _f32(maxval).to(f.device)
    # XLA fuses f·(hi − lo) + lo into one FMA: one rounding, from float64
    scaled = (f.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


# XLA's single-precision erfinv (M. Giles' polynomials in w = −log(1−x²),
# for w < 5 and w ≥ 5), highest-order coefficient first
_ERFINV_LO = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_HI = (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613,
              0.00943887047, 1.00167406, 2.83297682)


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erfinv.  Each Horner step is one rounding of
    c + p·w (XLA fuses it into an FMA), taken here in float64."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    coef = lambda a, b: torch.where(lt, _f32(a).to(x.device),
                                    _f32(b).to(x.device))
    p = coef(_ERFINV_LO[0], _ERFINV_HI[0])
    for a, b in zip(_ERFINV_LO[1:], _ERFINV_HI[1:]):
        p = (coef(a, b).double() + p.double() * w).float()
    return p * x


def normal(key, shape, device=None, dtype=torch.float32) -> torch.Tensor:
    """`jax.random.normal` in float32: √2·erfinv(u), u uniform in
    (−1, 1).  `log1p` differs between libraries, so a draw may differ
    from JAX's by a few ulp (at most 3 measured; 99 % are equal).  In
    bfloat16 the draw equals JAX's bit for bit (`_bf16_table`)."""
    bits = random_bits(key, shape, device)
    if dtype == torch.bfloat16:
        return _bf16_pick(_bf16_table(bits.device, normal=True), bits)
    _check_dtype(dtype)
    return _normal_bits(bits)


def _normal_bits(bits: torch.Tensor) -> torch.Tensor:
    """`normal`'s float32 values from its 32-bit draws."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    u = _uniform_bits(bits, float(lo), 1.0)
    return _f32(np.sqrt(2)).to(u.device) * _erfinv(u)


def normal_chunked(key, shape, device=None, chunk: int = 1 << 24,
                   dtype=torch.float32, out=None) -> torch.Tensor:
    """`normal(key, shape, dtype=dtype)` drawn ``chunk`` elements at a
    time into one tensor (``out``, contiguous, when given): in the
    partitionable mode element i depends on its flat index alone, so the
    chunks are the whole draw's slices and the int64 working set stays
    ``chunk`` wide (a 128k × 4096 embedding table would need tens of GB
    of it at once).  A bfloat16 draw runs the cipher on int32 words
    (`_threefry_bits_i32`) and writes each chunk's picks straight into
    ``out``: no float32 or int64 buffer wider than a chunk."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    device = key.device if device is None else torch.device(device)
    n = math.prod(shape)
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=device)
    if tuple(out.shape) != shape or out.dtype != dtype or (
            not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {dtype} tensor of "
                         f"shape {shape}")
    flat = out.view(-1)
    if dtype == torch.bfloat16:
        table = _bf16_table(device, normal=True)
        k1, k2 = (int(w) for w in key.reshape(2).tolist())
        for s in range(0, n, chunk):
            c = min(chunk, n - s)
            torch.index_select(table, 0, _low7_i32(k1, k2, s, c, device),
                               out=flat[s:s + c])
        return out
    _check_dtype(dtype)
    k1, k2 = _words(key, device)
    for s in range(0, n, chunk):
        c = min(chunk, n - s)
        b1, b2 = threefry2x32(k1, k2, *_counter(c, device, start=s))
        flat[s:s + c] = _normal_bits(b1 ^ b2)
    return out


# --------------------------------------------------------------------------
# bfloat16 draws: 128 values, picked by 7 bits
# --------------------------------------------------------------------------


def _to_bf16(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to bfloat16 (and hold them in float32): one
    step of XLA's bfloat16 arithmetic, which computes each operation in
    float32 and rounds its result."""
    return x.to(torch.bfloat16).float()


def _bf16_table(device, minval=0.0, maxval=1.0, normal: bool = False):
    """The 128 values of `jax.random.uniform(key, shape, bfloat16,
    minval, maxval)` — or, with ``normal``, of `jax.random.normal(key,
    shape, bfloat16)` — indexed by the 7 mantissa bits (bits 1–7 of each
    32-bit draw; JAX draws 8 and shifts one out) → bfloat16 [128].

    Every step is rounded to bfloat16 as XLA rounds it: the mantissa's
    float in [1, 2) minus 1 (exact), times bf16(maxval − minval), plus
    minval, clamped below at minval; for `normal`, minval = the bfloat16
    just above −1 and maxval 1, then XLA's float32 erfinv (`_erfinv`) and
    the product with bf16(√2).  Rounding once at the end instead gives
    37 of the 128 normal values wrong."""
    if normal:
        minval, maxval = -1.0 + 2.0 ** -8, 1.0   # the bfloat16 above −1
    m = torch.arange(128, dtype=torch.int32, device=device)
    f = ((m | 0x3F80) << 16).view(torch.float32) - 1.0
    lo = _to_bf16(_f32(minval).to(device))
    hi = _to_bf16(_f32(maxval).to(device))
    u = torch.maximum(lo, _to_bf16(_to_bf16(f * _to_bf16(hi - lo)) + lo))
    if normal:
        root2 = _to_bf16(_f32(np.sqrt(2)).to(device))
        u = _to_bf16(root2 * _to_bf16(_erfinv(u)))
    return u.to(torch.bfloat16)


def _bf16_pick(table: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """``table``'s entry for each 32-bit draw's bits 1–7."""
    return table[(bits >> 1) & 0x7F]


def _i32(x: int) -> int:
    """A uint32 word as the int32 with its bits."""
    x &= M32
    return x - (1 << 32) if x >> 31 else x


def _rotl_i32(x: torch.Tensor, r: int) -> torch.Tensor:
    """32-bit rotate left on int32 words (`>>` is arithmetic: the bits
    shifted in from the sign are masked off)."""
    return (x << r) | ((x >> (32 - r)) & ((1 << r) - 1))


def _threefry_bits_i32(k1: int, k2: int, x1, x2) -> torch.Tensor:
    """`threefry2x32` for one key (``k1``, ``k2`` as Python ints) on
    int32 tensors whose additions wrap in two's complement → b1 ^ b2 as
    int32 words.  Half the bytes of the int64 form a pass, for the large
    draws (`normal_chunked` in bfloat16)."""
    ks = (_i32(k1), _i32(k2), _i32(k1 ^ k2 ^ _KS_PARITY))
    x1 = x1 + ks[0]
    x2 = x2 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 += x2
            x2 = _rotl_i32(x2, r).bitwise_xor_(x1)
        x1 += ks[(i + 1) % 3]
        x2 += _i32(ks[(i + 2) % 3] + i + 1)
    return x1.bitwise_xor_(x2)


def _low7_i32(k1: int, k2: int, start: int, n: int, device) -> torch.Tensor:
    """Bits 1–7 of the 32-bit draws start..start+n-1 of key (k1, k2), as
    int32 in [0, 128): the index of a bfloat16 draw's value."""
    idx = torch.arange(start, start + n, dtype=torch.int64, device=device)
    hi, lo = (idx >> 32).to(torch.int32), idx.to(torch.int32)
    del idx
    return (_threefry_bits_i32(k1, k2, hi, lo) >> 1).bitwise_and_(0x7F)


def _mul32(x, c: int):
    """(x · c) mod 2³² for x in [0, 2³²) and 0 ≤ c < 2³², without a
    partial product reaching 2⁶³."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def randint(key, shape, minval: int, maxval: int, device=None) -> torch.Tensor:
    """`jax.random.randint(key, shape, minval, maxval)` for int32: two
    32-bit draws folded modulo the span (JAX's biased-but-cheap rule).  A
    batch of keys ``[..., 2]`` gives ``[..., *shape]``, one draw per key
    (a `vmap` of `randint`)."""
    minval, maxval = int(minval), int(maxval)
    if not (-2 ** 31 <= minval and maxval <= 2 ** 31 - 1):
        raise ValueError("randint: bounds must fit in int32")
    ks = split(key)
    k1, k2 = ks[..., 0, :], ks[..., 1, :]
    higher = random_bits(k1, shape, device)
    lower = random_bits(k2, shape, device)
    span = 1 if maxval <= minval else (maxval - minval) & M32
    mult = (2 ** 16) % span
    mult = ((mult * mult) & M32) % span        # a uint32 product: it wraps
    off = ((_mul32(higher % span, mult) + lower % span) & M32) % span
    out = (minval + off) & M32
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.permutation(key, n)`: rounds of a stable sort of
    0..n-1 by fresh 32-bit keys (JAX's `_shuffle`) → int64 [n]."""
    n = int(n)
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(M32)))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, n), stable=True).indices
        x = x[order]
    return x


def rademacher(key, shape, device=None) -> torch.Tensor:
    """`jax.random.rademacher` in float32: +1 where a uniform draw is
    below ½ (JAX's `bernoulli(key, 0.5)`), −1 elsewhere."""
    return torch.where(uniform(key, shape, device=device) < 0.5, 1.0,
                       -1.0).to(torch.float32)
