"""The shard mesh of the multi-device tiers (`repro/launch/mesh.py`'s
`make_shard_mesh` and `serve_shard_count`).

The JAX package drives D devices from one process through
`jax.shard_map`.  The port keeps that single-controller shape: a
`ShardMesh` is an ordered tuple of `torch.device`s, each shard's tensors
live on its device, and the two collectives the tiers use are explicit
copies (`psum`, `ppermute`).  On a host with D cards the mesh is
``cuda:0 … cuda:D−1``.

``REPRO_TORCH_LOGICAL_DEVICES=n`` makes `device_count` report ``n``
devices that all live on the caller's one device (the CPU or one card):
the port's counterpart of XLA's ``--xla_force_host_platform_device_count``,
which the JAX package's multi-device tests set.  Logical shards run one
after another on one stream, so their times measure the sharded
program's total work on one device, not D devices or their links.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os

import torch

LOGICAL_DEVICES = "REPRO_TORCH_LOGICAL_DEVICES"


def _logical() -> int | None:
    """The setting's device count (None when unset); read at call time."""
    raw = os.environ.get(LOGICAL_DEVICES, "").strip()
    if not raw:
        return None
    n = int(raw)
    if n < 1:
        raise ValueError(f"{LOGICAL_DEVICES} must be ≥ 1, got {raw!r}")
    return n


def device_count(device) -> int:
    """Devices a mesh over ``device``'s kind may take: the cards on
    ``cuda``, 1 on the CPU — or the setting's count of logical devices."""
    n = _logical()
    if n is not None:
        return n
    return (torch.cuda.device_count() if torch.device(device).type == "cuda"
            else 1)


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """The ordered devices of a 1-D ``"shard"`` mesh; shard ``d`` lives
    on ``devices[d]`` (several shards may share one device)."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def make_shard_mesh(shards: int, device) -> ShardMesh:
    """A mesh of ``shards`` devices: the cards ``cuda:0 … cuda:D−1`` when
    the host has that many, else — where `LOGICAL_DEVICES` allows it —
    ``shards`` logical shards of ``device``.  Raises when neither holds:
    the tiers never run on fewer shards than asked."""
    dev = torch.device(device)
    D = int(shards)
    if D < 1:
        raise ValueError(f"a shard mesh needs ≥ 1 shard, got {D}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if D > 1 and dev.type == "cuda" and torch.cuda.device_count() >= D:
        return ShardMesh(tuple(torch.device("cuda", d) for d in range(D)))
    if D == 1 or D <= (_logical() or 0):
        return ShardMesh((dev,) * D)
    raise ValueError(f"a {D}-shard mesh exceeds the {device_count(dev)} "
                     f"{dev.type} device(s)")


def serve_shard_count(request: int | str, device) -> int:
    """Resolve `ServeConfig.shards` to a shard count, by the JAX package's
    rules: ``0`` → 1 (the single-device path); ``"auto"`` → the largest
    power of two ≤ the device count; an int must be a power of two (the
    top-N merge is an XOR-partner butterfly) ≤ the device count."""
    avail = device_count(device)
    if request == "auto":
        return 1 << max(avail.bit_length() - 1, 0)
    d = int(request)
    if d == 0:
        return 1
    if d < 1 or d & (d - 1):
        raise ValueError(f"serve shards must be a power of two, got {d}")
    if d > avail:
        raise ValueError(f"serve shards={d} exceeds the {avail} local "
                         f"device(s)")
    return d


def on(device: torch.device):
    """Make ``device`` current for the work of one shard (the kernels
    launch on the current card's stream)."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def copy_to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A copy of ``t`` on ``device`` that never shares ``t``'s storage
    (`Tensor.to` returns ``t`` itself on its own device)."""
    return t.clone() if t.device == device else t.to(device)


def psum(parts: list) -> list:
    """`lax.psum`: the sum of the shards' parts, added in shard order
    0..D−1 on shard 0's device, then a copy on each part's device."""
    total = parts[0].clone()
    for p in parts[1:]:
        total += p.to(total.device)
    return [copy_to(total, p.device) for p in parts]


def ppermute(parts: list, perm) -> list:
    """`lax.ppermute`: part ``src`` is copied to shard ``dst`` for each
    ``(src, dst)`` of ``perm``; a shard no pair sends to gets zeros."""
    out = [None] * len(parts)
    for src, dst in perm:
        out[dst] = copy_to(parts[src], parts[dst].device)
    return [torch.zeros_like(p) if o is None else o
            for o, p in zip(out, parts)]
