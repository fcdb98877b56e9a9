"""The meshes of the multi-device paths (`repro/launch/mesh.py`): the
1-D shard mesh of the LSH-MF tiers (`make_shard_mesh`,
`serve_shard_count`) and the LM meshes (`compat_mesh`, `make_host_mesh`,
`make_production_mesh`, `use_mesh`).

The JAX package drives D devices from one process through
`jax.shard_map`.  The port keeps that single-controller shape: a
`ShardMesh` is an ordered tuple of `torch.device`s, each shard's tensors
live on its device, and the two collectives the tiers use are explicit
copies (`psum`, `ppermute`).  On a host with D cards the mesh is
``cuda:0 … cuda:D−1``.

An `LMMesh` is the same idea over named axes (``("data", "model")`` or
``("pod", "data", "model")``): an ordered grid of cells, cell ``c`` a
tuple of coordinates in row-major order living on one device.  A
`shard_map` region of the reference runs here one cell after another on
that cell's block (`models/sharding.py::NamedSharding.blocks`), and its
collectives are `all_to_all` and `psum_over` across the cells of the
named axes, copies made in the cells' order.

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
import itertools
import math
import os

import numpy as np
import torch

from repro_torch.device import resolve_device

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


# --------------------------------------------------------------------------
# LM meshes: named axes over a grid of cells
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LMMesh:
    """A grid of cells over named axes; cell ``c`` (a tuple of
    coordinates, one an axis) lives on ``cell_devices[flat(c)]``, the
    cells in row-major order (several cells may share one device)."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    cell_devices: tuple[torch.device, ...]

    @property
    def shape(self) -> dict:
        """Axis name → size, in axis order (`jax.sharding.Mesh.shape`)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def devices(self) -> np.ndarray:
        """The cells' devices as an object array of the mesh's shape."""
        out = np.empty(self.size, dtype=object)
        out[:] = list(self.cell_devices)
        return out.reshape(self.axis_sizes)

    def cells(self) -> list:
        """Every cell's coordinates, in row-major order."""
        return list(itertools.product(*(range(n) for n in self.axis_sizes)))

    def device_of(self, cell) -> torch.device:
        return self.cell_devices[int(np.ravel_multi_index(cell,
                                                          self.axis_sizes))]

    def index(self, cell, axes) -> int:
        """``cell``'s index along ``axes`` (a name or a tuple of names,
        the first the major one): `lax.axis_index` of those axes."""
        i = 0
        for a in _names(axes):
            k = self.axis_names.index(a)
            i = i * self.axis_sizes[k] + cell[k]
        return i

    def groups(self, axes) -> list:
        """The cells split into the groups a collective over ``axes``
        spans: cells that differ only along ``axes``, each group ordered
        by `index` along them."""
        names = _names(axes)
        out = {}
        for c in self.cells():
            rest = tuple(x for a, x in zip(self.axis_names, c)
                         if a not in names)
            out.setdefault(rest, []).append(c)
        return [sorted(g, key=lambda c: self.index(c, names))
                for g in out.values()]


def _names(axes) -> tuple:
    """An axis entry (a name, a tuple of names or None) → its names."""
    if axes is None:
        return ()
    return tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)


def compat_mesh(shape, axes, device=None) -> LMMesh:
    """A mesh of ``shape`` over the named ``axes``, by `make_shard_mesh`'s
    rule: the cards ``cuda:0 …`` when the host has as many as the mesh
    has cells, else — where `LOGICAL_DEVICES` is at least that many —
    logical cells of ``device`` (``cuda`` unless asked).  Raises when
    neither holds: never a smaller mesh."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} do not match")
    dev = resolve_device(device)
    n = math.prod(shape)
    if n < 1:
        raise ValueError(f"a mesh needs ≥ 1 cell, got shape {shape}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if n > 1 and dev.type == "cuda" and torch.cuda.device_count() >= n:
        cells = tuple(torch.device("cuda", d) for d in range(n))
    elif n == 1 or n <= (_logical() or 0):
        cells = (dev,) * n
    else:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh ({n} cells) "
                         f"exceeds the {device_count(dev)} {dev.type} "
                         f"device(s)")
    return LMMesh(axes, shape, cells)


def make_host_mesh(data: int = 2, model: int = 2, device=None) -> LMMesh:
    """A small ``("data", "model")`` mesh (the CPU tests' 2 × 2)."""
    return compat_mesh((data, model), ("data", "model"), device)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> LMMesh:
    """16 × 16 ``("data", "model")``, or 2 × 16 × 16 ``("pod", "data",
    "model")``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return compat_mesh(shape, axes, device)


_MESHES: list = []


@contextlib.contextmanager
def use_mesh(mesh: LMMesh):
    """Install ``mesh`` as the current mesh (`current_mesh`) for the
    block; sharding constraints are checked against it."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def current_mesh() -> LMMesh | None:
    """The mesh `use_mesh` installed last, or None."""
    return _MESHES[-1] if _MESHES else None


def all_to_all(parts: dict, mesh: LMMesh, axes, split_axis: int = 0,
               concat_axis: int = 0) -> dict:
    """`lax.all_to_all` over ``axes``: in each group of n cells
    (`LMMesh.groups`), cell i's part splits into n chunks along
    ``split_axis``, and cell j receives the j-th chunks of the group's
    cells in group order, joined along ``concat_axis``, on its
    device.  ``parts`` maps each cell to its tensor."""
    out = {}
    for group in mesh.groups(axes):
        chunks = [parts[c].chunk(len(group), split_axis) for c in group]
        for j, c in enumerate(group):
            dev = mesh.device_of(c)
            out[c] = torch.cat([ch[j].to(dev) for ch in chunks], concat_axis)
    return out


def psum_over(parts: dict, mesh: LMMesh, axes) -> dict:
    """`lax.psum` over ``axes``: in each group the parts summed in group
    order on the first cell's device, then a copy on each cell's."""
    out = {}
    for group in mesh.groups(axes):
        dev0 = mesh.device_of(group[0])
        total = parts[group[0]]
        for c in group[1:]:
            total = total + parts[c].to(dev0)
        for c in group:
            out[c] = total.to(mesh.device_of(c))
    return out
