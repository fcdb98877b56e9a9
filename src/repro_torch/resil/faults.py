"""Deterministic fault injection — the chaos-testing substrate, a copy
of the JAX package's `repro/resil/faults.py` (stdlib only, so the port
keeps its own copy instead of importing it).

Production code is sprinkled with **injection points**:

    from repro_torch.resil import faults
    ...
    payload = faults.fire("serve.rebuild", payload)

With no plan installed (the default, and the only state production ever
runs in) `fire` is a two-instruction no-op: one global load and a
``None`` check.  A chaos test or the bench fault arm installs a
`FaultPlan` mapping site names to `FaultSpec`s; the plan then decides
**deterministically** — per-site call counters plus a seeded hash, never
wall-clock or global RNG state — whether call *n* at a site

  * raises `InjectedFault`              (``kind="exc"``),
  * sleeps ``stall_s`` then proceeds    (``kind="stall"``),
  * returns ``mutate(payload)``         (``kind="corrupt"``).

Determinism is the point: a chaos test that fails replays exactly, and
the bench fault arm measures the *same* fault sequence every run.

Sites (grep for ``faults.fire`` to audit), the JAX package's names:
``ckpt.save``, inside the checkpoint writer between the shard and the
manifest (a "crash" there leaves a torn staging dir); ``serve.ingest``,
in `RecsysService.ingest` after the batch passed validation and before
the index changes; ``serve.flush``, before a flush's dispatch (an
exception falls back to exact scoring, a stall ages the queue);
``serve.rebuild`` and ``serve.rebuild.index``, in the background
rebuilder before the build and on the built index; ``wal.append`` and
``online.update``, in `OnlineUpdater.update` before the entry is written
and between logging and applying it.  The always-on loop's ``loop.*``
sites come with the module that holds them.

Use as a context manager so a failing test can never leak a plan into
the next one:

    with faults.injected({"serve.rebuild": faults.FaultSpec(at_calls=(0,))}):
        ...
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import zlib
from typing import Callable


class InjectedFault(RuntimeError):
    """The exception every ``kind="exc"`` injection raises — distinct from
    any real error type so production handlers can't mask a genuine bug by
    catching it specifically (they should catch broadly and degrade)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """What to do at one site.  ``at_calls`` lists 0-based call indices
    that fire (the deterministic workhorse); ``rate`` adds a seeded
    Bernoulli per call for soak-style runs.  ``stall_s`` applies to
    ``kind="stall"`` (and also to "exc"/"corrupt" when > 0: stall first,
    then fault — models a slow failure)."""
    kind: str = "exc"                     # exc | stall | corrupt
    at_calls: tuple = ()
    rate: float = 0.0
    stall_s: float = 0.0
    mutate: Callable | None = None        # payload transformer for corrupt
    message: str = "injected fault"

    def __post_init__(self):
        if self.kind not in ("exc", "stall", "corrupt"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.kind == "corrupt" and self.mutate is None:
            raise ValueError("kind='corrupt' needs a mutate= callable")


class FaultPlan:
    """Seeded, thread-safe decision table.  ``calls``/``fired`` counters
    are public so tests can assert exactly which injections happened."""

    def __init__(self, specs: dict, seed: int = 0):
        self.specs = {k: (v if isinstance(v, FaultSpec) else FaultSpec(**v))
                      for k, v in specs.items()}
        self.seed = seed
        self.calls: dict = {}
        self.fired: dict = {}
        self._lock = threading.Lock()     # rebuild/ckpt threads fire too

    def _decide(self, site: str):
        """(call index, spec-or-None, fire?) — counter bump under lock."""
        with self._lock:
            n = self.calls.get(site, 0)
            self.calls[site] = n + 1
            spec = self.specs.get(site)
            if spec is None:
                return n, None, False
            fire = n in spec.at_calls
            if not fire and spec.rate > 0.0:
                # seeded per-(site, call) hash → Bernoulli; no global RNG
                h = zlib.crc32(f"{self.seed}:{site}:{n}".encode())
                fire = (h / 0xFFFFFFFF) < spec.rate
            if fire:
                self.fired[site] = self.fired.get(site, 0) + 1
            return n, spec, fire

    def fire(self, site: str, payload=None):
        n, spec, fire = self._decide(site)
        if not fire:
            return payload
        if spec.stall_s > 0.0:
            time.sleep(spec.stall_s)
        if spec.kind == "exc":
            raise InjectedFault(f"{site}: {spec.message} (call {n})")
        if spec.kind == "corrupt":
            return spec.mutate(payload)
        return payload                    # stall: already slept


_PLAN: FaultPlan | None = None
_INSTALL_LOCK = threading.Lock()


def install(plan: FaultPlan) -> FaultPlan:
    """Install a plan process-wide.  Refuses to stack plans — overlapping
    chaos scenarios would make each other's counters meaningless."""
    global _PLAN
    with _INSTALL_LOCK:
        if _PLAN is not None:
            raise RuntimeError("a FaultPlan is already installed")
        _PLAN = plan
    return plan


def uninstall() -> None:
    global _PLAN
    with _INSTALL_LOCK:
        _PLAN = None


def active() -> FaultPlan | None:
    return _PLAN


@contextlib.contextmanager
def injected(specs_or_plan, seed: int = 0):
    """``with faults.injected({...}): ...`` — install for the block only."""
    plan = (specs_or_plan if isinstance(specs_or_plan, FaultPlan)
            else FaultPlan(specs_or_plan, seed=seed))
    install(plan)
    try:
        yield plan
    finally:
        uninstall()


def fire(site: str, payload=None):
    """The injection point.  No plan installed → returns payload untouched
    (the production fast path: one global read + None check)."""
    plan = _PLAN
    if plan is None:
        return payload
    return plan.fire(site, payload)
