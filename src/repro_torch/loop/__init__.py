"""repro_torch.loop — the always-on online loop (`repro/loop`).

The paper's headline claim is *online* learning: CULSH-MF keeps serving
while rating deltas stream in and the model keeps training.  The
resilience layer (`repro_torch.resil`: WAL-backed updates, fault
injection, validate-then-swap rebuilds, load shedding) supplies the
primitives; this package is the supervisor that composes them into one
always-on process:

  * `OnlineLoop`   — a cooperative supervisor that time-slices one
    device budget between `RecsysService` flushes and scheduled training
    micro-epochs, with bounded staleness, ingest-queue backpressure, a
    watchdog that degrades to frozen-model serving, drift-triggered
    index rebuilds, and crash-safe `recover()` (bit-identical
    `OnlineState` after a kill at any of its fault sites);
  * `LoopConfig`   — the slice scheduler's knobs.
"""
from repro_torch.loop.supervisor import LoopConfig, OnlineLoop

__all__ = ["LoopConfig", "OnlineLoop"]
