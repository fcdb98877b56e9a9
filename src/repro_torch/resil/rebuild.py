"""Double-buffered background index rebuild with validate-then-swap
(`repro/resil/rebuild.py`).

A tail overflow needs index v+1 built from the full signature set.
Built on the request path, every pending flush would wait behind it, and
an unvalidated build (a crash mid-way, poisoned signatures) would be
served.  `IndexRebuilder` moves the build off the hot path and gates the
swap:

  1. ``submit(sigs, tail_cap)`` hands the *full* signature set to a
     daemon worker thread; the caller keeps serving index **v**
     unblocked (`serve.index.insert` and `rebuild` return new tensors and
     never write an index in place, so flushes that captured v are safe
     whenever the swap lands);
  2. the worker builds v+1 (`serve.index.build_index`), then runs
     `resil.validate.validate_index` — CSR bucket invariants plus a
     self-retrieval recall smoke on a seeded probe set;
  3. the owner polls ``take()`` at flush boundaries: a validated index
     comes back exactly once ("ready"); a failed build or failed
     validation comes back as "failed" with the error — the owner keeps
     serving v (**rollback is the default**, not an action) and may
     ``submit`` again to retry.

Only one build runs at a time; a ``submit`` while busy stages the newest
signature set and the worker picks it up next ("latest wins" — rebuilt
indexes are snapshots, intermediate ones are never worth finishing).

On the card the worker runs on its own `torch.cuda.Stream`, so the build
and the validation's probe never queue behind (or ahead of) the serving
stream's flushes: the worker's stream first waits on an event the
submitter recorded after producing ``sigs``, and records another after
validation.  ``take`` makes the caller's current stream wait on that
event and marks the index's tensors as used by it (`record_stream`), so
the serving stream never reads a half-built index and the allocator never
recycles its memory under a pending flush.

Fault-injection sites: ``serve.rebuild`` (before the build — exc/stall)
and ``serve.rebuild.index`` (the built index, before validation —
corrupt here to exercise the validation gate).  Spans:
``serve.rebuild.bg`` and ``serve.rebuild.bg.validate``; counters
``serve.rebuild.built`` / ``serve.rebuild.failed``; gauge
``serve.rebuild.last_build_s``.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import torch

from repro_torch import obs
from repro_torch.resil import faults
from repro_torch.resil.validate import IndexValidationError, validate_index


class IndexRebuilder:
    """One background build slot + validation gate.  Thread model: any
    number of ``submit``/``take``/``status`` callers (they lock); one
    worker thread at a time.  The index is built on the device of the
    submitted signatures."""

    def __init__(self, registry: obs.Registry | None = None, *,
                 probe: int = 64, seed: int = 0, validate: bool = True):
        self.obs = registry if registry is not None else obs.get()
        self.probe = probe
        self.seed = seed
        self.validate = validate
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._stream = None          # the worker's CUDA stream (lazily)
        self._staged = None          # (sigs, tail_cap) newest pending request
        self._result = None          # (validated index, done event)
        self._error: Exception | None = None
        self.builds = 0              # attempts started (public counters —
        self.failures = 0            # chaos tests assert on these)
        self.swaps_ready = 0

    # -- owner side ---------------------------------------------------------

    def submit(self, sigs: torch.Tensor, *, tail_cap: int) -> bool:
        """Request a rebuild from the full [q, N'] int32 signature tensor.
        Returns True if a worker started now, False if staged behind a
        running build (latest submission wins)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                self._staged = (sigs, tail_cap)
                return False
            self._staged = None
            self._result, self._error = None, None
            self.builds += 1
            dev = sigs.device
            ready = None
            if dev.type == "cuda":
                # the worker's stream waits for the submitter's work that
                # produced ``sigs``
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(dev))
            self._thread = threading.Thread(
                target=self._work, args=(sigs, tail_cap, dev, ready),
                daemon=True)
            self._thread.start()
            return True

    def status(self) -> str:
        """idle | building | ready | failed"""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return "building"
            if self._result is not None:
                return "ready"
            if self._error is not None:
                return "failed"
            return "idle"

    def take(self):
        """(status, index_or_None, error_or_None); "ready" hands the
        validated index over exactly once and, if a newer signature set
        was staged meanwhile, immediately starts building it.  On the
        card, the caller's current stream waits on the worker's
        post-validation event before the index is returned, and the
        index's tensors are recorded as used by it."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return "building", None, None
            res, err = self._result, self._error
            self._result, self._error = None, None
            staged, self._staged = self._staged, None
        if staged is not None:           # latest-wins restart outside lock
            self.submit(staged[0], tail_cap=staged[1])
        if res is not None:
            idx, done = res
            if done is not None:
                s = torch.cuda.current_stream(idx.device)
                s.wait_event(done)
                for f in dataclasses.fields(idx):
                    t = getattr(idx, f.name)
                    if isinstance(t, torch.Tensor):
                        t.record_stream(s)
            return "ready", idx, None
        if err is not None:
            return "failed", None, err
        return "idle", None, None

    def join(self, timeout: float | None = None) -> None:
        """Block until the current build (if any) finishes — for tests and
        synchronous callers; the serving loop never calls this."""
        t = self._thread
        if t is not None:
            t.join(timeout)

    # -- worker side --------------------------------------------------------

    def _work(self, sigs, tail_cap: int, dev: torch.device, ready) -> None:
        t0 = time.perf_counter()
        try:
            if dev.type == "cuda":
                if self._stream is None:
                    self._stream = torch.cuda.Stream(device=dev)
                self._stream.wait_event(ready)
                with torch.cuda.stream(self._stream):
                    idx = self._build_and_validate(sigs, tail_cap, dev)
                    done = torch.cuda.Event()
                    done.record(self._stream)
                self._stream.synchronize()   # the worker's own wait only
            else:
                idx = self._build_and_validate(sigs, tail_cap, dev)
                done = None
        except Exception as e:   # noqa: BLE001 — any failure means rollback
            with self._lock:
                self._error, self._result = e, None
                self.failures += 1
            self.obs.counter_add("serve.rebuild.failed")
            return
        with self._lock:
            self._result, self._error = (idx, done), None
            self.swaps_ready += 1
        self.obs.counter_add("serve.rebuild.built")
        self.obs.gauge_set("serve.rebuild.last_build_s",
                           time.perf_counter() - t0)

    def _build_and_validate(self, sigs, tail_cap: int, dev: torch.device):
        # imported here: serve.index imports this package (a cycle)
        from repro_torch.serve.index import build_index
        with self.obs.span("serve.rebuild.bg"):
            faults.fire("serve.rebuild")
            idx = build_index(sigs, tail_cap=tail_cap, device=dev)
            idx = faults.fire("serve.rebuild.index", idx)
            if self.validate:
                with self.obs.span("serve.rebuild.bg.validate"):
                    probs = validate_index(idx, probe=self.probe,
                                           seed=self.seed)
                if probs:
                    raise IndexValidationError(
                        "rebuilt index failed validation: "
                        + "; ".join(probs[:3]))
        return idx
