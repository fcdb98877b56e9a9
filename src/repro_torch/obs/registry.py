"""Metrics registry + nested spans — the repo's single source of timing
truth.

A `Registry` holds three metric families plus two event logs:

  * **counters** — monotonically increasing floats (`counter_add`);
  * **gauges**   — last-value-wins floats (`gauge_set`);
  * **histograms** — fixed log-spaced buckets (`observe`): p50/p95/p99
    come from bucket interpolation, so no samples are retained and a
    histogram's memory is constant regardless of observation count.
    Exact count/sum/min/max ride along, so means are exact even though
    quantiles are bucket-resolution (one bucket per 1/16 decade —
    ≤ ~15.5% relative quantile error, verified against numpy in
    tests/test_obs.py).
  * **spans** — nested wall-time intervals (`with reg.span("flush.retrieve")`)
    on the monotonic clock (`perf_counter_ns`), kept in a bounded log for
    Chrome-trace export (export.py) and per-name duration queries
    (`span_durations`).  Every span completion also feeds the histogram
    of the same name, so quantiles survive after the span log wraps.
  * **events** — timestamped dict records (`event("eval", rmse=...)`) for
    JSONL time-series export (recall/RMSE-over-time, queue depth).

Disabled-mode contract (the default for the module-level registry in
`repro_torch.obs`): every recording call is a cheap no-op — `span()` returns a
shared singleton context manager and counter/gauge/observe/event return
before touching any dict — so instrumentation can stay in hot paths
unconditionally.  `tests/test_obs.py::test_disabled_mode_no_alloc`
asserts the no-allocation property.

Spans can optionally mirror into `torch.profiler.record_function`
(``profiler_annotations=True``) so the same stage names appear on the
host timeline of device profiles captured with `torch.profiler.profile`
on a CUDA card.
"""
from __future__ import annotations

import math
import threading
import time

# ---------------------------------------------------------------------------
# histograms
# ---------------------------------------------------------------------------

# bucket grid: 16 buckets per decade, 1e-9 .. 1e6 (covers ns spans to
# ~11-day counters); two overflow buckets catch everything outside
_B_PER_DECADE = 16
_LO_EXP, _HI_EXP = -9, 6
_N_BUCKETS = (_HI_EXP - _LO_EXP) * _B_PER_DECADE
_LOG_LO = float(_LO_EXP)
_SCALE = _B_PER_DECADE  # buckets per unit of log10


def bucket_bounds() -> list:
    """Upper bound of every finite bucket (length _N_BUCKETS)."""
    return [10.0 ** (_LO_EXP + (i + 1) / _SCALE) for i in range(_N_BUCKETS)]


class Histogram:
    """Fixed-bucket log-spaced histogram; O(1) observe, O(buckets) quantile."""

    __slots__ = ("counts", "under", "over", "count", "sum", "min", "max")

    def __init__(self):
        self.counts = [0] * _N_BUCKETS
        self.under = 0          # values ≤ 1e-9 (incl. zero/negative)
        self.over = 0           # values > 1e6
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v <= 10.0 ** _LO_EXP:
            self.under += 1
        elif v > 10.0 ** _HI_EXP:
            self.over += 1
        else:
            # idx such that bound[idx-1] < v <= bound[idx]
            idx = int(math.ceil((math.log10(v) - _LOG_LO) * _SCALE)) - 1
            self.counts[min(max(idx, 0), _N_BUCKETS - 1)] += 1

    def quantile(self, q: float) -> float:
        """Approximate q-quantile by log-linear interpolation inside the
        target bucket, clamped to the exact observed [min, max]."""
        if not self.count:
            return math.nan
        rank = q * (self.count - 1) + 1          # 1-based target rank
        seen = self.under
        if rank <= seen:                          # inside the under bucket
            return self.min
        for i, c in enumerate(self.counts):
            if not c:
                continue
            if rank <= seen + c:
                lo = 10.0 ** (_LO_EXP + i / _SCALE)
                hi = 10.0 ** (_LO_EXP + (i + 1) / _SCALE)
                frac = (rank - seen) / c
                val = lo * (hi / lo) ** frac
                return min(max(val, self.min), self.max)
            seen += c
        return self.max                           # over bucket / tail

    def summary(self) -> dict:
        if not self.count:
            return dict(count=0)
        return dict(count=self.count, sum=self.sum,
                    mean=self.sum / self.count, min=self.min, max=self.max,
                    p50=self.quantile(0.50), p95=self.quantile(0.95),
                    p99=self.quantile(0.99))


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


class _NullSpan:
    """Shared do-nothing context manager for disabled registries."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("reg", "name", "t0", "_ann")

    def __init__(self, reg: "Registry", name: str):
        self.reg = reg
        self.name = name
        self._ann = None

    def __enter__(self):
        reg = self.reg
        if reg._prof_ann:
            from torch.profiler import record_function
            self._ann = record_function(self.name)
            self._ann.__enter__()
        reg._stack().append(self.name)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self.t0
        reg = self.reg
        stack = reg._stack()
        stack.pop()
        reg._end_span(self.name, self.t0, dur, len(stack))
        if self._ann is not None:
            self._ann.__exit__(*exc)
        return False


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


class Registry:
    """Thread-safe metrics + span + event store.  See the module docstring
    for the metric families and the disabled-mode contract."""

    def __init__(self, enabled: bool = False, *, max_spans: int = 200_000,
                 max_events: int = 200_000, profiler_annotations: bool = False,
                 mirror: "Registry | None" = None):
        self.enabled = enabled
        self.max_spans = max_spans
        self.max_events = max_events
        self._prof_ann = profiler_annotations
        # span mirror: completed spans are *also* appended to this
        # registry's span log whenever it is enabled — the pattern for a
        # component (e.g. RecsysService) that needs private metrics
        # (counters/histograms that must not blend with other components
        # reading the same names) while still contributing its spans to
        # the process-wide --trace timeline.  Only the span log mirrors;
        # the mirror's metric plane is untouched.
        self.mirror = mirror
        self._lock = threading.Lock()
        self._tls = threading.local()
        self.counters: dict = {}
        self.gauges: dict = {}
        self.hists: dict = {}
        # span log entries: (name, t_start_ns, dur_ns, tid, depth)
        self.spans: list = []
        self.spans_dropped = 0
        # event log entries: (wall_ts, name, fields-dict)
        self.events: list = []
        self.events_dropped = 0
        self.origin_ns = time.perf_counter_ns()
        self.origin_wall = time.time()

    # -- lifecycle ----------------------------------------------------------

    def enable(self, *, profiler_annotations: bool | None = None) -> "Registry":
        self.enabled = True
        if profiler_annotations is not None:
            self._prof_ann = profiler_annotations
        return self

    def disable(self) -> "Registry":
        self.enabled = False
        return self

    def reset(self) -> "Registry":
        """Drop all recorded state (enabled flag untouched)."""
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.hists.clear()
            self.spans.clear()
            self.events.clear()
            self.spans_dropped = self.events_dropped = 0
            self.origin_ns = time.perf_counter_ns()
            self.origin_wall = time.time()
        return self

    # -- metric plane -------------------------------------------------------

    def counter_add(self, name: str, value: float = 1.0) -> None:
        if not self.enabled:
            return
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + value

    def gauge_set(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            self.gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            h = self.hists.get(name)
            if h is None:
                h = self.hists[name] = Histogram()
            h.observe(value)

    def event(self, name: str, **fields) -> None:
        if not self.enabled:
            return
        with self._lock:
            if len(self.events) >= self.max_events:
                self.events_dropped += 1
                return
            self.events.append((time.time(), name, fields))

    # -- span plane ---------------------------------------------------------

    def span(self, name: str):
        """Nested timing scope: ``with reg.span("flush.retrieve"): ...``.
        Returns a shared no-op when the registry is disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name)

    def _stack(self) -> list:
        s = getattr(self._tls, "stack", None)
        if s is None:
            s = self._tls.stack = []
        return s

    def _end_span(self, name, t0, dur_ns, depth) -> None:
        tid = threading.get_ident()
        with self._lock:
            if len(self.spans) < self.max_spans:
                self.spans.append((name, t0, dur_ns, tid, depth))
            else:
                self.spans_dropped += 1
            h = self.hists.get(name)
            if h is None:
                h = self.hists[name] = Histogram()
            h.observe(dur_ns * 1e-9)
        # span t0s are absolute perf_counter_ns, so a mirrored entry stays
        # consistent under the mirror's own origin; taken outside our lock
        # (mirrors are acyclic by construction — the process default never
        # mirrors anywhere)
        m = self.mirror
        if m is not None and m is not self and m.enabled:
            with m._lock:
                if len(m.spans) < m.max_spans:
                    m.spans.append((name, t0, dur_ns, tid, depth))
                else:
                    m.spans_dropped += 1

    def record_span(self, name: str, t0_ns: int, dur_ns: int,
                    depth: int = 0) -> None:
        """Record an externally-timed interval as a completed span — for
        intervals that overlap or cross function boundaries (e.g. the
        dispatch-ahead flush latency, measured dispatch → result
        readiness while the next flush is already in flight)."""
        if not self.enabled:
            return
        self._end_span(name, t0_ns, dur_ns, depth)

    def span_durations(self, name: str) -> list:
        """Seconds of every retained completed span named ``name``, in
        completion order (subject to the max_spans retention cap; the
        histogram of the same name never drops observations)."""
        with self._lock:
            return [s[2] * 1e-9 for s in self.spans if s[0] == name]

    # -- read plane ---------------------------------------------------------

    def counter(self, name: str, default: float = 0.0) -> float:
        return self.counters.get(name, default)

    def gauge(self, name: str, default: float = math.nan) -> float:
        return self.gauges.get(name, default)

    def hist_summary(self, name: str) -> dict:
        h = self.hists.get(name)
        return h.summary() if h is not None else dict(count=0)

    def snapshot(self) -> dict:
        """One dict with everything: counters, gauges, histogram summaries,
        span/event log occupancy.  The unified export every consumer
        (stats(), benchmarks, exporters) reads."""
        with self._lock:
            return dict(
                counters=dict(self.counters),
                gauges=dict(self.gauges),
                histograms={k: h.summary() for k, h in self.hists.items()},
                spans=dict(retained=len(self.spans),
                           dropped=self.spans_dropped),
                events=dict(retained=len(self.events),
                            dropped=self.events_dropped),
            )
