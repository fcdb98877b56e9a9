"""Exporters for `repro_torch.obs` registries.

Three formats, one source of truth (`Registry`):

  * `chrome_trace` / `write_trace` — Chrome trace-event JSON ("X"
    complete events on the monotonic timebase).  Load in Perfetto
    (https://ui.perfetto.dev) or chrome://tracing; span nesting is
    reconstructed from interval containment per thread track.
  * `events_jsonl` / `write_events_jsonl` — one JSON object per line for
    time-series (`{"ts": <unix seconds>, "event": <name>, ...fields}`):
    recall/RMSE-over-time, queue depth, ΔΩ sizes.
  * `prometheus_text` — Prometheus text exposition (counters, gauges,
    and histogram summaries as quantile gauges), for scraping or diffing.
"""
from __future__ import annotations

import json
import re

from repro_torch.obs.registry import Registry

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def chrome_trace(reg: Registry) -> dict:
    """The registry's span log as a Chrome trace-event document."""
    with reg._lock:
        spans = list(reg.spans)
        origin = reg.origin_ns
    tids = {}
    events = [dict(name="process_name", ph="M", pid=0, tid=0,
                   args=dict(name="repro_torch.obs"))]
    for name, t0, dur, tid, depth in spans:
        track = tids.setdefault(tid, len(tids))
        events.append(dict(
            name=name, ph="X", pid=0, tid=track,
            ts=(t0 - origin) / 1e3,        # µs, monotonic, origin-relative
            dur=dur / 1e3,
            args=dict(depth=depth)))
    return dict(traceEvents=events, displayTimeUnit="ms")


def write_trace(reg: Registry, path: str) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(reg), f)
        f.write("\n")
    return path


def events_jsonl(reg: Registry) -> str:
    with reg._lock:
        events = list(reg.events)
    lines = [json.dumps(dict({"ts": ts, "event": name}, **fields))
             for ts, name, fields in events]
    return "\n".join(lines) + ("\n" if lines else "")


def write_events_jsonl(reg: Registry, path: str) -> str:
    with open(path, "w") as f:
        f.write(events_jsonl(reg))
    return path


def _prom_name(name: str) -> str:
    return _NAME_RE.sub("_", name)


def prometheus_text(reg: Registry) -> str:
    """Prometheus text exposition of the registry's metric plane."""
    snap = reg.snapshot()
    out = []
    for name, v in sorted(snap["counters"].items()):
        n = _prom_name(name)
        out += [f"# TYPE {n} counter", f"{n} {v:.9g}"]
    for name, v in sorted(snap["gauges"].items()):
        n = _prom_name(name)
        out += [f"# TYPE {n} gauge", f"{n} {v:.9g}"]
    for name, s in sorted(snap["histograms"].items()):
        n = _prom_name(name)
        out.append(f"# TYPE {n} summary")
        if s.get("count"):
            for q in ("p50", "p95", "p99"):
                out.append(f'{n}{{quantile="0.{q[1:]}"}} {s[q]:.9g}')
            out.append(f"{n}_sum {s['sum']:.9g}")
        out.append(f"{n}_count {s.get('count', 0)}")
    return "\n".join(out) + "\n"
