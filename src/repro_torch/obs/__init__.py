"""`repro_torch.obs` — unified metrics, spans, and trace export.

A copy of the JAX package's `repro.obs` (stdlib only), kept here so the
PyTorch port never imports the JAX package; the one change is that
spans annotate `torch.profiler` traces instead of JAX profiles.

One module-level default `Registry`, **disabled** unless a process opts
in (`obs.enable()`), so library code can instrument unconditionally:

    from repro_torch import obs
    obs.enable()                       # or leave disabled: all no-ops
    with obs.span("train.epoch"):
        ...
    obs.counter_add("train.updates", nnz)
    obs.event("eval", epoch=3, rmse=0.81)
    obs.write_trace("/tmp/trace.json")     # → Perfetto / chrome://tracing

Components that must always keep stats have two patterns.  A singleton
per process (a `fit()` call) uses `obs.scoped()`: the shared default
registry when enabled — so everything lands on one timeline — or a
*private enabled* registry otherwise, so its own stats work while the
rest of the process pays the disabled-mode no-op cost only.  A component
that can have same-named siblings (a `RecsysService` — two services both
write `serve.users`, `serve.busy_seconds`, `serve.flush`) instead keeps
a private registry with ``Registry(enabled=True, mirror=obs.get())``:
its metric plane never blends with a sibling's, while completed spans
are mirrored onto the default registry's timeline whenever that is
enabled (`--trace`).

Naming scheme (see docs/ARCHITECTURE.md §7): dot-separated
`<subsystem>.<stage>[.<substage>]` — e.g. `serve.flush.retrieve.dedup`,
`train.epoch.eval`, `online.merge`.  A span's histogram shares its name;
counters/gauges use the same prefixes (`serve.users`,
`serve.queue_depth`).
"""
from __future__ import annotations

from repro_torch.obs import export as _export
from repro_torch.obs.registry import Histogram, Registry

__all__ = [
    "Registry", "Histogram", "get", "scoped", "enable", "disable",
    "enabled", "reset", "span", "counter_add", "gauge_set", "observe",
    "event", "snapshot", "span_durations", "chrome_trace", "write_trace",
    "events_jsonl", "write_events_jsonl", "prometheus_text",
]

_DEFAULT = Registry(enabled=False)


def get() -> Registry:
    """The process-wide default registry."""
    return _DEFAULT


def scoped() -> Registry:
    """The default registry when enabled, else a fresh private *enabled*
    one — for components whose stats must work regardless of the global
    opt-in (their recording cost is theirs alone in that case)."""
    return _DEFAULT if _DEFAULT.enabled else Registry(enabled=True)


def enable(*, profiler_annotations: bool | None = None) -> Registry:
    return _DEFAULT.enable(profiler_annotations=profiler_annotations)


def disable() -> Registry:
    return _DEFAULT.disable()


def enabled() -> bool:
    return _DEFAULT.enabled


def reset() -> Registry:
    return _DEFAULT.reset()


# -- recording conveniences on the default registry -------------------------

def span(name: str):
    return _DEFAULT.span(name)


def counter_add(name: str, value: float = 1.0) -> None:
    _DEFAULT.counter_add(name, value)


def gauge_set(name: str, value: float) -> None:
    _DEFAULT.gauge_set(name, value)


def observe(name: str, value: float) -> None:
    _DEFAULT.observe(name, value)


def event(name: str, **fields) -> None:
    _DEFAULT.event(name, **fields)


def snapshot() -> dict:
    return _DEFAULT.snapshot()


def span_durations(name: str) -> list:
    return _DEFAULT.span_durations(name)


# -- exporters (any registry; default to the shared one) --------------------

def chrome_trace(reg: Registry | None = None) -> dict:
    return _export.chrome_trace(reg or _DEFAULT)


def write_trace(path: str, reg: Registry | None = None) -> str:
    return _export.write_trace(reg or _DEFAULT, path)


def events_jsonl(reg: Registry | None = None) -> str:
    return _export.events_jsonl(reg or _DEFAULT)


def write_events_jsonl(path: str, reg: Registry | None = None) -> str:
    return _export.write_events_jsonl(reg or _DEFAULT, path)


def prometheus_text(reg: Registry | None = None) -> str:
    return _export.prometheus_text(reg or _DEFAULT)
