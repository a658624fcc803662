"""Observability (counterpart of ``repro.obs``; DESIGN.md §12).

Three pillars behind one module-level handle:

* **metrics** — a process-local :class:`MetricsRegistry` (counters,
  gauges, log-bucket histograms; labeled series; thread-safe; no-op when
  disabled) plus the on-device router accumulators in ``obs.device``.
* **tracing** — :class:`Tracer` span/instant recording with Chrome
  trace-event JSON export (Perfetto-loadable).
* **exporters** — Prometheus text dumps and the JSONL event log.

The process-wide instances are created **disabled** at import, so
instrumented library code (``runtime.ft``, ``runtime.straggler``,
``runtime.faults``, ``parallel.cache``, ``parallel.autotune``) pays one
flag check per event until a driver calls :func:`configure`. The
instances are persistent: ``configure`` flips their ``enabled`` flags
rather than swapping objects, so snapshot objects registered before
enablement still publish afterwards.
"""
from __future__ import annotations

from repro_torch.obs.device import (  # noqa: F401 — re-exports
    RouterStatsDrain,
    add_stats,
    expert_stats,
    load_imbalance,
    zero_stats,
)
from repro_torch.obs.exporters import EventLog, dump_prometheus  # noqa: F401
from repro_torch.obs.metrics import (  # noqa: F401
    DEFAULT_SECONDS_BUCKETS,
    MetricsRegistry,
    log_buckets,
)
from repro_torch.obs.tracing import (  # noqa: F401
    Tracer,
    chrome_span_coverage,
    derive_request_latencies,
    span_coverage,
)

#: Process-wide instances, disabled until a driver calls configure().
registry = MetricsRegistry(enabled=False)
tracer = Tracer(enabled=False)
events = EventLog(enabled=False)


def configure(metrics: bool = True, tracing: bool = True,
              event_log: bool = True, reset: bool = False) -> None:
    """Enable (or disable) the process-wide observability instances.

    ``reset`` clears previously recorded spans/events — drivers use it so
    back-to-back runs in one process (tests, benchmarks) start clean."""
    registry.enabled = metrics
    tracer.enabled = tracing
    events.enabled = event_log
    if reset:
        tracer.clear()
        events.records.clear()
        registry.families.clear()


def enabled() -> bool:
    """True when any pillar is currently recording."""
    return registry.enabled or tracer.enabled or events.enabled


def maybe_register(obj) -> None:
    """Register ``obj`` (exposing ``obs_metrics()``) for snapshot polling
    on the process-wide registry — always safe, weakref-held, and cheap,
    so constructors call it unconditionally."""
    registry.register_object(obj)
