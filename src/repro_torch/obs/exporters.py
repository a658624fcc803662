"""Exporters: Prometheus text dumps and the structured JSONL event log
(counterpart of ``repro.obs.exporters``; DESIGN.md §12).

``dump_prometheus`` writes the registry's text exposition atomically
(write-temp-then-rename) so a scraper tailing the file never reads a
torn dump. ``EventLog`` is the machine-readable sibling of the human
trace: every scheduler/recovery/replan event lands as one JSON object
per line with a monotonic timestamp and a ``reason`` field — the
post-mortem ordering record the chaos tests lacked.
"""
from __future__ import annotations

import json
import os
import time
from typing import List, Optional


def dump_prometheus(registry, path: str) -> None:
    """Atomically write ``registry.render_prometheus()`` to ``path``."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        fh.write(registry.render_prometheus())
    os.replace(tmp, path)


class EventLog:
    """Structured event recorder with JSONL export.

    Each ``emit`` stamps the event with the injectable monotonic clock
    (``time.perf_counter`` default — the same clock the serve scheduler
    uses, so event times interleave correctly with spans) plus a
    ``reason`` field (may be None) and arbitrary JSON-able context.
    Disabled logs record nothing."""

    def __init__(self, enabled: bool = True, clock=time.perf_counter):
        self.enabled = enabled
        self.clock = clock
        self.records: List[dict] = []

    def emit(self, kind: str, reason: Optional[str] = None,
             t: Optional[float] = None, **fields) -> None:
        """Record one event (no-op when disabled). ``t`` overrides the
        stamp for call sites that already captured the moment."""
        if not self.enabled:
            return
        rec = {"t": self.clock() if t is None else t, "kind": kind,
               "reason": reason}
        rec.update(fields)
        self.records.append(rec)

    def write_jsonl(self, path: str) -> None:
        """Write one JSON object per line (atomic rename, like the
        Prometheus dump)."""
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            for rec in self.records:
                fh.write(json.dumps(rec, default=str) + "\n")
        os.replace(tmp, path)
