"""Span tracing with Chrome trace-event export (counterpart of
``repro.obs.tracing``; DESIGN.md §12).

``Tracer.span`` is a context manager recording a complete ("X"-phase)
event; ``Tracer.instant`` records a point event. Raw timestamps are kept
as the tracer clock's float **seconds** (``time.perf_counter`` by
default) — latency derivations (TTFT, TPOT) subtract raw floats so they
are bitwise-identical to the legacy ad-hoc timers they replace — and are
converted to the Chrome format's microseconds only at export.
``chrome_trace()`` emits the ``{"traceEvents": [...]}`` JSON object that
Perfetto / chrome://tracing load directly.

Like the metrics registry, a disabled tracer records nothing and costs a
single flag check per call.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple


class Tracer:
    """Append-only span/instant recorder with a Chrome-JSON exporter.

    Thread-safe appends; ``events`` entries are dicts with raw-seconds
    ``t`` (start) and, for spans, ``dur`` (seconds). ``enabled`` may be
    flipped at runtime (a span open across the flip still records)."""

    def __init__(self, enabled: bool = True, clock=time.perf_counter):
        self.enabled = enabled
        self.clock = clock
        self.events: List[dict] = []
        self._lock = threading.Lock()
        self._depth = threading.local()

    def _tid(self) -> int:
        return threading.get_ident() & 0x7FFFFFFF

    @contextlib.contextmanager
    def span(self, name: str, t0: Optional[float] = None,
             **args) -> Iterator[None]:
        """Record a complete event covering the with-block.

        ``t0`` overrides the recorded start time (raw clock seconds) so a
        caller that already stamped the moment — e.g. the serve loop's
        ``_run_t0`` — gets a span whose start is bitwise that stamp."""
        if not self.enabled:
            yield
            return
        start = self.clock() if t0 is None else t0
        d = getattr(self._depth, "v", 0)
        self._depth.v = d + 1
        try:
            yield
        finally:
            self._depth.v = d
            end = self.clock()
            with self._lock:
                self.events.append({
                    "name": name, "ph": "X", "t": start,
                    "dur": max(end - start, 0.0), "tid": self._tid(),
                    "depth": d, "args": args,
                })

    def complete(self, name: str, t0: float, t1: float, **args) -> None:
        """Record a complete span from two already-captured raw stamps —
        for callers that time a phase with their own clock reads and only
        afterwards know it is worth recording."""
        if not self.enabled:
            return
        with self._lock:
            self.events.append({
                "name": name, "ph": "X", "t": t0,
                "dur": max(t1 - t0, 0.0), "tid": self._tid(),
                "depth": getattr(self._depth, "v", 0), "args": args,
            })

    def instant(self, name: str, t: Optional[float] = None, **args) -> None:
        """Record a point event at ``t`` (raw clock seconds; now when
        omitted). ``args`` land in the Chrome event's ``args`` object."""
        if not self.enabled:
            return
        stamp = self.clock() if t is None else t
        with self._lock:
            self.events.append({
                "name": name, "ph": "i", "t": stamp, "tid": self._tid(),
                "args": args,
            })

    def clear(self) -> None:
        """Drop all recorded events."""
        with self._lock:
            self.events.clear()

    def chrome_trace(self) -> dict:
        """The Chrome trace-event JSON object: timestamps rebased to the
        earliest event and scaled to microseconds; spans are "X" events
        with ``dur``, instants are "i" events with process scope."""
        with self._lock:
            events = list(self.events)
        if not events:
            return {"traceEvents": []}
        base = min(e["t"] for e in events)
        out = []
        for e in events:
            ce = {
                "name": e["name"], "ph": e["ph"], "pid": 0,
                "tid": e["tid"], "ts": (e["t"] - base) * 1e6,
                "args": {k: _jsonable(v) for k, v in e["args"].items()},
            }
            if e["ph"] == "X":
                ce["dur"] = e["dur"] * 1e6
            else:
                ce["s"] = "p"
            out.append(ce)
        return {"traceEvents": out}

    def write(self, path: str) -> None:
        """Write ``chrome_trace()`` as JSON to ``path``."""
        with open(path, "w") as fh:
            json.dump(self.chrome_trace(), fh, indent=1)


def span_coverage(events: List[dict]) -> float:
    """Fraction of the trace's wall window covered by the union of its
    spans (raw-event form, i.e. ``Tracer.events``). 1.0 for an empty or
    span-free trace — nothing claimed, nothing missing."""
    spans = [(e["t"], e["t"] + e["dur"]) for e in events if e["ph"] == "X"]
    if not spans:
        return 1.0
    t_lo = min(s for s, _ in spans)
    t_hi = max(e for _, e in spans)
    if t_hi <= t_lo:
        return 1.0
    covered = 0.0
    cur_s, cur_e = None, None
    for s, e in sorted(spans):
        if cur_s is None:
            cur_s, cur_e = s, e
        elif s <= cur_e:
            cur_e = max(cur_e, e)
        else:
            covered += cur_e - cur_s
            cur_s, cur_e = s, e
    covered += cur_e - cur_s
    return covered / (t_hi - t_lo)


def chrome_span_coverage(trace: dict) -> float:
    """``span_coverage`` over an exported ``{"traceEvents": ...}`` object
    (microsecond timestamps) — what scripts/obs_check.py validates."""
    raw = [{"ph": e["ph"], "t": e.get("ts", 0.0),
            "dur": e.get("dur", 0.0)}
           for e in trace.get("traceEvents", [])]
    return span_coverage(raw)


def derive_request_latencies(
        events: List[dict], *,
        run_span: str = "serve.run",
        first_token: str = "serve.first_token",
        token: str = "serve.token",
) -> Tuple[Dict[int, float], Dict[int, float]]:
    """Per-request (TTFT, TPOT) derived from raw tracer events.

    TTFT for request ``rid`` is the ``first_token`` instant's raw stamp
    minus the enclosing ``run_span`` start — the same float subtraction
    the legacy ``PagedServer.ttft_s`` dict performed, so the two agree
    bitwise. TPOT is the mean gap between that request's successive
    ``token`` instants (empty dict entries for single-token requests)."""
    run_t0 = None
    for e in events:
        if e["name"] == run_span and e["ph"] == "X":
            run_t0 = e["t"]
            break
    ttft: Dict[int, float] = {}
    stamps: Dict[int, List[float]] = {}
    for e in events:
        rid = e["args"].get("rid") if e.get("args") else None
        if rid is None:
            continue
        if e["name"] == first_token and run_t0 is not None:
            ttft[rid] = e["t"] - run_t0
        if e["name"] in (first_token, token):
            stamps.setdefault(rid, []).append(e["t"])
    tpot = {
        rid: (ts[-1] - ts[0]) / (len(ts) - 1)
        for rid, ts in stamps.items() if len(ts) > 1
    }
    return ttft, tpot


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return str(v)
