"""The device trace of a traced window (``torch.profiler``, CUPTI) reduced
to plain records that the per-layer metric readers read.

``Capture`` is a context manager: it synchronizes, starts the profiler
and opens the range ``hexabench.window``; on exit it synchronizes, closes
both and keeps, from the raw kineto events (no per-event Python objects
of the profiler's own), the device operations (kernels, copies, sets)
with the host time of the call that launched each, and the host ranges
that the benchmark and the program open with ``record_function``.
All times are the profiler's nanoseconds.
"""
from __future__ import annotations

import collections

import torch

WINDOW = "hexabench.window"
#: The host ranges kept: the benchmark's own and the program's update.
RANGE_PREFIXES = ("hexabench.", "train_step.")


class Capture:
    def __init__(self):
        self.records = None

    def __enter__(self):
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._range = torch.profiler.record_function(WINDOW)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self._range.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.records = reduce(self._prof.profiler.kineto_results.events())
        del self._prof
        return False


def reduce(events) -> dict:
    """``{"window": (t0, t1), "ops": [(name, start, end, launch)],
    "ranges": {name: [(start, end)]}}`` from kineto events; ``launch`` is
    the start of the host call that launched the op (None where no call
    was traced)."""
    launches, ops, ranges = {}, [], collections.defaultdict(list)
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                ops.append((name, e.start_ns(), e.end_ns(),
                            e.correlation_id()))
            continue
        if name.startswith(RANGE_PREFIXES):
            ranges[name].append((e.start_ns(), e.end_ns()))
        elif name.startswith("cu"):       # runtime/driver API calls
            launches[e.correlation_id()] = e.start_ns()
    ops = [(n, s, t, launches.get(c)) for n, s, t, c in ops]
    ops.sort(key=lambda o: o[1])
    if not ranges.get(WINDOW):
        raise RuntimeError("the traced window's range is missing")
    window = ranges.pop(WINDOW)[0]
    return {"window": window, "ops": ops, "ranges": dict(ranges)}


# ---------------------------------------------------------------------------
# interval arithmetic shared by the readers
# ---------------------------------------------------------------------------

def union(intervals, lo=None, hi=None) -> list:
    """Merged, sorted intervals, clipped to [lo, hi]."""
    out = []
    for s, t in sorted(intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            t = min(t, hi)
        if t <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def covered_ns(intervals, lo=None, hi=None) -> int:
    return sum(t - s for s, t in union(intervals, lo, hi))


def in_ranges(t, ranges) -> bool:
    return t is not None and any(s <= t <= e for s, e in ranges)


def window_ops(rec: dict) -> list:
    lo, hi = rec["window"]
    return [o for o in rec["ops"] if o[2] > lo and o[1] < hi]


def busy_ns(rec: dict) -> int:
    """Nanoseconds of the window in which any device operation ran."""
    lo, hi = rec["window"]
    return covered_ns([(o[1], o[2]) for o in rec["ops"]], lo, hi)


def breakdown(rec: dict, top: int = 10) -> dict:
    """The device operations that took the most time, and the idle gaps
    summed by the innermost benchmark or program range the host was in at
    each gap's middle."""
    lo, hi = rec["window"]
    by_name = collections.Counter()
    for name, s, t, _ in window_ops(rec):
        by_name[name] += (min(t, hi) - max(s, lo)) / 1e9
    busy = union([(o[1], o[2]) for o in rec["ops"]], lo, hi)
    gaps, prev = [], lo
    for s, t in busy + [[hi, hi]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    spans = sorted(((s, e, n) for n, rs in rec["ranges"].items()
                    for s, e in rs), key=lambda r: r[1] - r[0])
    idle = collections.Counter()
    for s, t in gaps:
        mid = (s + t) // 2
        label = next((n for a, b, n in spans if a <= mid <= b), "outside")
        idle[label] += (t - s) / 1e9
    return {"device_ops": [[n, v] for n, v in by_name.most_common(top)],
            "idle_gaps": [[n, v] for n, v in idle.most_common(top)]}


def summary(rec: dict) -> dict:
    """``busy_s``, ``window_s`` and ``breakdown`` of a traced window."""
    lo, hi = rec["window"]
    return {"busy_s": busy_ns(rec) / 1e9, "window_s": (hi - lo) / 1e9,
            "breakdown": breakdown(rec)}


def launched_in_ns(rec: dict, range_name: str) -> int:
    """Device time of the operations launched inside the host range
    ``range_name`` (the union of their intervals within the window)."""
    ranges = sorted(rec["ranges"].get(range_name, []))
    lo, hi = rec["window"]
    return covered_ns([(o[1], o[2]) for o in rec["ops"]
                       if in_ranges(o[3], ranges)], lo, hi)


def named_ns(rec: dict, pattern) -> int:
    """Device time of the operations whose name matches ``pattern`` (a
    compiled regular expression), within the window."""
    lo, hi = rec["window"]
    return covered_ns([(o[1], o[2]) for o in rec["ops"]
                       if pattern.search(o[0])], lo, hi)


#: The port's expert kernels (``csrc/es*.cu``).
EXPERT_KERNELS = r"\b(esffn|esfk|esmm|ess|estmm)_\w*kernel"
