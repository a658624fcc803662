"""Process-local metrics registry (counterpart of ``repro.obs.metrics``;
DESIGN.md §12).

Counters, gauges, and histograms with fixed log-spaced buckets, organised
as *families* of labeled series (one family per metric name, one child per
label-value tuple). The registry is thread-safe (one lock around every
mutation) and **no-op when disabled**: a disabled registry hands every
caller the same shared no-op family/child singletons, so an instrumented
hot path costs one attribute read and one dict hit — nothing is allocated
and nothing is recorded.

Naming convention (enforced by style, validated by scripts/obs_check.py):
``repro_<subsystem>_<what>[_<unit>]`` with the Prometheus ``_total``
suffix on counters, e.g. ``repro_router_expert_tokens_total``,
``repro_serve_decode_step_seconds`` (a histogram), or
``repro_pagepool_free_pages`` (a gauge). Label values are always strings.

Library code never holds child handles across enable/disable flips — the
idiom is ``registry.counter(name).labels(v).inc()`` at the event site, so
a registry enabled mid-process picks the site up on its next event.
"""
from __future__ import annotations

import math
import threading
import weakref
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


def log_buckets(lo: float, hi: float, per_decade: int = 3) -> Tuple[float, ...]:
    """Fixed log-spaced histogram bucket upper bounds covering [lo, hi].

    ``per_decade`` bounds per power of ten; the list always ends at a
    bound >= hi so every finite observation lands in a real bucket (the
    rendered text still appends the Prometheus ``+Inf`` bucket)."""
    if lo <= 0 or hi <= lo:
        raise ValueError(f"need 0 < lo < hi, got ({lo}, {hi})")
    n = int(math.ceil(per_decade * math.log10(hi / lo)))
    return tuple(lo * 10 ** (i / per_decade) for i in range(n + 1))


#: Default latency buckets: 10µs .. 100s, 3 per decade (DESIGN.md §12).
DEFAULT_SECONDS_BUCKETS = log_buckets(1e-5, 100.0, per_decade=3)


class _NoopChild:
    """Shared do-nothing series: every mutator is a pass."""

    __slots__ = ()

    def inc(self, n: float = 1.0) -> None:
        """No-op."""

    def set(self, v: float) -> None:
        """No-op."""

    def observe(self, v: float) -> None:
        """No-op."""


class _NoopFamily(_NoopChild):
    """Shared do-nothing family: ``labels()`` returns the no-op child."""

    __slots__ = ()

    def labels(self, *values: str) -> "_NoopChild":
        """Return the shared no-op child regardless of label values."""
        return _NOOP_CHILD


_NOOP_CHILD = _NoopChild()
_NOOP_FAMILY = _NoopFamily()


class _Counter:
    """Monotonically-increasing series."""

    __slots__ = ("value", "_lock")

    def __init__(self, lock: threading.Lock):
        self.value = 0.0
        self._lock = lock

    def inc(self, n: float = 1.0) -> None:
        """Add ``n`` (must be >= 0) to the counter."""
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        with self._lock:
            self.value += n


class _Gauge:
    """Last-write-wins series."""

    __slots__ = ("value", "_lock")

    def __init__(self, lock: threading.Lock):
        self.value = 0.0
        self._lock = lock

    def set(self, v: float) -> None:
        """Set the gauge to ``v``."""
        with self._lock:
            self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        """Adjust the gauge by ``n`` (may be negative)."""
        with self._lock:
            self.value += n


class _Histogram:
    """Cumulative-bucket histogram over fixed upper bounds."""

    __slots__ = ("buckets", "counts", "sum", "count", "_lock")

    def __init__(self, lock: threading.Lock, buckets: Sequence[float]):
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)  # +1 = +Inf
        self.sum = 0.0
        self.count = 0
        self._lock = lock

    def observe(self, v: float) -> None:
        """Record one observation."""
        with self._lock:
            i = 0
            for i, b in enumerate(self.buckets):  # noqa: B007 — small, fixed
                if v <= b:
                    break
            else:
                i = len(self.buckets)
            self.counts[i] += 1
            self.sum += v
            self.count += 1


class Family:
    """One metric name holding one child series per label-value tuple."""

    def __init__(self, registry: "MetricsRegistry", name: str, kind: str,
                 help_text: str, label_names: Tuple[str, ...],
                 buckets: Optional[Sequence[float]] = None):
        self.registry = registry
        self.name = name
        self.kind = kind
        self.help = help_text
        self.label_names = label_names
        self.buckets = buckets
        self.children: Dict[Tuple[str, ...], object] = {}

    def labels(self, *values) -> object:
        """The child series for the given label values (created on first
        use). Call with no arguments on an unlabeled family."""
        key = tuple(str(v) for v in values)
        if len(key) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {key}")
        child = self.children.get(key)
        if child is None:
            with self.registry._lock:
                child = self.children.get(key)
                if child is None:
                    lock = self.registry._series_lock
                    if self.kind == "counter":
                        child = _Counter(lock)
                    elif self.kind == "gauge":
                        child = _Gauge(lock)
                    else:
                        child = _Histogram(
                            lock, self.buckets or DEFAULT_SECONDS_BUCKETS)
                    self.children[key] = child
        return child

    # Unlabeled convenience: family acts as its own default child.
    def inc(self, n: float = 1.0) -> None:
        """Increment the unlabeled series."""
        self.labels().inc(n)

    def set(self, v: float) -> None:
        """Set the unlabeled series."""
        self.labels().set(v)

    def observe(self, v: float) -> None:
        """Observe into the unlabeled series."""
        self.labels().observe(v)


class MetricsRegistry:
    """Process-local registry of metric families (DESIGN.md §12).

    ``enabled`` may be flipped at runtime: while False every accessor
    returns the shared no-op singletons (zero allocation, nothing
    recorded); flipping to True makes the *next* accessor call at each
    instrumented site record for real. ``register_object`` keeps a
    weakref to any object exposing ``obs_metrics() -> dict`` — those are
    polled (as gauges) at collection time, so counters that live on hot
    host paths (page pool, prefix index, pipeline cache) publish snapshots
    with zero per-increment overhead."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()        # family/registration mutations
        self._series_lock = threading.Lock()  # series value mutations
        self.families: Dict[str, Family] = {}
        self._objects: List[weakref.ref] = []
        self._object_seq = 0

    def _family(self, name: str, kind: str, help_text: str,
                labels: Tuple[str, ...],
                buckets: Optional[Sequence[float]] = None):
        if not self.enabled:
            return _NOOP_FAMILY
        fam = self.families.get(name)
        if fam is None:
            with self._lock:
                fam = self.families.get(name)
                if fam is None:
                    fam = Family(self, name, kind, help_text, labels, buckets)
                    self.families[name] = fam
        if fam.kind != kind:
            raise ValueError(
                f"metric {name} already registered as {fam.kind}")
        return fam

    def counter(self, name: str, help: str = "",
                labels: Tuple[str, ...] = ()):
        """The counter family ``name`` (no-op family when disabled)."""
        return self._family(name, "counter", help, tuple(labels))

    def gauge(self, name: str, help: str = "",
              labels: Tuple[str, ...] = ()):
        """The gauge family ``name`` (no-op family when disabled)."""
        return self._family(name, "gauge", help, tuple(labels))

    def histogram(self, name: str, help: str = "",
                  labels: Tuple[str, ...] = (),
                  buckets: Optional[Sequence[float]] = None):
        """The histogram family ``name`` with fixed log-spaced ``buckets``
        (``DEFAULT_SECONDS_BUCKETS`` when omitted)."""
        return self._family(name, "histogram", help, tuple(labels), buckets)

    def register_object(self, obj) -> None:
        """Keep a weakref to ``obj`` (which must expose ``obs_metrics()``)
        for snapshot polling at collection time. Safe to call while the
        registry is disabled — the object is polled once enabled. Dead
        references are dropped here too: the port's layer loop makes a
        ``PipelineSharedCache`` every forward (the JAX package's, every
        trace), and a disabled registry never collects."""
        with self._lock:
            self._objects = [r for r in self._objects if r() is not None]
            self._objects.append(weakref.ref(obj))
            self._object_seq += 1

    def collect(self) -> None:
        """Poll every live registered object's ``obs_metrics()`` snapshot
        into gauges labeled by ``kind`` (the object's class name) and
        ``instance`` (its registration order). Dead weakrefs are pruned."""
        if not self.enabled:
            return
        with self._lock:
            refs = list(self._objects)
        live = []
        for i, ref in enumerate(refs):
            obj = ref()
            if obj is None:
                continue
            live.append(ref)
            kind = type(obj).__name__.lower()
            for name, val in obj.obs_metrics().items():
                self.gauge(name, labels=("kind", "instance")).labels(
                    kind, str(i)).set(float(val))
        with self._lock:
            self._objects = live if len(live) != len(refs) else refs

    def value(self, name: str, *label_values) -> float:
        """Current value of a counter/gauge series (tests/driver reads);
        raises KeyError when the series does not exist."""
        fam = self.families[name]
        child = fam.children[tuple(str(v) for v in label_values)]
        return child.value

    def render_prometheus(self) -> str:
        """Render every family in the Prometheus text exposition format
        (``# HELP`` / ``# TYPE`` headers, one line per series, histograms
        as cumulative ``_bucket{le=...}`` + ``_sum`` + ``_count``).
        Polls registered snapshot objects first."""
        self.collect()
        out: List[str] = []
        with self._lock:
            fams = sorted(self.families.items())
        for name, fam in fams:
            if fam.help:
                out.append(f"# HELP {name} {fam.help}")
            out.append(f"# TYPE {name} {fam.kind}")
            for key in sorted(fam.children):
                child = fam.children[key]
                lbl = _labels_text(fam.label_names, key)
                if fam.kind == "histogram":
                    cum = 0
                    for b, c in zip(child.buckets, child.counts):
                        cum += c
                        le = _labels_text(
                            fam.label_names + ("le",), key + (_fmt(b),))
                        out.append(f"{name}_bucket{le} {cum}")
                    cum += child.counts[-1]
                    le = _labels_text(
                        fam.label_names + ("le",), key + ("+Inf",))
                    out.append(f"{name}_bucket{le} {cum}")
                    out.append(f"{name}_sum{lbl} {_fmt(child.sum)}")
                    out.append(f"{name}_count{lbl} {child.count}")
                else:
                    out.append(f"{name}{lbl} {_fmt(child.value)}")
        return "\n".join(out) + "\n" if out else ""


def _fmt(v: float) -> str:
    """Prometheus number formatting: integral floats render bare."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels_text(names: Iterable[str], values: Tuple[str, ...]) -> str:
    """Render a ``{k="v",...}`` label block ('' when unlabeled)."""
    pairs = [f'{k}="{_escape(v)}"' for k, v in zip(names, values)]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")
