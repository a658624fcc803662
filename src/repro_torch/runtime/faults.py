"""Deterministic fault injection: the chaos substrate (counterpart of
``repro.runtime.faults``; DESIGN.md §9).

A ``FaultPlan`` is a seedable script of faults keyed to named injection
**sites** the drivers call through ``inject(site)``: with no plan
installed that is one attribute read. The same plan fires at the same
calls as the JAX package's, so a scenario replays on both.

Sites:

  ``train.step``            before a training step runs (through
                            ``launch.steps.wrap_step_with_faults``)
  ``train.preempt``         polled once a step by ``ft.run_with_recovery``
  ``train.loss``            after a step: ``nan`` poisons the reported loss
  ``ckpt.write``            after a checkpoint directory commits:
                            ``truncate`` / ``bitflip`` damage a committed
                            leaf file, the storage failure
                            ``checkpoint.manager.verify`` and
                            ``latest_valid_step`` exist to catch
  ``serve.decode``          before a paged decode macro-step (or a
                            speculative tick)
  ``serve.prefill``         before a paged prefill chunk
  ``serve.logits``          after a decode step or verify forward: ``nan``
                            poisons one slot's logits
  ``serve.prefill_logits``  after a prompt's last prefill chunk: ``nan``
                            poisons the first-token logits

Kinds:

  ``error``        raise ``FaultError``. With a ``{"slot": k}`` payload the
                   serving engine aborts and retries slot ``k``'s request;
                   without one it rebuilds its steps and resumes; the
                   trainer restores the newest valid checkpoint.
  ``device_drop``  raise ``DeviceLostError`` carrying
                   ``payload["survivors"]`` (the elastic-shrink trigger).
  ``delay``        sleep ``payload["delay_s"]``.
  ``nan``          returned to the site, which poisons the named value.
  ``preempt``      returned to the site (``ft`` sets the SIGTERM flag).
  ``truncate`` / ``bitflip``  returned to the ``ckpt.write`` site, which
                   applies :func:`corrupt_checkpoint`.

Matching is by per-site call counters (``at``: 0-based call index,
``every``: periodic) or a ``prob`` drawn from the plan's own seeded RNG,
at most ``times`` firings; every firing bumps the registry's
``repro_faults_fired_total`` counter (by site and kind).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch import obs


class FaultError(RuntimeError):
    """An injected step failure. ``fault`` is the spec that fired, so
    recovery code can read its payload (which slot a serving fault
    poisons)."""

    def __init__(self, message: str, fault: Optional["Fault"] = None):
        super().__init__(message)
        self.fault = fault


class DeviceLostError(FaultError):
    """An injected device dropout; ``survivors`` names what is left: an
    int count (the first ranks of a training mesh) or a sequence of
    surviving ranks or page-pool groups."""

    def __init__(self, message: str, fault: Optional["Fault"] = None,
                 survivors: Any = None):
        super().__init__(message, fault)
        self.survivors = survivors


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scripted fault: fire at ``site`` when its call counter equals
    ``at``, or every ``every`` calls (never the 0th), or with probability
    ``prob`` under the plan's RNG; at most ``times`` firings. ``payload``
    is read per (site, kind)."""

    site: str
    kind: str
    at: Optional[int] = None
    every: Optional[int] = None
    prob: float = 0.0
    times: int = 1
    payload: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def matches(self, call: int, rng: np.random.Generator) -> bool:
        """Does this fault fire on the site's ``call``-th invocation?"""
        if self.at is not None:
            return call == self.at
        if self.every is not None:
            return call % self.every == 0 and call > 0
        if self.prob > 0.0:
            return bool(rng.random() < self.prob)
        return False


class FaultPlan:
    """Seeded :class:`Fault` specs plus the per-site call counters that
    make firing deterministic. ``fired`` logs every firing as ``(site,
    call_index, kind)``."""

    def __init__(self, faults: Sequence[Fault] = (), seed: int = 0):
        self.faults: List[List[Any]] = [[f, f.times] for f in faults]
        self.rng = np.random.default_rng(seed)
        self.calls: Dict[str, int] = {}
        self.fired: List[tuple] = []

    @classmethod
    def from_spec(cls, spec: Dict[str, Any]) -> "FaultPlan":
        """From ``{"seed": 0, "faults": [{"site": ..., "kind": ...,
        ...}, ...]}``."""
        faults = [Fault(**f) for f in spec.get("faults", ())]
        return cls(faults, seed=int(spec.get("seed", 0)))

    def fire(self, site: str, **ctx) -> List[Fault]:
        """Advance ``site``'s counter and return the faults that fire on
        this call (each one's remaining ``times`` decremented)."""
        call = self.calls.get(site, 0)
        self.calls[site] = call + 1
        out = []
        for entry in self.faults:
            f, remaining = entry
            if f.site != site or remaining <= 0:
                continue
            if f.matches(call, self.rng):
                entry[1] -= 1
                self.fired.append((site, call, f.kind))
                obs.registry.counter(
                    "repro_faults_fired_total",
                    "injected faults that fired, by site and kind",
                    labels=("site", "kind")).labels(site, f.kind).inc()
                out.append(f)
        return out


def load_plan(spec: str) -> FaultPlan:
    """A plan from inline JSON (leading ``{``) or a JSON file's path: the
    ``--fault-spec`` CLI contract."""
    text = spec
    if not spec.lstrip().startswith("{"):
        with open(spec) as fh:
            text = fh.read()
    return FaultPlan.from_spec(json.loads(text))


_ACTIVE: Optional[FaultPlan] = None


def install(plan: Optional[FaultPlan]) -> None:
    """Install ``plan`` as the process-wide active plan (None disables)."""
    global _ACTIVE
    _ACTIVE = plan


def active() -> Optional[FaultPlan]:
    """The installed plan, or None."""
    return _ACTIVE


@contextlib.contextmanager
def scope(plan: Optional[FaultPlan]):
    """Install ``plan`` for the duration of a with-block."""
    prev = _ACTIVE
    install(plan)
    try:
        yield plan
    finally:
        install(prev)


def inject(site: str, **ctx) -> List[Fault]:
    """The hook every instrumented site calls: raises for ``error`` and
    ``device_drop``, sleeps for ``delay`` and returns the other fired
    faults for the site to interpret. A no-op without a plan."""
    plan = _ACTIVE
    if plan is None:
        return []
    passthrough = []
    for f in plan.fire(site, **ctx):
        if f.kind == "device_drop":
            raise DeviceLostError(
                f"injected device loss at {site} "
                f"(call {plan.calls[site] - 1})",
                fault=f, survivors=f.payload.get("survivors"))
        if f.kind == "error":
            raise FaultError(
                f"injected fault at {site} (call {plan.calls[site] - 1})",
                fault=f)
        if f.kind == "delay":
            time.sleep(float(f.payload.get("delay_s", 0.01)))
        else:
            passthrough.append(f)
    return passthrough


# ---------------------------------------------------------------------------
# checkpoint corruption (the ``ckpt.write`` site's payload interpreter)
# ---------------------------------------------------------------------------

def corrupt_checkpoint(path: str, fault: Fault) -> str:
    """Damage one committed leaf file under checkpoint directory ``path``
    (``payload["leaf"]``, default 0): ``truncate`` drops the trailing half
    of its bytes (a partial write), ``bitflip`` XORs 0x40 into the byte at
    ``payload["offset"]`` (default mid-file; silent media corruption).
    Returns the damaged file's path. Both are what
    ``checkpoint.manager.verify``'s byte counts and crc32 exist to catch,
    and both damage the same bytes the JAX package's does."""
    leaf = int(fault.payload.get("leaf", 0))
    target = os.path.join(path, f"a_{leaf:05d}.npy")
    with open(target, "rb") as fh:
        data = bytearray(fh.read())
    if fault.kind == "truncate":
        data = data[: max(1, len(data) // 2)]
    elif fault.kind == "bitflip":
        pos = int(fault.payload.get("offset", len(data) // 2))
        data[pos] ^= 0x40
    else:
        raise ValueError(f"unknown corruption kind {fault.kind!r}")
    with open(target, "wb") as fh:
        fh.write(bytes(data))
    return target
