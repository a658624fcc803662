"""Fault tolerance: checkpoint policy, preemption handling, retry loop
(counterpart of ``repro.runtime.ft``).

The training driver wraps its step loop in ``run_with_recovery``:

  * periodic async checkpoints (every ``save_every`` steps), with
    retention GC ordered *after* each write lands (the GC callback runs
    in the saver's worker thread post-commit, so retention is computed
    against a listing that contains the new checkpoint and can never
    race the in-flight write),
  * a SIGTERM/SIGINT handler that requests an immediate checkpoint and a
    clean exit (a preemption notice) — installed for exactly the
    lifetime of the loop (try/finally), so no raise path leaves the
    process's signal handlers hijacked,
  * on step failure (device error, NaN-loss watchdog): restore the newest
    checkpoint **that passes integrity verification** (corrupt/partial
    checkpoints are skipped — ``checkpoint.manager.valid_steps``) and
    continue, governed by a sliding-window failure budget with
    exponential backoff + deterministic jitter,
  * on ``faults.DeviceLostError`` (device dropout): hand the error to the
    caller's ``on_device_loss`` hook, which re-meshes via
    ``runtime.elastic``, re-derives the plan, and returns the new state
    template + shardings to restore under (DESIGN.md §9),
  * deterministic data resume: the data pipeline is a pure function of the
    step counter, so restore(step) replays the exact remaining stream.

On a mesh every rank runs the loop with the same ``FTConfig``:
``shardings`` is the state's ``checkpoint.manager.MeshPlacement``, each
save gathers the logical leaves and the mesh's first rank writes them,
and every rank waits at a barrier after each snapshot and before reading
a checkpoint. Injected faults fire on every rank at the same call (each
installs the same plan) and the step's loss is the mesh's, so every rank
takes the same branch. A real failure of one rank alone is out of scope,
as it is for the JAX package's single controller.
"""
from __future__ import annotations

import collections
import dataclasses
import signal
import time
from typing import Any, Callable, Optional

import numpy as np

from repro_torch import obs
from repro_torch.checkpoint import manager as ckpt
from repro_torch.runtime import faults as faults_lib


def _say(*args) -> None:
    """Print on the job's rank 0 (or without a process group), as the JAX
    package's single controller prints once."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_rank() == 0:
        print(*args)


@dataclasses.dataclass
class FTConfig:
    """Fault-tolerance policy: checkpoint cadence/retention and the
    failure budget of the retry loop (``run_with_recovery``).

    The budget is a **sliding window**: at most ``max_failures`` failures
    within the trailing ``failure_window_s`` seconds — a lifetime counter
    would eventually kill any long job with a nonzero background failure
    rate, while a window distinguishes a crash loop from sparse noise.
    Each failure inside the window backs off ``backoff_base_s * 2**(n-1)``
    seconds (capped at ``backoff_max_s``) plus deterministic jitter from
    ``seed``."""
    ckpt_dir: str = "checkpoints"
    save_every: int = 100
    keep: int = 3
    max_failures: int = 3
    failure_window_s: float = 300.0
    backoff_base_s: float = 0.05
    backoff_max_s: float = 5.0
    seed: int = 0
    nan_is_failure: bool = True


class FailureBudget:
    """Sliding-window failure accounting with exponential backoff.

    ``record()`` stamps a failure and returns the backoff to sleep before
    retrying; ``exhausted`` is True once more than ``max_failures``
    failures landed within the trailing window. ``clock`` is injectable so
    tests can drive the window without real time passing; jitter comes
    from a generator seeded by ``seed`` — two runs of the same scenario
    back off identically (the chaos harness asserts on it)."""

    def __init__(self, max_failures: int, window_s: float, *,
                 base_s: float = 0.05, max_s: float = 5.0, seed: int = 0,
                 clock: Callable[[], float] = time.monotonic):
        self.max_failures = max_failures
        self.window_s = window_s
        self.base_s = base_s
        self.max_s = max_s
        self.clock = clock
        self.rng = np.random.default_rng(seed)
        self.stamps: collections.deque = collections.deque()

    def _prune(self, now: float) -> None:
        while self.stamps and now - self.stamps[0] > self.window_s:
            self.stamps.popleft()

    def record(self) -> float:
        """Stamp a failure; return the backoff sleep (seconds)."""
        now = self.clock()
        self._prune(now)
        self.stamps.append(now)
        n = len(self.stamps)
        backoff = min(self.base_s * 2 ** (n - 1), self.max_s)
        jitter = float(self.rng.uniform(0.0, 0.25)) * backoff
        return backoff + jitter

    @property
    def exhausted(self) -> bool:
        """More than ``max_failures`` failures inside the window?"""
        self._prune(self.clock())
        return len(self.stamps) > self.max_failures


class PreemptionFlag:
    """Set by SIGTERM/SIGINT; polled by the step loop."""

    def __init__(self):
        self.flag = False
        self._orig = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._orig[sig] = signal.signal(sig, self._handler)
            except ValueError:
                pass  # non-main thread (tests)

    def _handler(self, signum, frame):
        self.flag = True

    def restore_handlers(self):
        for sig, h in self._orig.items():
            signal.signal(sig, h)


def _restore_latest_valid(ft, template, shardings):
    """Walk committed checkpoints newest→oldest, returning the first that
    verifies AND loads into ``template`` (in place) — the fallback path for
    a newest checkpoint that is corrupt, partial, or shape-incompatible.
    ``restore`` verifies each candidate once: one that fails verification
    is skipped without a word, as ``checkpoint.manager.valid_steps``
    skips it in the JAX package's walk (which verifies it again in
    ``restore``); one that verifies but does not load is reported."""
    for s in ckpt.committed_steps(ft.ckpt_dir):
        try:
            state, meta = ckpt.restore(ft.ckpt_dir, s, template, shardings)
        except ckpt.CheckpointCorruptError:
            continue
        except (AssertionError, ValueError, OSError) as exc:
            _say(f"[ft] checkpoint step {s} unusable ({exc!r}); "
                 f"trying older")
            continue
        return state, meta, s
    return None


def run_with_recovery(
    *,
    state: Any,
    step_fn: Callable[[Any, int], tuple[Any, dict]],
    start_step: int,
    num_steps: int,
    ft: FTConfig,
    shardings: Optional[Any] = None,
    on_metrics: Optional[Callable[[int, dict], None]] = None,
    on_device_loss: Optional[
        Callable[[faults_lib.DeviceLostError], Optional[tuple[Any, Any]]]
    ] = None,
    sleep_fn: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
) -> tuple[Any, int]:
    """Run ``step_fn(state, step) -> (state, metrics)`` with checkpointing
    and restore-on-failure. Returns (final_state, last_step).
    ``shardings``: the state's ``checkpoint.manager.MeshPlacement`` on a
    mesh (None off one); a restore fills ``state`` in place.

    ``on_device_loss(err) -> (state_template, shardings)`` is the elastic
    hook: on an injected/real device dropout it must rebuild the mesh and
    step fn (mutating whatever closure ``step_fn`` reads) and return the
    new state template + shardings to restore the checkpoint under, or
    None on a rank the new mesh leaves out, whose loop then ends there
    (it returns the state it had); with no hook, device loss is fatal.
    Before the hook runs, every rank settles the in-flight write and
    waits at the old mesh's barrier. ``sleep_fn``/``clock`` are
    injectable for deterministic tests."""
    saver = ckpt.AsyncSaver()
    preempt = PreemptionFlag()
    budget = FailureBudget(
        ft.max_failures, ft.failure_window_s, base_s=ft.backoff_base_s,
        max_s=ft.backoff_max_s, seed=ft.seed, clock=clock)
    step = start_step

    def save(sync=False):
        # GC runs in the saver thread after the write commits: retention
        # sees the new checkpoint and never prunes under an in-flight one.
        with obs.tracer.span("ckpt.snapshot", step=step):
            saver.save(ft.ckpt_dir, step, state, meta={"step": step},
                       post=lambda _path: ckpt.gc_old(ft.ckpt_dir, ft.keep),
                       shardings=shardings)
        if sync:
            settle()

    def settle():
        # the writer joins its in-flight write; the other ranks wait for
        # it at the barrier (reached even where the write failed), so
        # none reads before the commit
        try:
            saver.wait()
        finally:
            if shardings is not None:
                shardings.barrier()

    def recover(err) -> None:
        nonlocal state, step
        backoff = budget.record()
        obs.registry.counter(
            "repro_ft_recoveries_total",
            "step failures recovered via checkpoint restore").inc()
        obs.registry.gauge(
            "repro_ft_backoff_seconds",
            "backoff slept before the most recent restore").set(backoff)
        if budget.exhausted:
            obs.events.emit("train.recover", reason="failure budget exhausted",
                            failures=len(budget.stamps))
            raise err
        try:
            settle()  # settle the in-flight write before reading
        except Exception as werr:  # noqa: BLE001 — a failed save is
            # logged, not fatal: the restore walk below only trusts
            # checkpoints that verify.
            _say(f"[ft] async save failed during recovery: {werr!r}")
        with obs.tracer.span("ckpt.restore"):
            got = _restore_latest_valid(ft, state, shardings)
        if got is None:
            raise RuntimeError("failure before first valid checkpoint") \
                from err
        state, meta, restored = got
        step = int(meta["step"])
        sleep_fn(backoff)
        obs.events.emit("train.recover", reason=repr(err),
                        restored_step=step, backoff_s=backoff,
                        failures_in_window=len(budget.stamps))
        _say(f"[ft] step failure ({err!r}); restored step {step} "
              f"(ckpt {restored}), {len(budget.stamps)} failures in "
              f"window, backoff {backoff:.3f}s")

    try:
        while step < num_steps:
            try:
                for f in faults_lib.inject("train.preempt", step=step):
                    if f.kind == "preempt":
                        preempt.flag = True
                new_state, metrics = step_fn(state, step)
                for f in faults_lib.inject("train.loss", step=step):
                    if f.kind == "nan" and "loss" in metrics:
                        metrics = dict(metrics, loss=float("nan"))
                if ft.nan_is_failure and "loss" in metrics:
                    if not np.isfinite(float(metrics["loss"])):
                        raise FloatingPointError(
                            f"non-finite loss at {step}")
                state = new_state
                step += 1
                if on_metrics:
                    on_metrics(step, metrics)
                if step % ft.save_every == 0:
                    save()
                if preempt.flag:
                    save(sync=True)
                    break
            except faults_lib.DeviceLostError as e:
                if on_device_loss is None:
                    raise
                # Elastic shrink: the hook re-meshes over the survivors
                # and hands back the template/shardings for the new
                # topology; the checkpoint's LOGICAL arrays then restore
                # onto the smaller mesh (DESIGN.md §9).
                try:
                    settle()
                except Exception as werr:  # noqa: BLE001 — as in recover
                    _say(f"[ft] async save failed before re-mesh: "
                          f"{werr!r}")
                with obs.tracer.span("train.remesh"):
                    got = on_device_loss(e)
                if got is None:
                    return state, step
                template, shardings = got
                state = template
                recover(e)
                _say(f"[ft] resumed on shrunken mesh at step {step}")
            except Exception as e:  # noqa: BLE001 — any step failure
                recover(e)
    finally:
        preempt.restore_handlers()
    settle()
    return state, step
