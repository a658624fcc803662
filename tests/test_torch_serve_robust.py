"""PyTorch port vs the JAX package: the paged engine under faults
(``runtime/faults.py``, retries, the NaN watchdog, engine recovery,
priority preemption, deadlines, device-dropout shrink).

``tests/test_chaos.py``'s serving scenarios on qwen3-moe-30b-a3b's f32
smoke config, and again on gemma-2b's, the dense-FFN stack the JAX suite
runs them on, each run on the JAX engine (Pallas in interpret mode,
blk 8) and the port's under the same ``FaultPlan``, through the
harness of ``test_torch_serve_prefix.py``: the streams, the failed
requests and their errors, the aborts, preemptions, transfers, engine
recoveries, prefix-index counters, the faults that fired and the whole
scheduler ``trace`` must be equal, and every stream that finishes must be
the batch-1 reference's (greedy f32, compared exactly). The page books
are audited after every scheduler step and drained at the end.

``FaultPlan`` itself is held to JAX's: the same firings (``at``,
``every``, seeded ``prob``, ``times``) on the same calls, the same raises
and pass-throughs, ``load_plan`` from inline JSON and a file, ``scope``.
"""
import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import pytest

from repro.core import hetero as jhetero
from repro.runtime import faults as jfaults
from repro_torch.launch import serve as tserve
from repro_torch.launch import spec as tspec
from repro_torch.runtime import faults as tfaults
from repro.launch import spec as jspec

from test_torch_serve_prefix import (ARCH, MAX_SEQ, PAGE, _both, _drained,
                                     _models, _references)


def _requests(specs, seed=5):
    """Requests from (prompt length, max_new) pairs, as
    ``tests/test_chaos.py`` draws them."""
    _, cfg, _, _ = _models()
    rng = np.random.default_rng(seed)
    return [dict(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=plen)
                 .astype(np.int32), max_new=max_new)
            for i, (plen, max_new) in enumerate(specs)]


def _fault(site, kind, **kw):
    return dict(site=site, kind=kind, **kw)


class _TickClock:
    """A deterministic clock: one unit a reading."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


# ---------------------------------------------------------------------------
# the fault plan
# ---------------------------------------------------------------------------

SPEC = {"seed": 3, "faults": [
    _fault("serve.decode", "nan", at=2),
    _fault("serve.decode", "nan", every=3, times=2, payload={"slot": 1}),
    _fault("serve.logits", "nan", prob=0.4, times=5),
    _fault("serve.prefill", "delay", at=1, payload={"delay_s": 0.0}),
    _fault("serve.prefill", "error", at=3, payload={"slot": 0}),
    _fault("serve.decode", "device_drop", at=7,
           payload={"survivors": [0]})]}


def _drive(fl, plan, sites):
    out = []
    with fl.scope(plan):
        for site in sites:
            try:
                out.append([(f.kind, f.payload) for f in fl.inject(site)])
            except fl.DeviceLostError as e:
                out.append(("lost", e.survivors, str(e)))
            except fl.FaultError as e:
                out.append(("error", e.fault.payload, str(e)))
    return out


def test_fault_plan_fires_as_jax_does(tmp_path):
    sites = ["serve.decode", "serve.logits", "serve.prefill"] * 9
    want = _drive(jfaults, jfaults.FaultPlan.from_spec(SPEC), sites)
    got = _drive(tfaults, tfaults.FaultPlan.from_spec(SPEC), sites)
    assert got == want
    assert any(g == ("lost", [0], "injected device loss at serve.decode "
                     "(call 7)") for g in got)
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(SPEC))
    for text in (json.dumps(SPEC), str(path)):
        jp, tp = jfaults.load_plan(text), tfaults.load_plan(text)
        assert _drive(tfaults, tp, sites) == _drive(jfaults, jp, sites)
        assert tp.fired == jp.fired and tp.calls == jp.calls
    assert tfaults.active() is None and tfaults.inject("serve.decode") == []
    outer = tfaults.FaultPlan()
    with tfaults.scope(outer):
        with tfaults.scope(tfaults.FaultPlan()):
            pass
        assert tfaults.active() is outer
    assert tfaults.active() is None


# ---------------------------------------------------------------------------
# serving recovery
# ---------------------------------------------------------------------------

def _mid_decode_and_prefill_faults(arch):
    """A request-level fault mid-decode and another mid-prefill: only those
    slots abort; the retries re-admit through the prefix cache and every
    stream is the reference's."""
    reqs = _requests([(6, 5), (9, 4), (7, 4), (11, 3), (6, 4)])
    faults = [_fault("serve.decode", "error", at=2, payload={"slot": 0}),
              _fault("serve.prefill", "error", at=4, payload={"slot": 1})]
    _, srv, out = _both(reqs, arch=arch, faults=faults, prefix_cache=True,
                        audit=True)
    assert len(srv.fault_plan.fired) == 2
    assert srv.failed == [] and srv.aborts == 2
    assert out == _references(reqs, arch=arch)
    assert srv.index.hit_tokens >= srv.page_size
    _drained(srv)


def _engine_level_fault(arch):
    reqs = _requests([(6, 4), (9, 3), (7, 5), (5, 4)])
    _, srv, out = _both(reqs, arch=arch,
                        faults=[_fault("serve.decode", "error", at=1)],
                        audit=True)
    assert srv.fault_plan.fired == [("serve.decode", 1, "error")]
    assert srv.engine_recoveries == 1 and ("recover",) in srv.trace
    assert srv.aborts == 0 and srv.failed == []
    assert out == _references(reqs, arch=arch)
    _drained(srv)


def _nan_watchdog(site, arch):
    """Non-finite logits fail THAT request, never the engine: on a decode
    row (no retries left: it fails, its batchmates' streams are the
    reference's), on the first-token logits of a prefill and on a
    speculative verify round (retried: every stream the reference's)."""
    reqs = _requests([(6, 4), (9, 4), (7, 5), (5, 3)])
    kw, drafter = {}, None
    if site == "decode":
        faults = [_fault("serve.logits", "nan", at=1, payload={"slot": 0})]
        kw["max_retries"] = 0
    elif site == "prefill":
        faults = [_fault("serve.prefill_logits", "nan", at=1)]
    else:
        faults = [_fault("serve.logits", "nan", at=2, payload={"slot": 0})]
        mk = {"jax": jspec.NGramDrafter, "torch": tspec.NGramDrafter}
        drafter = lambda pkg: mk[pkg]()                 # noqa: E731
    _, srv, out = _both(reqs, arch=arch, faults=faults, drafter=drafter,
                        audit=True, **kw)
    assert srv.engine_recoveries == 0
    refs = _references(reqs, arch=arch)
    reason = {"decode": "non-finite decode logits",
              "prefill": "non-finite prefill logits",
              "verify": "non-finite verify logits"}[site]
    aborts = [e for e in srv.trace if e[0] == "abort"]
    assert len(aborts) == 1 and aborts[0][3] == reason
    if site == "decode":
        assert [r.rid for r in srv.failed] == [0]
        assert reason in srv.failed[0].error and srv.failed[0].out == []
        assert out == {k: v for k, v in refs.items() if k != 0}
    else:
        assert srv.failed == [] and srv.aborts == 1 and out == refs
    _drained(srv)


def _priority_preemption(arch):
    """Two low-priority requests reserve the whole pool; a higher-priority
    head preempts the youngest, which re-admits right behind it through
    the prefix cache and replays token-identically, no retry charged."""
    low1, low2 = _requests([(8, 8), (8, 8)], seed=3)
    (high,) = _requests([(4, 2)], seed=9)
    reqs = [low1, low2, dict(high, rid=2, priority=5)]
    _, srv, out = _both(reqs, arch=arch, num_slots=3, num_pages=1 + 8,
                        max_pages_per_slot=4, prefix_cache=True, audit=True)
    assert srv.preemptions == 1
    assert [e for e in srv.trace if e[0] == "preempt"] == [("preempt", 0, 0)]
    assert srv.failed == [] and srv.aborts == 0
    assert out == _references(reqs, arch=arch)
    assert srv.index.hit_tokens >= srv.page_size
    _drained(srv)


def _deadlines(arch):
    """On a tick clock: a queued request's deadline passes while the one
    slot is busy ("deadline exceeded in queue"), and an admitted one's
    mid-decode ("deadline exceeded", its pages released)."""
    r0, r1 = _requests([(6, 3), (6, 3)])
    _, srv, out = _both([r0, dict(r1, deadline_s=2.0)], arch=arch,
                        num_slots=1, num_pages=1 + 8, clock=_TickClock,
                        audit=True)
    assert list(out) == [0] and out[0] == _references([r0], arch=arch)[0]
    assert [r.error for r in srv.failed] == ["deadline exceeded in queue"]
    _drained(srv)
    (r2,) = _requests([(6, 20)], seed=7)
    _, srv, out = _both([dict(r2, deadline_s=10.0)], arch=arch,
                        num_slots=1, num_pages=1 + 8, clock=_TickClock,
                        audit=True)
    assert out == {}
    assert [r.error for r in srv.failed] == ["deadline exceeded"]
    assert any(e[0] == "abort" and e[3] == "deadline" for e in srv.trace)
    _drained(srv)


def _device_dropout(arch):
    """A device dropout mid-run: live slots go back to the queue in
    admission order (no retry charged), the prefix index drains, the pool
    reshares over the surviving class and every request finishes as the
    reference's."""
    counts = jhetero.make_hetero_plan((1.0, 2.0), global_batch=4).token_counts
    reqs = _requests([(6, 4), (9, 3), (7, 4), (5, 5), (6, 3), (10, 4)])
    faults = [_fault("serve.decode", "device_drop", at=3,
                     payload={"survivors": [0]})]
    _, srv, out = _both(reqs, arch=arch, faults=faults, num_slots=4,
                        num_pages=1 + 4 * (MAX_SEQ // PAGE),
                        plan=SimpleNamespace(token_counts=counts),
                        prefix_cache=True, audit=True)
    assert srv.fault_plan.fired == [("serve.decode", 3, "device_drop")]
    assert ("shrink", (0,)) in srv.trace
    assert len(srv.pool.shares) == 1 and set(srv.groups) == {0}
    assert srv.failed == [] and out == _references(reqs, arch=arch)
    _drained(srv)


SCENARIOS = {
    "mid_decode_and_prefill_faults": _mid_decode_and_prefill_faults,
    "engine_level_fault": _engine_level_fault,
    "nan_watchdog_decode": lambda arch: _nan_watchdog("decode", arch),
    "priority_preemption": _priority_preemption,
    "deadlines": _deadlines,
    "device_dropout": _device_dropout,
}


def test_mid_decode_and_prefill_faults_retry_as_jax():
    _mid_decode_and_prefill_faults(ARCH)


def test_engine_level_fault_rebuilds_the_steps_as_jax():
    _engine_level_fault(ARCH)


@pytest.mark.parametrize("site", ["decode", "prefill", "verify"])
def test_nan_watchdog_aborts_and_retries_as_jax(site):
    _nan_watchdog(site, ARCH)


def test_priority_preemption_replays_as_jax():
    _priority_preemption(ARCH)


def test_deadlines_expire_as_jax():
    _deadlines(ARCH)


def test_device_dropout_shrinks_the_pool_as_jax():
    _device_dropout(ARCH)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_chaos_scenarios_on_a_dense_stack_as_jax(scenario):
    """``tests/test_chaos.py``'s serving scenarios on gemma-2b, the stack
    the JAX suite runs them on (dense GLU FFN layers, one kv head)."""
    SCENARIOS[scenario]("gemma-2b")


def test_cli_fault_spec_and_audit(capsys):
    spec = json.dumps({"faults": [_fault("serve.decode", "error", at=1)]})
    done = tserve.main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--device",
                        "cpu", "--paged", "--fault-spec", spec, "--audit",
                        "--slots", "2", "--requests", "3", "--max-new", "3",
                        "--max-seq", "32"])
    out = capsys.readouterr().out
    assert len(done) == 3 and all(len(r.out) == 3 for r in done)
    assert "[serve] recovery: 0 aborts, 0 preemptions, 1 engine " \
           "recoveries, 0 failed" in out
    assert "leak-free=True" in out
    assert tfaults.active() is None
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--device",
                     "cpu", "--fault-spec", spec])
    assert "--fault-spec/--audit require --paged" in capsys.readouterr().err
