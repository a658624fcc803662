"""The port's fault-tolerance runtime (``repro_torch.runtime.ft``,
``straggler``, ``elastic``) against the JAX package's.

* ``tests/test_ft.py``'s cases and ``tests/test_substrate.py``'s ft,
  straggler and elastic cases, on torch state;
* ``FailureBudget`` backs off by the JAX package's seconds for the same
  seed and clock;
* ``tests/test_chaos.py``'s scenario (a) (a bit-flipped step-4 checkpoint,
  then a step error at 5) through both packages with one fault-plan spec:
  the same ``plan.fired``, the same "restored step 2" line, the same final
  state;
* ``choose_mesh_shape`` equals JAX's for 1-16 devices, and
  ``StragglerMonitor`` gives JAX's shares over one synthetic timeline.
"""
import os
import signal

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.checkpoint import manager as ckpt
from repro_torch.core.hetero import make_hetero_plan
from repro_torch.runtime import elastic
from repro_torch.runtime import faults as faults_lib
from repro_torch.runtime import ft as ft_lib
from repro_torch.runtime.straggler import StragglerConfig, StragglerMonitor


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_failure_budget_sliding_window():
    clk = _Clock()
    b = ft_lib.FailureBudget(2, window_s=100.0, clock=clk)
    b.record()
    clk.t = 10.0
    b.record()
    assert not b.exhausted
    clk.t = 20.0
    b.record()
    assert b.exhausted
    clk.t = 115.0
    assert not b.exhausted
    assert len(b.stamps) == 1


def test_failure_budget_lifetime_failures_do_not_accumulate():
    clk = _Clock()
    b = ft_lib.FailureBudget(2, window_s=10.0, clock=clk)
    for i in range(50):
        clk.t = i * 100.0
        b.record()
        assert not b.exhausted


def test_failure_budget_backoff_exponential_and_deterministic():
    clk = _Clock()
    b1 = ft_lib.FailureBudget(10, 1e9, base_s=0.1, max_s=1.0, seed=7,
                              clock=clk)
    b2 = ft_lib.FailureBudget(10, 1e9, base_s=0.1, max_s=1.0, seed=7,
                              clock=clk)
    seq1 = [b1.record() for _ in range(6)]
    assert seq1 == [b2.record() for _ in range(6)]
    for n, got in enumerate(seq1, start=1):
        base = min(0.1 * 2 ** (n - 1), 1.0)
        assert base <= got < base * 1.25
    assert seq1[-1] < 1.0 * 1.25


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_failure_budget_backoffs_equal_the_jax_package(seed):
    from repro.runtime import ft as jft

    got = []
    for mod in (ft_lib, jft):
        clk = _Clock()
        b = mod.FailureBudget(3, 50.0, base_s=0.05, max_s=5.0, seed=seed,
                              clock=clk)
        seq = []
        for t in (0.0, 1.0, 2.5, 30.0, 70.0, 71.0, 200.0):
            clk.t = t
            seq.append((b.record(), b.exhausted))
        got.append(seq)
    assert got[0] == got[1]


def _step_fn(state, step):
    """x' = x + step + 1: a replay from a checkpoint is the same
    trajectory."""
    return ({"x": state["x"] + float(step + 1)}, {"loss": float(step)})


def _x0():
    return {"x": torch.zeros((), dtype=torch.float32)}


def _run(tmp_path, *, step_fn=_step_fn, steps=6, save_every=2, keep=3,
         state=None, start=0, **kw):
    ft = ft_lib.FTConfig(ckpt_dir=str(tmp_path), save_every=save_every,
                         keep=keep, max_failures=3, backoff_base_s=0.0)
    return ft_lib.run_with_recovery(
        state=state if state is not None else _x0(), step_fn=step_fn,
        start_step=start, num_steps=steps, ft=ft, sleep_fn=lambda s: None,
        **kw)


def test_run_to_completion_and_gc_after_write(tmp_path):
    state, last = _run(tmp_path, steps=10, save_every=1, keep=2)
    assert last == 10
    assert float(state["x"]) == sum(range(1, 11))
    left = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert left == ["step_00000009", "step_00000010"]


def test_signal_handlers_restored_on_every_exit_path(tmp_path):
    orig_term = signal.getsignal(signal.SIGTERM)
    orig_int = signal.getsignal(signal.SIGINT)
    _run(tmp_path)
    assert signal.getsignal(signal.SIGTERM) is orig_term

    def bad(state, step):
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError):
        _run(tmp_path / "b", step_fn=bad)
    assert signal.getsignal(signal.SIGTERM) is orig_term
    assert signal.getsignal(signal.SIGINT) is orig_int


def test_restore_on_failure_resumes_bit_exact(tmp_path):
    ref_state, _ = _run(tmp_path / "ref", steps=8, save_every=2)
    fails = {"n": 0}

    def flaky(state, step):
        if step == 5 and fails["n"] < 2:
            fails["n"] += 1
            raise RuntimeError("injected device error")
        return _step_fn(state, step)

    state, last = _run(tmp_path / "chaos", step_fn=flaky, steps=8,
                       save_every=2)
    assert last == 8 and fails["n"] == 2
    assert torch.equal(state["x"], ref_state["x"])


def test_fallback_restore_skips_corrupt_newest(tmp_path):
    ref_state, _ = _run(tmp_path / "ref", steps=8, save_every=2)
    d = tmp_path / "chaos"
    corrupted = {"done": False}

    def flaky(state, step):
        if step == 5 and not corrupted["done"]:
            corrupted["done"] = True
            p = d / "step_00000004" / "a_00000.npy"
            p.write_bytes(p.read_bytes()[: 8])
            raise RuntimeError("injected device error")
        return _step_fn(state, step)

    state, last = _run(d, step_fn=flaky, steps=8, save_every=2)
    assert last == 8
    assert torch.equal(state["x"], ref_state["x"])
    assert ckpt.latest_valid_step(str(d)) is not None


def test_budget_exhaustion_reraises(tmp_path):
    def always_bad(state, step):
        raise RuntimeError("permafail")

    with pytest.raises(RuntimeError, match="first valid checkpoint"):
        _run(tmp_path, step_fn=always_bad)


def test_nan_loss_fault_site_triggers_restore(tmp_path):
    plan = faults_lib.FaultPlan([
        faults_lib.Fault(site="train.loss", kind="nan", at=5)])
    with faults_lib.scope(plan):
        state, last = _run(tmp_path, steps=8, save_every=2)
    assert last == 8
    assert plan.fired == [("train.loss", 5, "nan")]
    ref_state, _ = _run(tmp_path / "ref", steps=8, save_every=2)
    assert torch.equal(state["x"], ref_state["x"])


def test_preempt_fault_site_saves_and_exits(tmp_path):
    plan = faults_lib.FaultPlan([
        faults_lib.Fault(site="train.preempt", kind="preempt", at=3)])
    with faults_lib.scope(plan):
        state, last = _run(tmp_path, steps=100, save_every=50)
    assert last == 4
    s = ckpt.latest_valid_step(str(tmp_path))
    restored, meta = ckpt.restore(str(tmp_path), s, _x0())
    assert int(meta["step"]) == 4
    assert torch.equal(restored["x"], state["x"])


def test_device_loss_routes_to_elastic_handler(tmp_path):
    plan = faults_lib.FaultPlan([
        faults_lib.Fault(site="train.step", kind="device_drop", at=5,
                         payload={"survivors": 2})])
    calls = []

    def flaky(state, step):
        faults_lib.inject("train.step")
        return _step_fn(state, step)

    def on_loss(err):
        calls.append(err.survivors)
        return _x0(), None

    with faults_lib.scope(plan):
        state, last = _run(tmp_path, step_fn=flaky, steps=8, save_every=2,
                           on_device_loss=on_loss)
    assert calls == [2] and last == 8
    ref_state, _ = _run(tmp_path / "ref", steps=8, save_every=2)
    assert torch.equal(state["x"], ref_state["x"])


def test_device_loss_leaver_ends_its_loop(tmp_path):
    """A rank the new mesh leaves out (the hook returns None) ends its
    loop at the step it had reached."""
    plan = faults_lib.FaultPlan([
        faults_lib.Fault(site="train.step", kind="device_drop", at=3,
                         payload={"survivors": 1})])

    def flaky(state, step):
        faults_lib.inject("train.step")
        return _step_fn(state, step)

    with faults_lib.scope(plan):
        state, last = _run(tmp_path, step_fn=flaky, steps=8, save_every=2,
                           on_device_loss=lambda err: None)
    assert last == 3 and float(state["x"]) == 1 + 2 + 3


def test_device_loss_without_handler_is_fatal(tmp_path):
    plan = faults_lib.FaultPlan([
        faults_lib.Fault(site="train.step", kind="device_drop", at=1)])

    def flaky(state, step):
        faults_lib.inject("train.step")
        return _step_fn(state, step)

    with faults_lib.scope(plan), \
            pytest.raises(faults_lib.DeviceLostError):
        _run(tmp_path, step_fn=flaky)


def test_run_with_recovery_restores_after_failure(tmp_path):
    calls = {"n": 0}

    def step_fn(state, step):
        calls["n"] += 1
        if step == 7 and calls["n"] < 12:
            raise RuntimeError("injected device failure")
        return {"w": state["w"] + 1}, {"loss": 1.0}

    state, last = ft_lib.run_with_recovery(
        state={"w": torch.zeros(())}, step_fn=step_fn, start_step=0,
        num_steps=10, ft=ft_lib.FTConfig(ckpt_dir=str(tmp_path),
                                         save_every=2, max_failures=2))
    assert last == 10 and float(state["w"]) == 10.0


def test_run_with_recovery_nan_watchdog(tmp_path):
    seen = {"nans": 0}

    def step_fn(state, step):
        loss = 1.0
        if step == 5 and seen["nans"] == 0:
            seen["nans"] += 1
            loss = float("nan")
        return {"w": state["w"] + 1}, {"loss": loss}

    state, last = ft_lib.run_with_recovery(
        state={"w": torch.zeros(())}, step_fn=step_fn, start_step=0,
        num_steps=8, ft=ft_lib.FTConfig(ckpt_dir=str(tmp_path),
                                        save_every=2, max_failures=3))
    assert last == 8 and seen["nans"] == 1


def test_checkpoint_async_and_gc(tmp_path):
    saver = ckpt.AsyncSaver()
    for step in (1, 2, 3, 4):
        saver.save(str(tmp_path), step, {"x": torch.full((4,), step)})
    saver.wait()
    ckpt.gc_old(str(tmp_path), keep=2)
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path))
    assert steps == [3, 4]
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


# ---------------------------------------------------------------------------
# chaos scenario (a) through both packages
# ---------------------------------------------------------------------------

SCENARIO_A = {"seed": 0, "faults": [
    {"site": "ckpt.write", "kind": "bitflip", "at": 1,
     "payload": {"leaf": 0}},
    {"site": "train.step", "kind": "error", "at": 5}]}


def _scenario_a(ft_mod, faults_mod, ckpt_mod, x0, add, directory):
    def step(state, s):
        faults_mod.inject("train.step")
        return {"x": add(state["x"], s + 1)}, {"loss": float(s)}

    ft = ft_mod.FTConfig(ckpt_dir=directory, save_every=2, keep=3,
                         max_failures=3, backoff_base_s=0.0)
    plan = faults_mod.FaultPlan.from_spec(SCENARIO_A)
    with faults_mod.scope(plan):
        state, last = ft_mod.run_with_recovery(
            state={"x": x0}, step_fn=step, start_step=0, num_steps=8, ft=ft,
            sleep_fn=lambda s: None)
    return (np.asarray(state["x"]).tobytes(), last, plan.fired,
            ckpt_mod.latest_valid_step(directory))


def test_chaos_scenario_a_equals_the_jax_package(tmp_path, capsys):
    import jax.numpy as jnp

    from repro.checkpoint import manager as jckpt
    from repro.runtime import faults as jfaults
    from repro.runtime import ft as jft

    port = _scenario_a(ft_lib, faults_lib, ckpt, torch.zeros(()),
                       lambda x, v: x + float(v), str(tmp_path / "torch"))
    port_out = capsys.readouterr().out
    ref = _scenario_a(jft, jfaults, jckpt, jnp.float32(0.0),
                      lambda x, v: x + jnp.float32(v), str(tmp_path / "jax"))
    jax_out = capsys.readouterr().out
    assert port == ref
    assert set(port[2]) == {("ckpt.write", 1, "bitflip"),
                            ("train.step", 5, "error")}
    assert port[1] == 8 and port[3] == 8
    line = [x for x in port_out.splitlines() if "restored step" in x]
    jline = [x for x in jax_out.splitlines() if "restored step" in x]
    assert line == jline and "restored step 2 (ckpt 2)" in line[0]


# ---------------------------------------------------------------------------
# straggler and elastic
# ---------------------------------------------------------------------------

def test_straggler_monitor_replans():
    mon = StragglerMonitor(4, 64, StragglerConfig(
        window=4, trigger_ratio=1.2, min_steps_between_replans=0))
    new = None
    for _ in range(8):
        new = mon.report([1.0, 1.0, 1.0, 2.5]) or new
    assert new is not None and new[3] < new[0] and sum(new) == 64


def test_straggler_quiet_on_homogeneous():
    mon = StragglerMonitor(4, 64, StragglerConfig(
        window=4, min_steps_between_replans=0))
    for _ in range(8):
        assert mon.report([1.0, 1.01, 0.99, 1.0]) is None


def test_straggler_shares_equal_the_jax_package():
    """One synthetic timeline (a drifting straggler and noise from a numpy
    seed), fed to both monitors seeded with the same capped plan."""
    from repro.core.hetero import make_hetero_plan as jplan
    from repro.runtime import straggler as jstraggler

    rng = np.random.default_rng(3)
    times = 1.0 + 0.05 * rng.normal(size=(60, 4))
    times[:, 3] *= np.linspace(1.0, 3.0, 60)
    times[30:, 0] *= 1.6
    outs = []
    for mod, mk in ((None, make_hetero_plan), (jstraggler, jplan)):
        plan = mk((1.0, 1.0, 1.5, 2.0), global_batch=64,
                  capacity_headroom=1.5)
        cls_mon = StragglerMonitor if mod is None else mod.StragglerMonitor
        cls_cfg = StragglerConfig if mod is None else mod.StragglerConfig
        mon = cls_mon(4, 64, cls_cfg(window=8, min_steps_between_replans=8),
                      plan=plan)
        seq = [mon.report(list(row)) for row in times]
        outs.append((seq, mon.replans,
                     tuple(mon.current_plan().token_counts)))
    assert outs[0] == outs[1]
    assert outs[0][1] >= 2


@pytest.mark.parametrize("n", range(1, 17))
def test_choose_mesh_shape_equals_the_jax_package(n):
    from repro.runtime import elastic as jelastic

    for kw in ({}, {"min_model": 2}, {"param_bytes": 40e9},
               {"max_model": 3}):
        assert elastic.choose_mesh_shape(n, **kw) == \
            jelastic.choose_mesh_shape(n, **kw)


@settings(max_examples=40, deadline=None)
@given(n=st.integers(1, 4096))
def test_choose_mesh_shape_covers_devices(n):
    data, model = elastic.choose_mesh_shape(n)
    assert n // 2 <= data * model <= n


def test_choose_mesh_min_model_for_memory():
    data, model = elastic.choose_mesh_shape(256, param_bytes=100e9,
                                            hbm_bytes=16 * 2**30)
    assert data * model == 256 and model >= 16
    assert elastic.choose_mesh_shape(256, param_bytes=1e9)[1] == 1


def test_survivor_ranks():
    assert elastic.survivor_ranks(2) == [0, 1]
    assert elastic.survivor_ranks([3, 1]) == [3, 1]
