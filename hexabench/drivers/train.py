"""The train driver: one object (the port's train step with its model and
optimizer state) is built from the seed, driven through its first steps in
set-up, and handed whole to the window.

What belongs to one model (its weights, step, batches, operation counts
and reference) is in ``models/<model>.py``, found by the configuration's
``model`` field.

Set-up: the weights (``inputs``), the optimizer state and the step; the
mix's ``checked_steps`` steps, each on a fresh seeded batch through the
window's own call, which the reference later follows; then
``warmup_steps`` more. From the checked steps the driver keeps each loss,
each leaf's first gradient as the optimizer got it (its first moment
after one step over ``1 - b1``) and each leaf's change over all of them
(the weights drawn again from the seed and subtracted before the next
step writes over them).

Window: steps on fresh batches until ``--seconds`` have passed on the
host, then one synchronize; ``train_step_ms`` is the window over the steps
it completed. With ``--trace 1``, ``trace_steps`` more steps run under
the profiler after the window (the profiler is never on before or in it).

After the window the program's state is freed and the reference trains
the same weights on the same batches (``reference/``); ``correct`` holds
the gaps between the two to the cell's limits (``compare``).
"""
from __future__ import annotations

import gc
import math
import statistics
import time

import torch

from hexabench import bench, devtrace, inputs


def _norms(tree) -> torch.Tensor:
    """Each leaf's norm, in ``inputs.leaves`` order, f64 on the device."""
    return torch.stack([torch.linalg.vector_norm(t.double())
                        for _, t in inputs.leaves(tree)])


def model_of(cell):
    """``models/<model>.py`` of the cell's configuration."""
    name = cell.config["model"]
    mod = bench.model(name)
    if mod is None:
        raise SystemExit(f"train driver: no hexabench/models/{name}.py")
    return mod


def build(cell):
    """(state, step, next_batch) of the port for the cell."""
    from repro_torch.optim import adamw

    cfg, mix, dev = cell.config, cell.traffic, cell.device
    mod = model_of(cell)
    opt_cfg = adamw.OptimizerConfig(**cfg["train"]["optimizer"])
    params = mod.params(cfg, cell.seed, dev)
    state = {"params": params,
             "opt": adamw.init_opt_state(params, opt_cfg)}
    train_step = mod.make_step(cfg, opt_cfg)
    gen = inputs.generator(dev, cell.seed, "batches")

    def next_batch():
        return mod.batch(cfg, mix, gen, dev)

    def step(batch):
        state["params"], state["opt"], m = train_step(
            state["params"], state["opt"], *batch)
        return m["loss"]

    return state, step, next_batch


def checked_batches(cell) -> list:
    """The batches of the checked steps, drawn again from the seed."""
    mod = model_of(cell)
    gen = inputs.generator(cell.device, cell.seed, "batches")
    return [mod.batch(cell.config, cell.traffic, gen, cell.device)
            for _ in range(cell.traffic["checked_steps"])]


def compare(prog: dict, ref: dict) -> dict:
    """The gaps the cell's limits hold:

    * ``loss``: the largest relative gap of a checked step's loss;
    * ``grad``: the largest gap, over the leaves, between the program's
      and the reference's first-gradient norms, over the larger of the
      reference leaf's norm and the median leaf's;
    * ``change``: the same for the norm of each leaf's change over the
      checked steps, leaving out leaves whose reference gradient is under
      a thousandth of the median leaf's (they move by round-off alone).
    """
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    med_g = statistics.median(ref["grad"])
    grad = max(abs(p - r) / max(r, med_g)
               for p, r in zip(prog["grad"], ref["grad"]))
    keep = [i for i, g in enumerate(ref["grad"]) if g >= 1e-3 * med_g]
    med_c = statistics.median(ref["change"][i] for i in keep)
    change = max(abs(prog["change"][i] - ref["change"][i])
                 / max(ref["change"][i], med_c) for i in keep)
    return {"loss_gap": float(loss), "grad_gap": float(grad),
            "change_gap": float(change)}


def run(cell) -> dict:
    dev, mix = cell.device, cell.traffic
    b1 = cell.config["train"]["optimizer"]["b1"]
    state, step, next_batch = build(cell)

    losses = []
    for i in range(mix["checked_steps"]):
        losses.append(step(next_batch()))
        if i == 0:
            grad = _norms(state["opt"]["m"]) / (1 - b1)
    with torch.no_grad():
        start = model_of(cell).params(cell.config, cell.seed, dev)
        change = torch.stack([
            torch.linalg.vector_norm((p - s).double())
            for (_, p), (_, s) in zip(inputs.leaves(state["params"]),
                                      inputs.leaves(start))])
        del start
    for _ in range(mix["warmup_steps"]):
        step(next_batch())
    bench.sync(dev)
    prog = {"loss": [float(x) for x in losses], "grad": grad.tolist(),
            "change": change.tolist()}
    setup_s = time.perf_counter() - cell.t_start

    window_losses, rec = [], None
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < cell.seconds:
        window_losses.append(step(next_batch()))
    bench.sync(dev)
    t1 = time.perf_counter()
    n = len(window_losses)
    if cell.trace:
        with devtrace.Capture() as cap:
            for _ in range(mix["trace_steps"]):
                with torch.profiler.record_function("hexabench.step"):
                    window_losses.append(step(next_batch()))
        rec = {**cap.records, "config": cell.config, "traffic": mix,
               "steps_traced": mix["trace_steps"], "step_s": (t1 - t0) / n}
        rec.update(devtrace.summary(rec))
    attempted = len(window_losses)
    failed = sum(not math.isfinite(float(x)) for x in window_losses)
    peak = bench.peak_bytes(dev)

    state.clear()
    del step, next_batch, window_losses
    gc.collect()
    if dev.startswith("cuda"):
        torch.cuda.empty_cache()
    ref = model_of(cell).reference_train(cell.config, cell.seed,
                                         checked_batches(cell), dev)
    numbers = compare(prog, ref)
    ok, checks = bench.judge(numbers, cell.limits)
    return {"correct": ok and failed == 0, "attempted": attempted,
            "failed": failed,
            "e2e": {"train_step_ms": (t1 - t0) / n * 1e3,
                    "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s},
            "rec": rec, "peak": peak, "checks": checks, "prog": prog,
            "ref": ref}


def control_numbers(cell, out: dict, precision: str) -> dict:
    """The compared numbers of the control: the reference at ``precision``
    (the nearest below the configuration's) in the program's place, on the
    checked batches, against ``out``'s reference."""
    ctrl = model_of(cell).reference_train(
        cell.config, cell.seed, checked_batches(cell), cell.device,
        precision=precision)
    return compare(ctrl, out["ref"])


def half_batch_numbers(cell, out: dict) -> dict:
    """The compared numbers of the fault "half of the batch left out, the
    mean taken over the rest": the reference on the first half of each
    checked batch in the program's place."""
    half = [tuple(t[: len(t) // 2] for t in b) for b in checked_batches(cell)]
    fault = model_of(cell).reference_train(cell.config, cell.seed, half,
                                           cell.device)
    return compare(fault, out["ref"])
