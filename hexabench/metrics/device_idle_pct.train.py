"""The share of a step in which no device operation runs, %: one minus
the device busy time of a traced step (the union of the operations'
intervals in the profiler's trace, over the traced steps) over the step
time of the window, which runs unprofiled before them. The profiler's
own host cost would otherwise count as idle: at Swin-MoE-Small's
~12,600 launches a step it stretches a traced step by ~16 % on the
H100."""
from hexabench import devtrace


def read(rec):
    n, step_s = rec.get("steps_traced"), rec.get("step_s")
    busy = devtrace.busy_ns(rec)
    if not n or not step_s or not busy:
        return None
    return 100.0 * (1.0 - busy / 1e9 / n / step_s)
