"""The share of the serving time in which no device operation runs, %:
one minus the device busy time of the traced scheduler steps (the union
of the operations' intervals in the profiler's trace) over the time the
same steps take unprofiled. The profiler's own host cost would otherwise
count as idle. Scheduler steps differ (a prefill chunk of up to 256
tokens or none, a decode of up to every slot), so the unprofiled time of
each traced step is read off a least-squares line through the window's
unprofiled steps, in their prefill tokens and decode rows."""
import numpy as np

from hexabench import devtrace


def read(rec):
    window, traced = rec.get("sched_window"), rec.get("sched_traced")
    busy = devtrace.busy_ns(rec)
    if not window or not traced or not busy:
        return None
    x = np.array([[1.0, p, d] for _, p, d in window])
    y = np.array([t for t, _, _ in window])
    coef = np.linalg.lstsq(x, y, rcond=None)[0]
    unprofiled = float((np.array([[1.0, p, d] for p, d in traced])
                        @ coef).sum())
    return 100.0 * (1.0 - busy / 1e9 / unprofiled)
