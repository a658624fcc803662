"""The least time the expert FFNs need for the traced steps' routed rows,
forward and backward (``models/<model>.py``'s ``expert_bound_s``:
operations at the configuration's peak, bytes at the memory rate), over
the device time of the port's expert kernels, %."""
import re

from hexabench import bench, devtrace

_KERNELS = re.compile(devtrace.EXPERT_KERNELS)


def read(rec):
    cfg = rec["config"]
    mod = bench.model(cfg.get("model", ""))
    t = devtrace.named_ns(rec, _KERNELS)
    if mod is None or not t:
        return None
    need = rec["steps_traced"] * mod.expert_bound_s(cfg, rec["traffic"])
    return 100.0 * need * 1e9 / t
