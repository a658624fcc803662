"""The least time the traced expert FFN launches need (each launch's routed
rows and the experts they touch, ``flops.expert_glu_launch_work``: 8-bit
weights read once a launch) over the device time of the port's expert
kernels, %."""
import re

from hexabench import devtrace, flops

_KERNELS = re.compile(devtrace.EXPERT_KERNELS)


def read(rec):
    work = rec.get("expert_work")
    t = devtrace.named_ns(rec, _KERNELS)
    if not work or not t:
        return None
    dtype = rec["config"]["dtype"]
    need = sum(flops.bound_s(f, b, dtype) for f, b in work)
    return 100.0 * need * 1e9 / t
