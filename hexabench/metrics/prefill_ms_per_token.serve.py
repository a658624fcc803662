"""Device time of the operations launched by the traced prefill chunks
(the benchmark's ``hexabench.prefill`` range around the engine's prefill
step) over their valid prompt tokens, ms a token."""
from hexabench import devtrace


def read(rec):
    n = rec.get("prefill_tokens")
    t = devtrace.launched_in_ns(rec, "hexabench.prefill")
    if not n or not t:
        return None
    return t / 1e6 / n
