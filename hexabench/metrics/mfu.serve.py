"""The model's operations for the prompt and generated tokens the window
processed (``flops.lm_token_flops`` at each token's position, the head
once a prompt and once a decoded token) over the window, against the
configuration's peak, %."""
from hexabench import flops


def read(rec):
    ops, secs = rec.get("window_operations"), rec.get("window_host_s")
    if not ops or not secs:
        return None
    peak = flops.peaks()["flops_per_s"][rec["config"]["dtype"]]
    return 100.0 * ops / secs / peak
