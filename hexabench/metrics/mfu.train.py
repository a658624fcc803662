"""The model's operations for a train step (forward and backward from
shapes, no recompute: ``models/<model>.py``'s ``train_flops``) over the
step time, against the configuration's peak, %. The step time is the
traced run's own window's, unprofiled (the profiled steps follow the
window)."""
from hexabench import bench, flops


def read(rec):
    cfg = rec["config"]
    mod = bench.model(cfg.get("model", ""))
    if mod is None or not rec.get("step_s"):
        return None
    peak = flops.peaks()["flops_per_s"][cfg["dtype"]]
    return 100.0 * mod.train_flops(cfg, rec["traffic"]) / rec["step_s"] / peak
