"""Device time of the operations the update launches (the program's
``train_step.adamw`` range) over the traced window's device busy time, %.
"""
from hexabench import devtrace


def read(rec):
    busy = devtrace.busy_ns(rec)
    if "train_step.adamw" not in rec["ranges"] or not busy:
        return None
    return 100.0 * devtrace.launched_in_ns(rec, "train_step.adamw") / busy
