"""The median decode step of the window: the engine's own host clock
around each decode macro-step, which ends in the copy of the tokens to the
host (``PagedServer.decode_times_s``), ms."""
import statistics


def read(rec):
    times = rec.get("decode_times_s")
    if not times:
        return None
    return 1e3 * statistics.median(times)
