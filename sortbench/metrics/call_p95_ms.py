"""95th percentile of every call's time by the host's clock, from the
call until ``synchronize`` returned (ms)."""

from sortbench import stats


def read(rec):
    if not rec.calls:
        return None
    return 1e3 * stats.percentile([c.done - c.enter for c in rec.calls], 95)
