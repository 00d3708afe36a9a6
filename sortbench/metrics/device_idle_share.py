"""Share of the traced window in which no device operation ran (%): one
minus the union of the operations' intervals over the window."""

from sortbench import stats


def read(rec):
    if not rec.device_events:
        return None
    lo, hi = rec.window
    busy = stats.union_seconds([(s, e) for _, s, e in rec.device_events],
                               lo, hi)
    return 100.0 * (1.0 - busy / (hi - lo))
