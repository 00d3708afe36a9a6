"""Mean host time from entering the API until it returned, before the
harness synchronizes (ms): the enqueue, and any wait inside the call."""


def read(rec):
    if not rec.calls:
        return None
    return 1e3 * sum(c.ret - c.enter for c in rec.calls) / len(rec.calls)
