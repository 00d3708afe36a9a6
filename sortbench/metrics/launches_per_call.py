"""Device operations (kernels, memcpys, memsets) the profiler recorded in
the window, per call."""


def read(rec):
    if rec.device_events is None or not rec.calls:
        return None
    return len(rec.device_events) / len(rec.calls)
