"""Device time of the operations inside the calls that are not kernels of
the program's own sources (``csrc/``), per call (ms): the runtime's
memcpys and memsets and PyTorch's own kernels, by name (``Memcpy``,
``Memset``, ``at::native``). In a counting call on a length that is not
whole tiles, those are the staging's pad copy and its fill. An operation
counts where it starts between a call's entry and the end of its
``synchronize``, so the harness's copies of sampled answers, made between
calls, are left out. 0.0 where none ran; None without a trace."""

import bisect

#: parts of the names of the operations that are not the program's kernels
NAMES = ("Memcpy", "Memset", "at::native")


def read(rec):
    if rec.device_events is None or not rec.calls:
        return None
    enters = [c.enter for c in rec.calls]
    seconds = 0.0
    for name, s, e in rec.device_events:
        if not any(part in name for part in NAMES):
            continue
        i = bisect.bisect_right(enters, s) - 1
        if i >= 0 and s <= rec.calls[i].done:
            seconds += e - s
    return 1e3 * seconds / len(rec.calls)
