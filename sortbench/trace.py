"""The device trace of a window: ``torch.profiler`` with CUDA activity
alone (CUPTI: kernels, memcpys, memsets and the runtime calls), read from
its raw events, and placed on the host's clock.

The profiler stamps events on its own clock. Every call of the window
ends in ``torch.cuda.synchronize()``, which the trace holds as a
``cudaDeviceSynchronize`` runtime event; the median gap between those and
the host's reading just before each gives the offset (:func:`align`).
Where the trace holds too few, the offset is the Unix clock's (the
profiler's own) against ``perf_counter``, read at the start.
"""

from __future__ import annotations

import statistics
import time

import torch

_SYNC = "cudaDeviceSynchronize"


class DeviceTrace:
    """``with DeviceTrace(device) as tr:`` profiles the block;
    ``tr.events(...)`` gives its device operations afterwards. The
    profiler first runs one warm-up step, whose events it drops, so that
    CUPTI records from the block's first operation on."""

    def __init__(self, device):
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                             repeat=1))
        self._device = device
        self._unix_offset_ns = None
        self.clock = None

    def __enter__(self):
        self._prof.__enter__()
        torch.zeros(1, device=self._device).add_(1)
        torch.cuda.synchronize(self._device)
        self._prof.step()
        self._unix_offset_ns = time.time_ns() - time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        return self._prof.__exit__(*exc)

    def events(self, syncs_before: list) -> list:
        """Device operations as ``(name, start, end)`` in ``perf_counter``
        seconds. ``syncs_before``: the host's clock just before each
        ``synchronize`` it made since the trace started."""
        device, sync_starts = [], []
        for e in self._prof.profiler.kineto_results.events():
            kind = str(e.device_type())
            if kind.endswith("CUDA"):
                s = e.start_ns()
                device.append((e.name(), s, s + e.duration_ns()))
            elif e.name() == _SYNC:
                sync_starts.append(e.start_ns())
        offset = align(sorted(sync_starts), syncs_before)
        self.clock = "syncs"
        if offset is None:
            offset, self.clock = self._unix_offset_ns, "unix"
        return [(name, (s - offset) / 1e9, (e - offset) / 1e9)
                for name, s, e in device]


def align(sync_starts: list, syncs_before: list):
    """The offset (ns) of the profiler's clock against ``perf_counter``:
    the median gap between the host's syncs and the trace's sync events,
    matched in order at the shift where the gaps agree best (the trace may
    hold syncs the host did not count, such as the profiler's own at its
    stop); None where the trace holds fewer."""
    extra = len(sync_starts) - len(syncs_before)
    if not syncs_before or extra < 0:
        return None
    host = [round(h * 1e9) for h in syncs_before]
    best = None
    for shift in range(extra + 1):
        gaps = sorted(s - h for s, h in zip(sync_starts[shift:], host))
        width = gaps[-1] - gaps[0]
        if best is None or width < best[0]:
            best = (width, statistics.median(gaps))
    return best[1]
