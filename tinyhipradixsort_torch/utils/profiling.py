"""Timing and profiling helpers (PyTorch port of
``tinyhipradixsort_tpu/utils/profiling.py``).

The counterpart of the reference's OroStopwatch event timing (reference:
unittest.cpp:513-520, main.cpp:154-167): CUDA events around work on CUDA
tensors, the host clock around work on CPU tensors, and ``torch.profiler``
for per-kernel breakdowns.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["Stopwatch", "call_times", "time_call", "time_fn", "trace"]


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Stopwatch:
    """Wall-clock stopwatch around device work: it waits for the CUDA
    device before it reads the clock, at start and at stop."""

    def __init__(self):
        self._t0 = None
        self.elapsed_s = 0.0

    def start(self):
        _sync()
        self._t0 = time.perf_counter()
        return self

    def stop(self, result=None) -> float:
        """Seconds since :meth:`start`, once the device has finished (the
        ``result`` is accepted for the JAX package's signature: torch's
        work is waited for by the synchronisation)."""
        _sync()
        self.elapsed_s = time.perf_counter() - self._t0
        return self.elapsed_s

    @property
    def ms(self) -> float:
        return self.elapsed_s * 1e3


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    items = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (list, tuple)) else ())
    for item in items:
        found = _first_tensor(item)
        if found is not None:
            return found
    return None


def _on_cuda(args) -> bool:
    leaf = _first_tensor(args)
    return leaf is not None and leaf.is_cuda


def time_call(fn, *args, on_cuda: bool | None = None):
    """One call of ``fn(*args)``: ``(seconds, result)``. CUDA events when
    ``on_cuda`` (by default: when the first tensor argument is on a CUDA
    device), the host clock otherwise."""
    if on_cuda is None:
        on_cuda = _on_cuda(args)
    if on_cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3, out
    t0 = time.perf_counter()
    out = fn(*args)
    return time.perf_counter() - t0, out


def call_times(fn, *args, reps: int = 5, warmup: int = 1) -> list:
    """The time of each of ``reps`` calls of ``fn(*args)`` in seconds,
    after ``warmup`` untimed calls (:func:`time_call`)."""
    on_cuda = _on_cuda(args)
    for _ in range(max(warmup, 1)):
        fn(*args)
    _sync()
    return [time_call(fn, *args, on_cuda=on_cuda)[0] for _ in range(reps)]


def time_fn(fn, *args, reps: int = 5, warmup: int = 1,
            subtract_floor: bool = True):
    """Best-of-``reps`` time of ``fn(*args)`` in seconds, after ``warmup``
    runs, and the floor subtracted from it: the time of ``a + 1`` on the
    first tensor argument (a launch and one pass over it). CUDA events
    when that tensor is on a CUDA device, the host clock otherwise.
    Returns ``(best_s, floor_s)``."""
    leaf = _first_tensor(args)
    best = min(call_times(fn, *args, reps=reps, warmup=warmup))
    floor = 0.0
    if subtract_floor and leaf is not None:
        def triv(a):
            return a if a.dtype == torch.bool else a + 1
        triv(leaf)
        floor = min(time_call(triv, leaf)[0] for _ in range(reps))
    return max(best - floor, 0.0), floor


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """``torch.profiler`` over the block (CPU activity, and CUDA activity
    where a device is present); yields the profiler, whose
    ``key_averages()`` sums the time by kernel. With ``log_dir`` the
    timeline is written there as ``trace.json`` (chrome://tracing)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                acc_events=True) as prof:
        yield prof
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
