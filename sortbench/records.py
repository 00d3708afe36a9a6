"""What a run records, which every metric reader reads."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Call:
    """One call, by the host's clock (seconds): when the harness entered
    the API, when the API returned, and when ``synchronize`` returned."""
    enter: float
    ret: float
    done: float


@dataclass
class Records:
    #: keys (pairs count once) one call sorts, over all ranks, and on one rank
    keys_per_call: int
    keys_per_rank: int
    #: bytes of one key, and of its payload row (0 without payloads)
    key_bytes: int
    value_bytes: int
    #: bits of the key the sort reads (``end_bit - start_bit``)
    window_bits: int
    #: every call of the measured window, in order
    calls: list
    #: the window's start and end, by the host's clock (seconds)
    window: tuple
    #: seconds from the process's start to the window's start
    setup_s: float
    #: the most device memory the window allocated above what it found
    #: allocated at its start (bytes); None where not measured
    extra_bytes: int | None = None
    #: device operations of a traced window: (name, start, end) in the
    #: host's clock (seconds); None in a run without the trace
    device_events: list | None = None
    #: the card's published peaks (``peaks.py``); None where not listed
    peaks: dict | None = field(default=None)
