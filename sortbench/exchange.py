"""The exchange of a distributed sort in a traced window: the device time
of its collective kernels, and the bytes that any sort returning its
input's sharding must send from a rank."""

from __future__ import annotations

from sortbench import stats

#: NCCL kernels that carry an exchange's bytes (``all_to_all_single`` and
#: ``batch_isend_irecv`` run as SendRecv; some NCCL builds name AllToAll)
CARRIERS = ("sendrecv", "alltoall")


def _nccl_seconds(rec, names) -> float:
    """Seconds of the window in which a NCCL kernel whose name holds one
    of ``names`` (in any case) ran."""
    lo, hi = rec.window
    spans = []
    for name, s, e in rec.device_events:
        low = name.lower()
        if "nccl" in low and any(k in low for k in names):
            spans.append((s, e))
    return stats.union_seconds(spans, lo, hi)


def collective_seconds(rec) -> float:
    """Seconds of the window in which any NCCL kernel ran (a name holding
    ``nccl``, in any case): every collective of the sort, with the time a
    rank's kernel waits for the slowest rank, and the harness's one-int
    ``broadcast`` a call."""
    return _nccl_seconds(rec, ("",))


def exchange_seconds(rec) -> float:
    """Seconds of the window in which a NCCL kernel that carries the
    exchange's bytes ran (:data:`CARRIERS`): the reductions and gathers
    of a few words, and the harness's broadcast, are left out."""
    return _nccl_seconds(rec, CARRIERS)


def floor_bytes(rec) -> float:
    """Bytes one rank has to send: with its keys (and payloads) spread
    evenly over the ``P = keys_per_call / keys_per_rank`` ranks' outputs,
    all but its own share ``1/P`` leave it."""
    P = rec.keys_per_call / rec.keys_per_rank
    return rec.keys_per_rank * (rec.key_bytes + rec.value_bytes) * (P - 1) / P
