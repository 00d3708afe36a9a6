"""Share of the exchange's device time a call (``exchange_ms_per_call``:
the NCCL kernels that carry its bytes) that the exchange's floor would
take at the link's peak (%).

The floor is the bytes any sort that returns its input's sharding must
send from a rank (``exchange.floor_bytes``: all but the rank's own share
of its keys); the peak is NVLink 4 on the H100 SXM5, 450 GB/s each way
(900 GB/s in both directions, NVIDIA's data sheet). The same bytes
whatever implements the sort; 0 where the trace holds no kernel
that carries them."""

from sortbench import exchange

#: NVLink 4 on the H100 SXM5, bytes a second in one direction
LINK_BYTES_PER_S = 450e9


def read(rec):
    if not rec.device_events or not rec.calls:
        return None
    seconds = exchange.exchange_seconds(rec) / len(rec.calls)
    if seconds <= 0:
        return 0.0
    return 100.0 * exchange.floor_bytes(rec) / LINK_BYTES_PER_S / seconds
