"""Device time of the NCCL kernels that carry the exchange's bytes
(SendRecv, AllToAll) in the traced window, per call (ms; rank 0's
trace): the distributed sort's pre-exchange, ring and rebalance."""

from sortbench import exchange


def read(rec):
    if not rec.device_events or not rec.calls:
        return None
    return 1e3 * exchange.exchange_seconds(rec) / len(rec.calls)
