"""Device time of every NCCL kernel in the traced window, per call (ms;
rank 0's trace): the exchange, the reductions and gathers with the time
their kernels wait for the slowest rank, and the harness's one-int
``broadcast`` that ends each call of a multi-rank cell."""

from sortbench import exchange


def read(rec):
    if not rec.device_events or not rec.calls:
        return None
    return 1e3 * exchange.collective_seconds(rec) / len(rec.calls)
