"""Share of the device time of a call's ``rank_scatter_kernel`` operations
(the counting engine's stage 3, ``csrc/rank_scatter.cu``) that an LSD
radix sort's 8-bit digit passes would take at the card's peak bandwidth
(%).

The floor is ``lsd_pass_roofline``'s: each pass reads and writes every
key's and payload's bytes once, ``window_bits / 8`` passes. It is the same
work whatever implements the pass; the time is only the kernel's, summed
over the window, per call. None without a trace, without the card's peaks
or without such an operation (a call that takes another engine)."""

from sortbench import stats

#: the part of the kernel's name that the trace's operations hold
KERNEL = "rank_scatter_kernel"


def read(rec):
    if not rec.device_events or not rec.calls or not rec.peaks:
        return None
    kernel_s = sum(e - s for name, s, e in rec.device_events if KERNEL in name)
    if kernel_s <= 0:
        return None
    floor_s = stats.lsd_floor_bytes(rec.keys_per_rank, rec.key_bytes,
                                    rec.value_bytes, rec.window_bits
                                    ) / rec.peaks["bytes_per_s"]
    return 100.0 * floor_s / (kernel_s / len(rec.calls))
