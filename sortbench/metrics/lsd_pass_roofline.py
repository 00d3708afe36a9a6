"""Share of the device time of a call's operations that an LSD radix
sort's 8-bit digit passes would take at the card's peak bandwidth (%).

Each pass reads and writes every key's and payload's bytes once, and the
window has ``window_bits / 8`` of them (the reference's digit). The work
is the same whatever implements the sort; the time is the sum over every
device operation of the window, per call."""

from sortbench import stats


def read(rec):
    if not rec.device_events or not rec.calls or not rec.peaks:
        return None
    device_s = sum(e - s for _, s, e in rec.device_events) / len(rec.calls)
    floor_s = stats.lsd_floor_bytes(rec.keys_per_rank, rec.key_bytes,
                                    rec.value_bytes, rec.window_bits
                                    ) / rec.peaks["bytes_per_s"]
    return 100.0 * floor_s / device_s
