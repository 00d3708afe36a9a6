"""The most device memory the window allocated above what was allocated
at its start (the inputs, and the harness's buffers for the answers it
checks), per key of one call on one card."""


def read(rec):
    if rec.extra_bytes is None:
        return None
    return rec.extra_bytes / rec.keys_per_rank
