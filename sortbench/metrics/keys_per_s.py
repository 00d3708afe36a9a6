"""Keys sorted in the window over the window's seconds by the host's
clock (a pair counts as one key; every call ends in ``synchronize``, so
the host's gaps count)."""


def read(rec):
    if not rec.calls:
        return None
    return len(rec.calls) * rec.keys_per_call / (rec.window[1] - rec.window[0])
