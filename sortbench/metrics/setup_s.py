"""Seconds from the process's start to the window's start: imports,
device set-up, inputs, kernel builds (the first run of a checkout) and
the warm-up calls."""


def read(rec):
    return rec.setup_s
