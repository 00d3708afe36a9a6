"""The benchmark of ``tinyhipradixsort_torch`` on NVIDIA GPUs.

One command runs one cell of ``BENCHMARK.json`` at the repository's root:

    python3 -m sortbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell names a configuration (``configs/<name>.json``: the API call, the
key and value types, the bit window, the order and the guarantees) and a
traffic mix (``traffic/<name>.json``: keys per call, the key distribution,
the engine, the input pool, the calls checked and the ranks). Each metric
is a reader of its own in ``metrics/<name>.py``, and each configuration's
plain reference a module in ``references/<name>.py``. The harness finds
all of them by name, so a cell, a mix or a metric is added as files.
"""
