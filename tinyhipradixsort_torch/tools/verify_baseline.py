"""The BASELINE.json bit-exactness workloads on the card (the JAX repo's
``tools/verify_baseline.py``): 1M u32 keys; 16M u32 keys with 2**16
distinct values and a sequential u32 payload (stability); 16M f32 keys
with -0.0 and NaN; 2**28 u64 keys with a u64 payload. Each output is held
bit-equal to the host oracle (``utils.native_oracle.oracle_sort``: the
native stable radix sort, numpy's where it does not build). The last
workload runs at 2**28 only: a failure there fails, it does not retry at a
smaller size. The keys are the JAX script's, from ``default_rng(9)``.

    python -m tinyhipradixsort_torch.tools.verify_baseline [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

import tinyhipradixsort_torch as thrs
from tinyhipradixsort_torch.tools import device, host_bits, to_device
from tinyhipradixsort_torch.utils import native_oracle


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"verify_baseline: {what} differs from the "
                             "oracle")


def verify(dev="cuda", n_keys: int = 1 << 20, n_kv: int = 1 << 24,
           n_kv64: int = 1 << 28, out=print) -> None:
    """The four workloads at these sizes; raises on the first mismatch."""
    dev = device(str(dev))
    rng = np.random.default_rng(9)

    x = rng.integers(0, 2**32, size=n_keys, dtype=np.uint32)
    got = host_bits(thrs.sort_keys(to_device(x, dev)))
    _check(np.array_equal(got, native_oracle.oracle_sort(x)[0]),
           f"{n_keys} u32 keys")
    out(f"{n_keys} u32 keys: bit-exact")

    # sequential payload: the stability probe
    x = rng.integers(0, 2**16, size=n_kv, dtype=np.uint32)
    v = np.arange(n_kv, dtype=np.uint32)
    k2, v2 = thrs.sort_pairs(to_device(x, dev), to_device(v, dev))
    want, perm = native_oracle.oracle_sort(x)
    _check(np.array_equal(host_bits(k2), want)
           and np.array_equal(host_bits(v2), v[perm]), f"{n_kv} u32+u32 KV")
    out(f"{n_kv} u32+u32 KV: bit-exact + stable")

    x = rng.standard_normal(n_kv).astype(np.float32)
    x[rng.random(n_kv) < 0.01] = -0.0
    x[rng.random(n_kv) < 0.005] = np.nan
    got = host_bits(thrs.sort_keys(to_device(x, dev)))
    _check(np.array_equal(got, native_oracle.oracle_sort(x)[0]
                          .view(np.uint32)), f"{n_kv} f32 keys")
    out(f"{n_kv} f32: bit-exact incl -0.0/NaN")

    xk = rng.integers(0, 2**64, size=n_kv64, dtype=np.uint64)
    xv = rng.integers(0, 2**64, size=n_kv64, dtype=np.uint64)
    k3, v3 = thrs.sort_pairs(to_device(xk, dev), to_device(xv, dev))
    k3, v3 = host_bits(k3), host_bits(v3)
    want, perm = native_oracle.oracle_sort(xk)
    _check(np.array_equal(k3, want) and np.array_equal(v3, xv[perm]),
           f"{n_kv64} u64+u64 KV")
    out(f"{n_kv64} u64+u64 KV: bit-exact + stable")
    out("BASELINE configs verified")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    verify(ap.parse_args(argv).device,
           out=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
