"""Batched and segmented sorting (the JAX repo's ``examples/segmented.py``).

The reference library sorts one flat array per call; production workloads
often sort many independent arrays (top-k per query, per-page term lists).
Two native forms here:

* 2-D keys: every row sorts on its own (on the bitonic engine a network
  truncated to one row's stages, B times one row's work).
* ``segment_ids``: stable order by ``(segment_id, key)``, the
  cub::DeviceSegmentedRadixSort analogue, with ``segment_ids_from_offsets``
  taking CUB-style offset arrays.

    python -m tinyhipradixsort_torch.examples.segmented [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

import tinyhipradixsort_torch as thrs
from tinyhipradixsort_torch.tools import device, host_bits, to_device


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def run(dev="cuda", out=print) -> None:
    dev = device(str(dev))
    rng = np.random.default_rng(0)

    # --- batched: 8 independent rows of 1024 keys -------------------------
    rows = rng.integers(0, 1000, size=(8, 1024), dtype=np.uint32)
    sorted_rows = thrs.sort_keys(to_device(rows, dev))
    _check((host_bits(sorted_rows) == np.sort(rows, axis=1)).all(),
           "batched rows")
    out("batched: 8x1024 rows sorted independently")

    # batched pairs: payloads share the (B, n) leading axes
    payload = np.broadcast_to(np.arange(1024, dtype=np.uint32), (8, 1024))
    k, v = thrs.sort_pairs(to_device(rows, dev), to_device(payload, dev))
    order = np.argsort(rows, axis=1, kind="stable")
    _check((host_bits(v) == np.take_along_axis(payload, order, 1)).all(),
           "batched pairs")
    out("batched pairs: payload rows permuted with their keys")

    # --- segmented: CUB-style offsets ------------------------------------
    n = 10000
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    offsets = np.array([0, 1000, 3500, 9000, n], np.int32)
    ids = thrs.segment_ids_from_offsets(to_device(offsets, dev), n)
    got = host_bits(thrs.sort_keys(to_device(keys, dev), segment_ids=ids))
    for a, b in zip(offsets[:-1], offsets[1:]):
        _check((got[a:b] == np.sort(keys[a:b])).all(), f"segment [{a}, {b})")
    out(f"segmented: {len(offsets) - 1} segments each sorted in place")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    run(ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
