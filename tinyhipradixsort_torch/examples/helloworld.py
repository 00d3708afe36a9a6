"""The canonical 32-key example (the JAX repo's ``examples/helloworld.py``;
reference: helloworld.cpp:9-73: init -> Config -> RadixSort -> sortKeys ->
print). Kernels build at the first sort on the card.

    python -m tinyhipradixsort_torch.examples.helloworld [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import tinyhipradixsort_torch as thrs
from tinyhipradixsort_torch.tools import device, host_bits, to_device


def run(dev="cuda", out=print) -> None:
    dev = device(str(dev))
    rng = np.random.default_rng(42)
    keys = to_device(rng.integers(0, 2**32, size=32, dtype=np.uint32), dev)

    # functional API (dtype-driven)
    sorted_keys = thrs.sort_keys(keys)

    # class API (reference Config/RadixSort parity)
    rs = thrs.RadixSort(thrs.Config.for_keys(torch.uint32))
    sorted_again = rs.sort_keys(keys)

    for i, (a, b) in enumerate(zip(host_bits(sorted_keys),
                                   host_bits(sorted_again))):
        if a != b:
            raise AssertionError(f"the two APIs differ at {i}: {a} != {b}")
        out(f"{i:2d}: {a:#010x}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    run(ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
