"""Entry points of the PyTorch port (the counterpart of the JAX repo's
``__graft_entry__.py``).

:func:`entry` returns one step of the flagship operation, a stable
key-value sort (``sort_pairs`` of 2**16 u32 keys and u32 values from
``default_rng(0)``, the JAX entry's inputs), with its inputs on the card.
The multi-chip dry run is :func:`.parallel.dryrun.dryrun_multichip`, run
under ``torchrun`` as ``python -m tinyhipradixsort_torch.parallel.dryrun``.

    python -m tinyhipradixsort_torch.entry [--device cuda|cpu]

runs one step, checks it against numpy's stable sort and prints
``entry: ok``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import sort as sort_mod
from .parallel.dryrun import dryrun_multichip
from .tools import device, host_bits, to_device

__all__ = ["entry", "dryrun_multichip"]


def entry(dev: torch.device | str = "cuda"):
    """``(step, (keys, values))``: ``step(keys, values)`` is the stable
    key-value sort of the JAX entry's 2**16 u32 keys and values, which lie
    on ``dev``."""
    dev = device(str(dev))
    n = 1 << 16
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    values = rng.integers(0, 2**32, size=n, dtype=np.uint32)

    def step(keys, values):
        return sort_mod.sort_pairs(keys, values)

    return step, (to_device(keys, dev), to_device(values, dev))


def run(dev: torch.device | str = "cuda", out=print) -> None:
    """One step on ``dev``, checked against numpy's stable sort; raises on
    a mismatch, else ``out("entry: ok")``."""
    step, (keys, values) = entry(dev)
    sk, sv = step(keys, values)
    k, v = host_bits(keys), host_bits(values)
    order = np.argsort(k, kind="stable")
    if not (np.array_equal(host_bits(sk), k[order])
            and np.array_equal(host_bits(sv), v[order])):
        raise AssertionError("entry: the step's output != numpy's stable sort")
    out("entry: ok")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    run(ap.parse_args(argv).device, out=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
