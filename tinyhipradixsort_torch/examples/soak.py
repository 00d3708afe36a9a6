"""The benchmark and soak loop (the JAX repo's ``examples/soak.py``;
reference: main.cpp:60-209): every iteration draws new random keys (and,
with ``--pairs``, a payload), times the sort with its copies to and from
the device, and checks the whole output against the host oracle
(``utils.native_oracle.oracle_sort``). ``--iters 0`` runs until Ctrl-C; a
failed check raises.

    python -m tinyhipradixsort_torch.examples.soak [--n N] [--pairs]
        [--dtype u32|u64|f32|i32] [--iters K] [--seed S] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import tinyhipradixsort_torch as thrs
from tinyhipradixsort_torch.tools import device, host_bits, to_device
from tinyhipradixsort_torch.utils import native_oracle

DTYPES = {"u32": np.uint32, "u64": np.uint64, "f32": np.float32,
          "i32": np.int32}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def soak(n: int = 1 << 24, pairs: bool = False, dtype: str = "u32",
         iters: int = 0, seed=None, dev="cuda", out=print) -> int:
    """Run the loop; returns the iterations done (``iters=0``: forever)."""
    dev = device(str(dev))
    dt = np.dtype(DTYPES[dtype])
    rng = np.random.default_rng(seed)
    it = 0
    while True:
        it += 1
        if dt.kind == "f":
            keys = rng.standard_normal(n).astype(dt)
        else:
            info = np.iinfo(dt)
            keys = rng.integers(info.min, info.max, size=n, dtype=dt,
                                endpoint=True)
        vals = np.arange(n, dtype=np.uint32)
        _sync(dev)
        t0 = time.perf_counter()
        kd = to_device(keys, dev)
        if pairs:
            sk, sv = thrs.sort_pairs(kd, to_device(vals, dev))
            got_k, got_v = host_bits(sk), host_bits(sv)
        else:
            got_k = host_bits(thrs.sort_keys(kd))
        dt_s = time.perf_counter() - t0
        out(f"iter {it}: {dt_s * 1e3:8.2f} ms ({n / dt_s / 1e6:8.1f} Mkeys/s "
            "incl transfers)")

        # the whole output against the oracle, every iteration
        # (main.cpp:174-202)
        want_k, perm = native_oracle.oracle_sort(keys)
        view = np.uint32 if dt.itemsize == 4 else np.uint64
        if not np.array_equal(got_k, want_k.view(view)):
            raise AssertionError(f"iter {it}: keys mismatch")
        if pairs and not np.array_equal(got_v, vals[perm]):
            raise AssertionError(f"iter {it}: payload mismatch")
        if iters and it >= iters:
            return it


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1 << 24)
    ap.add_argument("--pairs", action="store_true")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="u32")
    ap.add_argument("--iters", type=int, default=0, help="0 = run forever")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    soak(args.n, args.pairs, args.dtype, args.iters, args.seed, args.device,
         out=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
