"""Correctness sweep of the non-power-of-two routes on the card (the JAX
repo's ``tools/nonpow2_sweep.py``): the segmented route (a power-of-two
prefix, the rest recursively, one truncated merge) and the padded one,
across the size classes the routing touches:

- two random non-power-of-two sizes in each (2**k, 2**(k+1)) for
  k = 16..24;
- sizes on both sides of ``seg_pad_waste`` (0.90 and 0.80 of 2**22);
- 2**k +- 1 and 4096-divisible sizes;
- with ``--big``, 160,000,000, 2**26 + 4096*7 and 0.82 * 2**26.

Workloads: u32 keys at every size, u32+u32 stable pairs (2**16 distinct
keys) and f32 keys with -0.0 at two sizes. Every output is held bit-equal
to the host oracle (``utils.native_oracle``; the JAX script could check
exactly only to 2**24 with numpy), and every case's route, read at
``bitonic_engine.MARK``, must be the one the waste rule names. The keys
and sizes are the JAX script's, from ``default_rng(--seed)``. One line per
case; the exit code is 1 if any case failed.

    python -m tinyhipradixsort_torch.tools.nonpow2_sweep [--seed 0] [--big]
        [--device cuda|cpu]

The sweep drives the bitonic engine (``method="bitonic"``; on the CPU its
plain twin), the only engine with these routes.
"""

from __future__ import annotations

import argparse

import numpy as np

import tinyhipradixsort_torch as thrs
from tinyhipradixsort_torch.ops import bitonic_engine as be
from tinyhipradixsort_torch.tools import device, host_bits, to_device
from tinyhipradixsort_torch.utils import native_oracle

BIG_SIZES = (160_000_000, (1 << 26) + 4096 * 7, int((1 << 26) * 0.82))


def default_key_sizes(rng) -> list:
    """The JAX sweep's key sizes, drawn from ``rng`` as it draws them."""
    sizes = []
    for k in range(16, 25):
        lo, hi = (1 << k) + 1, (1 << (k + 1)) - 1
        sizes += [int(rng.integers(lo, hi)) for _ in range(2)]
    # threshold-straddling (waste 0.10 / 0.20 around the 0.15 default)
    sizes += [int((1 << 22) * 0.90), int((1 << 22) * 0.80)]
    # near-pow2 and 4096-divisible
    sizes += [(1 << 20) + 1, (1 << 22) - 1, (1 << 22) + 4096 * 3, 4096 * 2741]
    return sorted(set(sizes))


def expected_route(n: int) -> str:
    """The route the waste rule names for a flat non-power-of-two n."""
    L = (n - 1).bit_length()
    waste = be.EngineTuning.from_env().seg_pad_waste
    seg = n > 1 << be.MIN_L and n < int((1 << L) * (1.0 - waste))
    return "segmented" if seg else "padded"


class Sweep:
    def __init__(self, dev, out):
        self.dev, self.out = dev, out
        self.fails = 0

    def run(self, name: str, n: int, call, want: list) -> None:
        """``call()`` sorts; its outputs must equal ``want`` (host bits)
        and its first route must be the expected one."""
        routes = []
        be.MARK = lambda event, route, words: (
            routes.append(route) if event == "route" else None)
        try:
            got = call()
        finally:
            be.MARK = None
        ok = all(np.array_equal(host_bits(g), w) for g, w in zip(got, want))
        route = routes[0] if routes else None
        ok = ok and route == expected_route(n)
        self.fails += not ok
        self.out(f"{'ok' if ok else 'FAIL'}: {name} n={n} route={route}")

    def keys(self, rng, n: int) -> None:
        x = rng.integers(0, 2**32, n, dtype=np.uint32)
        self.run("keys u32", n, lambda: [thrs.sort_keys(
            to_device(x, self.dev), method="bitonic")],
            [native_oracle.oracle_sort(x)[0]])

    def pairs(self, rng, n: int) -> None:
        k = rng.integers(0, 2**16, n, dtype=np.uint32)  # dense ties
        v = np.arange(n, dtype=np.uint32)
        want, perm = native_oracle.oracle_sort(k)
        self.run("pairs u32+u32 stable", n, lambda: thrs.sort_pairs(
            to_device(k, self.dev), to_device(v, self.dev),
            method="bitonic"), [want, v[perm]])

    def f32(self, rng, n: int) -> None:
        x = rng.standard_normal(n).astype(np.float32)
        x[:: max(n // 64, 1)] = -0.0
        self.run("keys f32", n, lambda: [thrs.sort_keys(
            to_device(x, self.dev), method="bitonic")],
            [native_oracle.oracle_sort(x)[0].view(np.uint32)])


def sweep(dev="cuda", seed: int = 0, big: bool = False, key_sizes=None,
          pair_sizes=None, out=print) -> int:
    """Run the sweep; returns the number of failed cases. ``key_sizes`` and
    ``pair_sizes`` replace the JAX script's (drawn from the seed)."""
    dev = device(str(dev))
    rng = np.random.default_rng(seed)
    s = Sweep(dev, out)
    if key_sizes is None:
        key_sizes = default_key_sizes(rng)
    for n in key_sizes:
        s.keys(rng, n)
    if pair_sizes is None:
        pair_sizes = [int(rng.integers((1 << 21) + 1, (1 << 22))),
                      (1 << 22) + 12345]
    for n in pair_sizes:
        s.pairs(rng, n)
        s.f32(rng, n)
    if big:
        for n in BIG_SIZES:
            s.keys(rng, n)
    out(f"FAILURES: {s.fails}")
    return s.fails


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--big", action="store_true",
                    help="add the 2**26-scale and 160M cases")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    fails = sweep(args.device, args.seed, args.big,
                  out=lambda line: print(line, flush=True))
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
