"""Weak-scaling harness of the distributed sort (the counterpart of the
JAX repo's ``benchmarks/scaling.py``; BASELINE.json's scale axis).

``psort_keys`` at a fixed share per rank (``--per-chip``) over groups of
the first P ranks of the world that ``torchrun`` starts (the JAX script's
sub-meshes): for each P of ``--devices`` (default 1, 2, half the world and
all of it), ``P * per_chip`` u32 keys from ``default_rng(0)`` (the JAX
script's draws; ``--zipf``: ``np.minimum(zipf(1.3), 2**31)``), each rank
of the group sorting its even piece. A call's time is the slowest rank's:
every rank times its call after a barrier, with CUDA events on the card
(the host clock on gloo CPU ranks), and the times are ``all_reduce``-d
with MAX; ``seconds`` is the best of ``--reps`` calls after a warm-up,
``median_s`` their median. Weak-scaling efficiency is
``rate(P) / (P * rate(1))``, ``rate(1)`` the per-rank rate at the
smallest P. Each row also has the words per element that each exchange
step carried (``psort.WIRE``, rank 0's view).

On the card (NCCL, one rank per card):

    torchrun --nproc_per_node=<cards> -m tinyhipradixsort_torch.benchmarks.scaling

On the CPU, the counterpart of the JAX script's ``--cpu-mesh``, gloo worlds
of up to 8 processes (rows P = 1, 2, 4, 8):

    torchrun --nproc_per_node=8 -m tinyhipradixsort_torch.benchmarks.scaling --device cpu

CPU numbers show the collectives' overhead only, not a card's rates.
Rank 0 prints one line per P and writes JSON only to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch
import torch.distributed as dist

from ..parallel import multihost, psort
from ..tools import device, device_name, to_device
from ..utils import time_call

SIZES = {"256K": 1 << 18, "1M": 1 << 20, "4M": 1 << 22, "16M": 1 << 24,
         "64M": 1 << 26}


def default_sizes(world: int) -> list:
    """The JAX script's mesh sizes: 1, 2, half and all of the devices."""
    return sorted({1, 2, world // 2, world} - {0})


def _slowest_call(fn, dev, group) -> float:
    """Seconds of one ``fn()`` on the slowest rank of ``group``."""
    on_cuda = dev.type == "cuda"
    dist.barrier(group=group, device_ids=[dev.index] if on_cuda else None)
    seconds, _ = time_call(fn, on_cuda=on_cuda)
    t = torch.tensor([seconds], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return float(t.item())


def run(per_chip: int, zipf: bool = False, plist=None, reps: int = 3,
        dev: torch.device | str = "cuda", out=print) -> list:
    """Rows of the weak-scaling table over the default group (every rank
    calls this; rank 0's ``out`` takes each line). A P below the world
    size sorts over a group of the first P ranks."""
    dev = device(str(dev))
    if dev.type == "cuda" and dev.index is None:
        # the rank's own card (NCCL's barrier names it)
        dev = torch.device("cuda", torch.cuda.current_device())
    world, me = dist.get_world_size(), dist.get_rank()
    plist = default_sizes(world) if plist is None else list(plist)
    rng = np.random.default_rng(0)
    rows, base_rate = [], None
    for p in plist:
        if p > world:
            continue
        n = per_chip * p
        if zipf:
            keys = np.minimum(rng.zipf(1.3, size=n), 2**31).astype(np.uint32)
        else:
            keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
        group = None if p == world else dist.new_group(list(range(p)))
        if me >= p:
            continue
        piece = to_device(keys[me * per_chip:(me + 1) * per_chip], dev)
        wire = {}
        psort.WIRE = lambda step, nw: wire.setdefault(step, nw)
        try:
            psort.psort_keys(piece, group=group)  # warm-up
        finally:
            psort.WIRE = None
        times = [_slowest_call(lambda: psort.psort_keys(piece, group=group),
                               dev, group) for _ in range(reps)]
        t = min(times)
        rate = n / t
        if base_rate is None:
            base_rate = rate / p  # the per-rank rate at the smallest P
        eff = rate / (p * base_rate)
        rows.append({"devices": p, "n": n, "seconds": t,
                     "median_s": statistics.median(times),
                     "keys_per_s": rate, "weak_scaling_efficiency": eff,
                     "wire": wire})
        if me == 0:
            out(f"P={p:3d} n={n:>12,} {t * 1e3:12.4f} ms  "
                f"{rate / 1e6:12.4f} Mkeys/s  eff={eff:.4f}  wire={wire}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--per-chip", default="1M",
                    help=f"keys per rank: one of {sorted(SIZES)} or a count")
    ap.add_argument("--zipf", action="store_true")
    ap.add_argument("--devices", default=None,
                    help="comma list of group sizes (default 1,2,W/2,W)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--init-method", default=None,
                    help="torch.distributed init method (default env://)")
    ap.add_argument("--out", default=None, help="rank 0 writes JSON here")
    args = ap.parse_args(argv)
    per_chip = SIZES.get(args.per_chip) or int(args.per_chip)
    dev = device(args.device)
    multihost.initialize(backend="nccl" if dev.type == "cuda" else "gloo",
                         init_method=args.init_method)
    try:
        plist = ([int(p) for p in args.devices.split(",")] if args.devices
                 else None)
        rows = run(per_chip, args.zipf, plist, args.reps, dev,
                   out=lambda line: print(line, flush=True))
        if args.out and dist.get_rank() == 0:
            with open(args.out, "w") as f:
                json.dump({"per_chip": per_chip,
                           "zipf": args.zipf, "platform": dev.type,
                           "device": device_name(dev), "rows": rows}, f,
                          indent=1)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
