"""The benchmark matrix of the PyTorch port (the counterpart of the JAX
repo's ``benchmarks/full.py``): the reference's workloads (unittest.cpp:
490-685, main.cpp) on one card, beside ``torch.sort(stable=True)`` as the
comparison column (the role ``jnp.sort`` plays in the JAX table and
cub::DeviceRadixSort in the reference).

Rows, for each size of ``--sizes``: ``sort_keys`` of u32, f32 and u64 keys,
``sort_pairs`` of u32+u32 and u64+u64; then ``sort_keys`` of 4096x4096 u32
rows. Keys come from a seeded ``torch.Generator`` on the device (random
bits; f32 from ``randn``), values ``arange(n)``. :func:`run_row` also
takes f16 keys (``randn``) and u128 values (``(n, 4)`` words counting up). The comparison sorts
the same keys: unsigned keys through their signed view with the sign bit
flipped (the same order), pairs as that sort plus a gather of the values
by its permutation, rows with ``dim=-1``. Each row checks that both
columns agree bit for bit.

Timing: the host's clock around single calls after a warm-up call, from
a synchronized device until the call's work is done, as a caller waits
for it (``utils.call_times(host_clock=True)``). ``*_s`` is the best of
``--reps`` calls, ``*_median_s`` their median and ``*_p95_s`` their 95th percentile, with
ten times the calls for a sort whose median is below 1 ms. Each row's
``engine`` is the one ``--method`` resolves to for its shape. Every row
runs both columns: a row that does not fit on the card fails.

    python -m tinyhipradixsort_torch.benchmarks.full [--sizes 1M,16M,256M]
        [--reps 3] [--method auto] [--device cuda|cpu] [--out PATH]

``--sizes`` takes any of :data:`SIZES`; ``1M,2M,4M,8M,16M,64M,256M``
through ``bitonic`` and ``counting`` is the table that places
``sort.AUTO_COUNTING_MIN_N``.

The markdown table goes to stdout; JSON only to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

from .. import sort as sort_mod
from ..tools import device, device_name
from ..utils import call_times

SIZES = {"1M": 1 << 20, "2M": 1 << 21, "4M": 1 << 22, "8M": 1 << 23,
         "16M": 1 << 24, "64M": 1 << 26, "256M": 1 << 28}
SEED = 0
_SIGN32 = -(1 << 31)
_SIGN64 = -(1 << 63)


def workloads(labels) -> list:
    """(name, key kind, n or (B, row length), value kind or None)."""
    out = []
    for label in labels:
        n = SIZES[label]
        out += [
            (f"sort_keys u32 {label}", "u32", n, None),
            (f"sort_keys f32 {label}", "f32", n, None),
            (f"sort_keys u64 {label}", "u64", n, None),
            (f"sort_pairs u32+u32 {label}", "u32", n, "u32"),
            # the BASELINE pairs metric: KV64 (u64 keys, u64 payload)
            (f"sort_pairs u64+u64 {label}", "u64", n, "u64"),
        ]
    out.append(("sort_keys u32 batched 4096x4096", "u32", (4096, 4096), None))
    return out


def _words(n: int, gen: torch.Generator, dev) -> torch.Tensor:
    """n int32 words of random bits."""
    return torch.randint(-2**31, 2**31, (n,), generator=gen, device=dev,
                         dtype=torch.int64).to(torch.int32)


def make_keys(kind: str, n: int, gen: torch.Generator, dev):
    """(keys, their signed view that orders as the keys do)."""
    if kind in ("f32", "f16"):
        keys = torch.randn(n, generator=gen, device=dev,
                           dtype=torch.float32 if kind == "f32" else
                           torch.float16)
        return keys, keys
    if kind == "u32":
        w = _words(n, gen, dev)
        return w.view(torch.uint32), w ^ _SIGN32
    lo, hi = _words(n, gen, dev), _words(n, gen, dev)
    w = torch.stack([lo, hi], dim=-1).view(torch.int64).squeeze(-1)
    return w.view(torch.uint64), w ^ _SIGN64


def make_values(kind: str, n: int, dev) -> torch.Tensor:
    """``arange(n)`` in the payload's width (signed: the same bits as the
    unsigned payload, and torch gathers every signed dtype); a u128 payload
    is ``(n, 4)`` int32 words counting up."""
    if kind == "u128":
        return torch.arange(4 * n, dtype=torch.int32, device=dev).view(n, 4)
    return torch.arange(n, dtype=torch.int32 if kind == "u32" else torch.int64,
                        device=dev)


def _ordered(t: torch.Tensor, kind: str) -> torch.Tensor:
    """Sorted keys as the comparison column holds them (its signed view)."""
    if kind in ("f32", "f16"):
        return t
    if kind == "u32":
        return t.view(torch.int32) ^ _SIGN32
    return t.view(torch.int64) ^ _SIGN64


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    signed = {4: torch.int32, 8: torch.int64}[a.dtype.itemsize]
    return torch.equal(a.view(signed), b.view(signed))


def _times(fn, args, reps: int) -> list:
    times = call_times(fn, *args, reps=reps, host_clock=True)
    if statistics.median(times) < 1e-3:
        times = call_times(fn, *args, reps=10 * reps, host_clock=True)
    return times


def _p95(times: list) -> float:
    if len(times) < 2:
        return times[0]
    return statistics.quantiles(times, n=20, method="inclusive")[-1]


def run_row(name, kind, shape, vkind, *, reps, method, gen, dev) -> dict:
    """Time one workload in both columns and check that they agree."""
    B, nr = shape if isinstance(shape, tuple) else (1, shape)
    n = B * nr
    keys, signed = make_keys(kind, n, gen, dev)
    if isinstance(shape, tuple):
        keys, signed = keys.view(B, nr), signed.view(B, nr)
    if vkind is None:
        args, ref_args = (keys,), (signed,)

        def ours(k):
            return (sort_mod.sort_keys(k, method=method),)

        def ref(s):
            return (torch.sort(s, dim=-1, stable=True).values,)
    else:
        vals = make_values(vkind, n, dev)
        args, ref_args = (keys, vals), (signed, vals)

        def ours(k, v):
            return sort_mod.sort_pairs(k, v, method=method)

        def ref(s, v):
            srt, perm = torch.sort(s, stable=True)
            return srt, v[perm]
    got, want = ours(*args), ref(*ref_args)
    if not (torch.equal(_ordered(got[0], kind), want[0])
            and all(_same_bits(g, w) for g, w in zip(got[1:], want[1:]))):
        raise AssertionError(f"{name}: the engine and torch.sort disagree")
    del got, want
    t_ours = _times(ours, args, reps)
    t_ref = _times(ref, ref_args, reps)
    best, ref_best = min(t_ours), min(t_ref)
    return {"workload": name, "n": n,
            "engine": sort_mod._resolve_method(method, keys),
            "reps": len(t_ours),
            "ours_s": best, "ours_median_s": statistics.median(t_ours),
            "ours_p95_s": _p95(t_ours),
            "torch_s": ref_best, "torch_median_s": statistics.median(t_ref),
            "torch_p95_s": _p95(t_ref),
            "ours_keys_per_s": n / best, "torch_keys_per_s": n / ref_best,
            "speedup_vs_torch": ref_best / best}


def run(sizes=("1M", "16M", "256M"), reps: int = 3, method: str = "auto",
        dev: torch.device | str = "cuda", out=print) -> dict:
    """The matrix at ``sizes``; ``out`` takes each markdown line."""
    dev = device(str(dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    rows = []
    out("| workload | this engine | torch.sort | ratio |")
    out("|---|---|---|---|")
    for name, kind, shape, vkind in workloads(sizes):
        row = run_row(name, kind, shape, vkind, reps=reps, method=method,
                      gen=gen, dev=dev)
        rows.append(row)
        out(f"| {name} | {row['ours_keys_per_s'] / 1e9:.4f} Gkeys/s "
            f"| {row['torch_keys_per_s'] / 1e9:.4f} Gkeys/s "
            f"| {row['speedup_vs_torch']:.4f}x |")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return {"platform": dev.type, "device": device_name(dev),
            "method": method, "results": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="1M,16M,256M")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--method", default="auto")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the JSON here")
    args = ap.parse_args(argv)
    table = run([s.strip() for s in args.sizes.split(",")], args.reps,
                args.method, args.device,
                out=lambda line: print(line, flush=True))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(table, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
