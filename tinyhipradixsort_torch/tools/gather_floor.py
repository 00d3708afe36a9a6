"""Per-element dynamic-load floor on Hopper (port of the JAX package's
``tools/gather_floor.py``).

The counting engine's stage 3 kernel moves each pass's key bits itself; the
other arrays (the keys, any payload) follow the pass's permutation as a
gather, ``out = x[src]``, one data-dependent load per element. This probe
measures two floors of that:

* the rate of dynamic loads from an on-chip table: the checksum
  ``sum_o sum_i src[(idx[i] + o) & (m - 1)] mod 2**32`` over ``rounds``
  passes of an m-element permutation ``idx``, computed by the hand-written
  kernel ``csrc/gather_floor.cu`` (the tables in shared memory, each warp
  on one element and 32 consecutive rounds, so every load instruction is
  one bank-conflict-free wavefront), beside its plain PyTorch version
  :func:`gather_checksum_reference` and its bound, the loads at one
  wavefront (32 loads) a clock per SM;
* the rate of the device-memory gather ``src[perm]`` of n 32-bit words by a
  random permutation (the engine's gather itself, a PyTorch index op).

Two shapes matter: the default (m = 4096, 2048 rounds, 8.4M loads), where
one launch takes longer than the loads, and the rate shape (2**18 rounds,
1.07e9 loads), where the loads set the time.

Usage (on a machine with an NVIDIA GPU):
    python -m tinyhipradixsort_torch.tools.gather_floor [--m 4096]
        [--rounds 2048] [--reps 5] [--gather-n 268435456]
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import statistics

import numpy as np
import torch

from ..ops import common, cuda_lib
from ..utils.profiling import trace
from . import (H100_BYTES_PER_S, H100_SHARED_LOADS_PER_S, card, cuda_ms,
               require_cuda)

#: launches of the CUDA gather-floor kernel in this process (counted only
#: where the kernel is launched: a call with no rounds launches none)
KERNEL_LAUNCHES = 0


def make_tables(m: int, seed: int = 0, device="cuda"):
    """``idx``: a random permutation of ``[0, m)``; ``src``: random u32
    words (int32 tensors holding the pattern), both ``(1, m)``, from
    ``seed`` as the JAX tool makes them."""
    if m < 1 or m & (m - 1):
        raise ValueError(f"m must be a power of two, got {m}")
    rng = np.random.default_rng(seed)
    idx = rng.permutation(m).astype(np.int32).reshape(1, m)
    src = rng.integers(0, 2**32, size=(1, m), dtype=np.uint32)
    return (torch.from_numpy(idx).to(device),
            torch.from_numpy(src.view(np.int32)).to(device))


def gather_checksum_reference(idx: torch.Tensor, src: torch.Tensor,
                              rounds: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the checksum as a ``(1, 1)``
    int32 tensor holding the u32 sum, a block of rounds at a time."""
    m = idx.numel()
    idx64 = idx.reshape(1, m).long()
    src64 = src.reshape(m).long() & 0xFFFFFFFF
    acc = torch.zeros((), dtype=torch.int64, device=idx.device)
    step = max(1, (1 << 22) // m)  # sums stay below 2**54
    for o0 in range(0, rounds, step):
        o = torch.arange(o0, min(o0 + step, rounds), dtype=torch.int64,
                         device=idx.device).view(-1, 1)
        acc = (acc + src64[(idx64 + o) & (m - 1)].sum()) & 0xFFFFFFFF
    return torch.where(acc > 0x7FFFFFFF, acc - (1 << 32), acc).to(
        torch.int32).view(1, 1)


@functools.cache
def _gather_fn():
    fn = cuda_lib.load("gather_floor").thrs_gather_floor
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_gather(idx: torch.Tensor, src: torch.Tensor,
                   rounds: int) -> torch.Tensor:
    global KERNEL_LAUNCHES
    m = idx.numel()
    if m < 1 or m & (m - 1) or m > 1 << 14 or rounds < 0:
        raise ValueError(f"need m a power of two up to 2**14 and rounds >= 0,"
                         f" got m={m} rounds={rounds}")
    for name, t in (("idx", idx), ("src", src)):
        if not t.is_cuda or t.device != idx.device:
            raise ValueError(f"{name} must be on {idx.device}, got {t.device}")
        if t.dtype not in (torch.int32, torch.uint32) or t.numel() != m:
            raise TypeError(f"{name} must hold {m} 32-bit words, got "
                            f"{t.dtype} of shape {tuple(t.shape)}")
    idx, src = idx.contiguous(), src.contiguous()
    out = torch.empty((1, 1), dtype=torch.int32, device=idx.device)
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream(idx.device).cuda_stream
        rc = _gather_fn()(idx.data_ptr(), src.data_ptr(), m, rounds,
                          out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"gather floor kernel launch failed: CUDA error "
                           f"{rc} (m={m} rounds={rounds})")
    if rounds:  # with no rounds the zeroed out is the checksum
        KERNEL_LAUNCHES += 1
    return out


def gather_checksum(idx: torch.Tensor, src: torch.Tensor,
                    rounds: int) -> torch.Tensor:
    """The checksum: CUDA tensors through the kernel, CPU tensors through
    :func:`gather_checksum_reference`. ``m = idx.numel()`` is a power of two
    up to 2**14."""
    if common.on_cuda(idx):
        return _launch_gather(idx, src, rounds)
    if idx.device.type != "cpu":
        raise ValueError(f"no gather-floor implementation for {idx.device}")
    return gather_checksum_reference(idx, src, rounds)


def kernel_device_ms(fn, reps: int):
    """Median device time in ms of the gather-floor kernels that ``fn()``
    launches, over ``reps`` calls, as ``torch.profiler`` traces them (the
    kernel alone, without the host's enqueue); None where the trace holds
    no such kernel."""
    fn()
    torch.cuda.synchronize()
    with trace() as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [ev.time_range.elapsed_us() / 1e3 for ev in prof.events()
             if ev.device_type != torch.autograd.DeviceType.CPU
             and "gather_floor_kernel" in ev.name]
    return statistics.median(times) if times else None


def measure(m: int = 4096, rounds: int = 2048, reps: int = 5,
            seed: int = 0) -> dict:
    """Kernel and plain-version checksums and times on the card; raises if
    they differ. ``ms``: one call (CUDA events around it, median of
    ``reps`` after a warm-up), the host's enqueue of the call included;
    ``device_ms``: the kernel alone, from the profiler. ``bound_ms`` is the
    larger of the bytes at 3.35 TB/s and the loads at one conflict-free
    shared-memory wavefront (32 loads) a clock per SM, ``bound_by`` which
    of the two; ``pct_of_bound`` is its share of ``ms``."""
    idx, src = make_tables(m, seed)
    got = gather_checksum(idx, src, rounds)
    want = gather_checksum_reference(idx, src, rounds)
    if not torch.equal(got, want):
        raise AssertionError(f"gather floor kernel {got.item()} != plain "
                             f"version {want.item()} (m={m} rounds={rounds})")
    ms = cuda_ms(lambda: gather_checksum(idx, src, rounds), reps)
    device_ms = kernel_device_ms(lambda: gather_checksum(idx, src, rounds),
                                 reps)
    plain_ms = cuda_ms(lambda: gather_checksum_reference(idx, src, rounds),
                       reps)
    loads = m * rounds
    nbytes = 8 * m + 4
    t_bytes = nbytes / H100_BYTES_PER_S
    t_loads = loads / H100_SHARED_LOADS_PER_S
    bound_ms = max(t_bytes, t_loads) * 1e3
    return {"m": m, "rounds": rounds, "checksum": int(got.item()) & 0xFFFFFFFF,
            "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "loads": loads, "ns_per_load": ms * 1e6 / loads,
            "gloads_per_s": loads / ms / 1e6, "bytes": nbytes,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_loads else "operations",
            "pct_of_bound": 100 * bound_ms / ms}


def describe(r: dict) -> str:
    """One line for a :func:`measure` result."""
    dev = ("not traced" if r["device_ms"] is None
           else f"{r['device_ms']:.6f} ms")
    return (f"m={r['m']} rounds={r['rounds']} ({r['loads']} loads): kernel "
            f"{r['ms']:.6f} ms a call -> {r['ns_per_load']:.6f} ns/load = "
            f"{r['gloads_per_s']:.4f} Gloads/s, {r['pct_of_bound']:.1f}% of "
            f"its bound {r['bound_ms']:.6f} ms ({r['bound_by']}: a "
            f"conflict-free shared-memory wavefront a clock per SM); kernel "
            f"alone (profiler) {dev}; plain version {r['plain_ms']:.6f} ms; "
            f"checksum {r['checksum']:#010x} equal")


def measure_device_gather(n: int = 1 << 28, reps: int = 5,
                          seed: int = 0) -> dict:
    """Device time of ``src[perm]`` for n random u32 words and a random
    permutation (median of ``reps`` after a warm-up), and its rate."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    src = torch.randint(-2**31, 2**31, (n,), generator=gen, device="cuda",
                        dtype=torch.int64).to(torch.int32)
    perm = torch.randperm(n, generator=gen, device="cuda").to(torch.int32)
    ms = cuda_ms(lambda: src[perm], reps)
    moved = 3 * 4 * n  # perm read, src read, out written
    return {"n": n, "ms": ms, "gelems_per_s": n / ms / 1e6,
            "bytes": moved, "tb_per_s": moved / ms / 1e9,
            "bound_ms": moved / H100_BYTES_PER_S * 1e3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--m", type=int, default=4096,
                    help="table elements (a power of two up to 2**14)")
    ap.add_argument("--rounds", type=int, default=2048,
                    help="passes of the m-element loop")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--gather-n", type=int, default=1 << 28,
                    help="elements of the device-memory gather src[perm]")
    args = ap.parse_args(argv)
    require_cuda("gather_floor")
    r = measure(args.m, args.rounds, args.reps)
    print(f"{describe(r)}; card: {card()}")
    g = measure_device_gather(args.gather_n, args.reps)
    print(f"device-memory gather src[perm] of {g['n']} u32: {g['ms']:.6f} ms "
          f"-> {g['gelems_per_s']:.4f} Gelem/s, {g['tb_per_s']:.4f} TB/s "
          f"(bound {g['bound_ms']:.6f} ms at 3.35 TB/s); card: {card()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
