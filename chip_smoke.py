#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tinyhipradixsort_torch) on one NVIDIA GPU.

Run from the root of the repository, on a machine with a Hopper card
(sm_90a), the CUDA toolkit and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases, one output line each (time, kernel launches, result):

1. device: the card's name and power limit (nvidia-smi);
2. build: the bitonic sweep kernel, from csrc/ into the ignored _build/;
3. kernel vs plain: sweeps of 1, 3 and 5 words (local, cross, forced
   ascending) on 2**20 random words, and the cross sweeps over the top
   index bits of the 2**28 one-word and 2**24 three-word networks, through
   the CUDA kernel and through ``run_sweep_reference``, required bit-equal;
4. main path: the public entry points at real sizes (sort_keys u32 at 2**28,
   the bench workload; pairs at 2**24 and 2**16; f32 with NaN and -0.0;
   u64 pairs; u32 at 160,000,000; a descending, a bit-window and a
   sort_indices case), each bit-exact against a numpy stable-sort oracle on
   the host, each required to launch the kernel;
5. timing: sort_keys u32 at 2**28 (CUDA events, median of 5 after a
   warm-up) beside torch.sort(stable=True) as the yardstick, and the first
   sweep of its network through the kernel beside its plain version, each
   run on a fresh copy of the random keys and required bit-equal;
6. breakdown: the device time of each of that network's sweeps.

The line before the last is the kernel report, {"kernels": [...]}; the last
line is {"ok": true, "device": {...}}. Any failure raises and exits non-zero
without a result; so does a machine without CUDA.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import tinyhipradixsort_torch as thrs  # noqa: E402
from tinyhipradixsort_torch.ops import bitonic_engine as be  # noqa: E402
from tinyhipradixsort_torch.ops import cuda_lib  # noqa: E402

REPLACES = "tinyhipradixsort_tpu/ops/bitonic_engine.py:267"
SOURCE = "tinyhipradixsort_torch/csrc/bitonic_sweep.cu"
SEED = 20260


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Median device time of ``fn()`` over ``reps`` runs, after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 3: the kernel against its plain version
# ---------------------------------------------------------------------------


def _plan(L: int, nwords: int, tuning: be.EngineTuning) -> list:
    """The sweep plan the main path runs for 2**L elements of nwords words."""
    T = be._tile_bits_for(nwords, L, tuning)
    return be.plan_sweeps(L, T, T, g_max_cross=tuning.cross_g_max)


def sweep_cases(tuning: be.EngineTuning):
    """(label, L, ncmp, nwords, sweep).

    At L=20, for 1, 3 and 5 words: the first local sweep, a later local
    sweep, the widest and the narrowest cross sweep, and forced-ascending
    variants. Then the cross sweeps of the main path's own plans that reach
    the top index bits (1 word at L=28, the bench workload; 3 words at L=24,
    the pairs case): the last stage's top sweep, and the widest and
    narrowest sweeps of the stage below it, whose direction bit is the top
    index bit.
    """
    cases = []
    L = 20
    for nwords, ncmp in ((1, 1), (3, 3), (5, 3)):
        plan = _plan(L, nwords, tuning)
        local = [s for s in plan if s.g == 0]
        cross = [s for s in plan if s.g > 0]
        picks = {"local-first": local[0], "local-late": local[-1],
                 "cross-widest": max(cross, key=lambda s: s.g),
                 "cross-narrowest": min(cross, key=lambda s: s.g)}
        # forced ascending where it changes the result: stages below L
        below_L = [s for s in cross if s.substages[0][0] < L]
        for name, s, k in (("local-first", local[0], local[0].c),
                           ("local-second", local[1], local[1].substages[0][0]),
                           ("cross-below-L", below_L[-1],
                            below_L[-1].substages[0][0])):
            picks[name + "-forced"] = dataclasses.replace(s, forced_asc=k)
        for name, s in picks.items():
            cases.append((f"{nwords}w/L{L}/{name}", L, ncmp, nwords, s))
    for L, nwords in ((28, 1), (24, 3)):
        cross = [s for s in _plan(L, nwords, tuning) if s.g > 0]
        last = [s for s in cross if s.substages[0][0] == L]
        below = [s for s in cross if s.substages[0][0] == L - 1]
        widest = max(below, key=lambda s: (s.g, s.j_lo))
        picks = {"top": max(last, key=lambda s: s.j_lo),
                 "below-top-widest": widest,
                 "below-top-narrowest": min(below, key=lambda s: s.g),
                 "below-top-widest-forced":
                     dataclasses.replace(widest, forced_asc=L - 1)}
        for name, s in picks.items():
            cases.append((f"{nwords}w/L{L}/{name}", L, nwords, nwords, s))
    return cases


def random_words(nwords: int, n: int, gen: torch.Generator) -> list:
    """One word: full range. More words: word 0 from a small range (ties
    reach the later words), word 1 full range with all-ones sentinels, word
    2 a distinct index, carries full range."""
    dev = torch.device("cuda")
    if nwords == 1:
        return [torch.randint(-2**31, 2**31, (n,), generator=gen, device=dev,
                              dtype=torch.int64).to(torch.int32)]
    words = [torch.randint(0, 64, (n,), generator=gen, device=dev,
                           dtype=torch.int32)]
    w = torch.randint(-2**31, 2**31, (n,), generator=gen, device=dev,
                      dtype=torch.int64).to(torch.int32)
    w[torch.randint(0, n, (n // 64,), generator=gen, device=dev)] = -1
    words.append(w)
    words.append(torch.randperm(n, generator=gen, device=dev)
                 .to(torch.int32))
    while len(words) < nwords:
        words.append(torch.randint(-2**31, 2**31, (n,), generator=gen,
                                   device=dev, dtype=torch.int64)
                     .to(torch.int32))
    return words


def phase_sweeps() -> int:
    tuning = be.EngineTuning()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    worst = 0
    for label, L, ncmp, nwords, sweep in sweep_cases(tuning):
        words = random_words(nwords, 1 << L, gen)
        t0 = time.perf_counter()
        got = be.run_sweep([w.clone() for w in words], sweep, ncmp)
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t0
        want = be.run_sweep_reference([w.clone() for w in words], sweep, ncmp)
        torch.cuda.synchronize()
        err = max(int((be.unsigned(a) - be.unsigned(b)).abs().max())
                  for a, b in zip(got, want))
        ok = all(torch.equal(a, b) for a, b in zip(got, want))
        log("3 kernel-vs-plain",
            f"{label}: c={sweep.c} g={sweep.g} j_lo={sweep.j_lo} "
            f"substages={len(sweep.substages)} forced_asc={sweep.forced_asc}"
            f" kernel {kernel_s * 1e3:.3f} ms max_abs_err={err} "
            f"{'bit-equal' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"kernel != plain version on sweep {label}")
        worst = max(worst, err)
        del words, got, want
        torch.cuda.empty_cache()
    return worst


# ---------------------------------------------------------------------------
# phase 4: the main path against numpy oracles
# ---------------------------------------------------------------------------


def _rand_keys(rng, dtype, n: int, specials: bool = False) -> np.ndarray:
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        x = rng.standard_normal(n).astype(dtype)
        if specials:
            x[rng.random(n) < 0.02] = 0.0
            x[rng.random(n) < 0.02] = -0.0
            x[rng.random(n) < 0.01] = np.nan
            x[rng.random(n) < 0.01] = -np.inf
        return x
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, size=n, dtype=dtype,
                        endpoint=True)


def _bits_view(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint64 if a.dtype.itemsize == 8 else np.uint32)


def oracle_bits(keys: np.ndarray, descending: bool) -> np.ndarray:
    """The radix sort's total order as unsigned numpy bits, written out here
    so that the oracle does not rest on the port: signed ints flip the sign
    bit; floats flip every bit of negatives and the sign bit of the rest,
    after -0.0 is made +0.0 (so the two zeros tie and keep input order);
    descending complements."""
    width = keys.dtype.itemsize * 8
    u = keys.view(np.uint64 if width == 64 else np.uint32)
    top = u.dtype.type(1 << (width - 1))
    if keys.dtype.kind == "i":
        u = u ^ top
    elif keys.dtype.kind == "f":
        u = np.where(u == top, u.dtype.type(0), u)
        u = np.where((u & top) != 0, ~u, u | top)
    return ~u if descending else u


def _perm(keys: np.ndarray, descending=False, start_bit=0, end_bit=None):
    bits = oracle_bits(keys, descending)
    if end_bit is not None:
        bits = (bits >> bits.dtype.type(start_bit)) & bits.dtype.type(
            (1 << (end_bit - start_bit)) - 1)
    return np.argsort(bits, kind="stable")


def main_path_cases():
    """(label, run) pairs; run(rng) -> (device seconds, check) where check()
    compares with the oracle on the host."""

    def keys_only(dtype, n, specials=False, **kw):
        def run(rng):
            x = _rand_keys(rng, dtype, n, specials)
            xd = torch.from_numpy(x).cuda()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = thrs.sort_keys(xd, **kw)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got = out.cpu().numpy()
            del xd, out

            def check():
                want = (np.sort(x) if x.dtype.kind in "ui" and not kw
                        else x[_perm(x, kw.get("order") == "descending")])
                return (got.shape == x.shape
                        and np.array_equal(_bits_view(got), _bits_view(want)))
            return secs, check
        return run

    def pairs(kdtype, n, specials=False, order="ascending", **kw):
        def run(rng):
            x = _rand_keys(rng, kdtype, n, specials)
            v = rng.integers(0, 2**64 if kdtype == np.uint64 else 2**32,
                             size=n, dtype=np.uint64 if kdtype == np.uint64
                             else np.uint32)
            xd, vd = torch.from_numpy(x).cuda(), torch.from_numpy(v).cuda()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            k, vals = thrs.sort_pairs(xd, vd, order=order, **kw)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            gk, gv = k.cpu().numpy(), vals.cpu().numpy()
            del xd, vd, k, vals

            def check():
                p = _perm(x, order == "descending", kw.get("start_bit", 0),
                          kw.get("end_bit"))
                return (np.array_equal(_bits_view(gk), _bits_view(x[p]))
                        and np.array_equal(gv, v[p]))
            return secs, check
        return run

    def indices(dtype, n):
        def run(rng):
            x = _rand_keys(rng, dtype, n)
            xd = torch.from_numpy(x).cuda()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            perm = thrs.sort_indices(xd)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got = perm.cpu().numpy()
            del xd, perm
            return secs, lambda: (got.dtype == np.int32
                                  and np.array_equal(got, _perm(x)))
        return run

    return [
        ("sort_keys u32 n=2**28 (bench workload)", keys_only(np.uint32, 1 << 28)),
        ("sort_pairs u32+u32 n=2**24", pairs(np.uint32, 1 << 24)),
        ("sort_pairs u32+u32 n=2**16 (graft entry)", pairs(np.uint32, 1 << 16)),
        ("sort_keys f32 NaN/-0.0/negatives n=2**22",
         keys_only(np.float32, 1 << 22, specials=True)),
        ("sort_pairs u64+u64 n=2**24", pairs(np.uint64, 1 << 24)),
        ("sort_keys u32 n=160,000,000 (reference main.cpp:105)",
         keys_only(np.uint32, 160_000_000)),
        ("sort_pairs f64+u32 descending NaN/-0.0 n=2**20",
         pairs(np.float64, 1 << 20, specials=True, order="descending")),
        ("sort_pairs u32+u32 window [8,16) n=2**22",
         pairs(np.uint32, 1 << 22, start_bit=8, end_bit=16)),
        ("sort_indices i32 n=2**22", indices(np.int32, 1 << 22)),
    ]


def phase_main_path() -> int:
    rng = np.random.default_rng(SEED)
    be.KERNEL_LAUNCHES = 0
    for label, run in main_path_cases():
        before = be.KERNEL_LAUNCHES
        secs, check = run(rng)
        launches = be.KERNEL_LAUNCHES - before
        ok = check()
        log("4 main-path", f"{label}: {secs * 1e3:.3f} ms (host clock, "
            f"synchronized) launches={launches} "
            f"{'bit-exact' if ok else 'MISMATCH'} vs numpy oracle")
        torch.cuda.empty_cache()
        if not ok:
            raise AssertionError(f"main path output wrong: {label}")
        if launches == 0:
            raise AssertionError(f"main path did not launch the kernel: {label}")
    return be.KERNEL_LAUNCHES


# ---------------------------------------------------------------------------
# phase 5: timing
# ---------------------------------------------------------------------------


def fresh_runs(src: list, fn, reps: int) -> tuple[float, list]:
    """Median device ms of ``fn(words)`` over ``reps`` runs after a warm-up
    run, each on a fresh copy of ``src`` made outside the timed events;
    also the words the warm-up run left."""
    buf = [w.clone() for w in src]
    first, times = None, []
    for rep in range(reps + 1):
        for b, w in zip(buf, src):
            b.copy_(w)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(buf)
        end.record()
        torch.cuda.synchronize()
        if rep == 0:
            first = [b.clone() for b in buf]
        else:
            times.append(start.elapsed_time(end))
    return statistics.median(times), first


def phase_timing(x: torch.Tensor, card: str) -> tuple[float, float, float, int]:
    n = x.shape[0]
    sort_ms = cuda_ms(lambda: thrs.sort_keys(x), 5)
    # int32 with the sign bit flipped orders as the unsigned keys do
    signed = x.view(torch.int32) ^ -2**31
    yard_ms = cuda_ms(lambda: torch.sort(signed, stable=True), 5)
    del signed
    log("5 timing", f"sort_keys u32 n=2**28: {sort_ms:.3f} ms "
        f"({n / sort_ms / 1e6:.4f} Gkeys/s); torch.sort(stable=True) on the "
        f"same keys: {yard_ms:.3f} ms ({n / yard_ms / 1e6:.4f} Gkeys/s); "
        f"median of 5, CUDA events; card: {card}")
    # one sweep at the main path's shape: the first local sweep of the
    # 2**28 one-word network, on the random keys (each run on a fresh copy)
    sweep = _plan(28, 1, be.EngineTuning())[0]
    src = [x.view(torch.int32)]
    kernel_ms, got = fresh_runs(src, lambda w: be.run_sweep(w, sweep, 1), 5)
    plain_ms, want = fresh_runs(
        src, lambda w: be.run_sweep_reference(w, sweep, 1), 3)
    err = int((be.unsigned(got[0]) - be.unsigned(want[0])).abs().max())
    ok = torch.equal(got[0], want[0])
    log("5 timing", f"one sweep (c={sweep.c} g={sweep.g}, "
        f"{len(sweep.substages)} substages) on 2**28 random words: kernel "
        f"{kernel_ms:.3f} ms (median of 5), plain version {plain_ms:.3f} ms "
        f"(median of 3), max_abs_err={err} "
        f"{'bit-equal' if ok else 'MISMATCH'}; card: {card}")
    if not ok:
        raise AssertionError("kernel != plain version on the 2**28 sweep")
    return kernel_ms, plain_ms, sort_ms, err


def phase_breakdown(x: torch.Tensor, sort_ms: float, card: str) -> None:
    """Device time of each sweep of the 2**28 one-word network (the sort_keys
    u32 bench workload): CUDA events between the launches, median of 3
    passes after a warm-up pass, each pass on a fresh copy of the random
    keys."""
    plan = _plan(28, 1, be.EngineTuning())
    src = x.view(torch.int32)
    buf = src.clone()
    passes = []
    for rep in range(4):
        buf.copy_(src)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(plan) + 1)]
        ev[0].record()
        for sweep, e in zip(plan, ev[1:]):
            be.run_sweep([buf], sweep, 1)
            e.record()
        torch.cuda.synchronize()
        if rep:
            passes.append([a.elapsed_time(b) for a, b in zip(ev, ev[1:])])
    del buf
    med = [statistics.median(col) for col in zip(*passes)]
    moved = 2 * 4 * src.shape[0]  # bytes a sweep reads and writes
    for i, (sweep, ms) in enumerate(zip(plan, med)):
        log("6 breakdown", f"sweep {i}: c={sweep.c} g={sweep.g} "
            f"j_lo={sweep.j_lo} substages={len(sweep.substages)} "
            f"k={sweep.substages[0][0]} {ms:.3f} ms "
            f"{moved / ms / 1e9:.4f} TB/s")
    total = sum(med)
    groups = {"first local": [0],
              "later local": [i for i, s in enumerate(plan) if s.g == 0][1:],
              "cross": [i for i, s in enumerate(plan) if s.g > 0]}
    for name, idx in groups.items():
        ms = sum(med[i] for i in idx)
        log("6 breakdown", f"{name}: {len(idx)} sweeps, "
            f"{sum(len(plan[i].substages) for i in idx)} substages, "
            f"{ms:.3f} ms ({min(med[i] for i in idx):.3f}-"
            f"{max(med[i] for i in idx):.3f} each), {100 * ms / total:.1f}%")
    log("6 breakdown", f"all {len(plan)} sweeps: {total:.3f} ms, "
        f"{100 * total / sort_ms:.1f}% of the sort_keys median "
        f"({sort_ms:.3f} ms); best sweep {moved / min(med) / 1e9:.4f} TB/s; "
        f"median of 3, CUDA events; card: {card}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    card = card_line()
    log("1 device", f"{torch.cuda.get_device_name(0)} "
        f"(sm_{''.join(map(str, torch.cuda.get_device_capability(0)))}), "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(card, flush=True)

    t0 = time.perf_counter()
    cuda_lib.load("bitonic_sweep")
    info = cuda_lib.BUILD_INFO["bitonic_sweep"]
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    log("2 build", f"{time.perf_counter() - t0:.3f} s (nvcc "
        f"{info['seconds']:.3f} s) -> {info['path']}; " + " | ".join(ptxas))

    t0 = time.perf_counter()
    worst = phase_sweeps()
    log("3 kernel-vs-plain", f"all sweeps bit-equal in "
        f"{time.perf_counter() - t0:.3f} s, max_abs_err={worst}")

    t0 = time.perf_counter()
    launches = phase_main_path()
    log("4 main-path", f"all cases bit-exact in "
        f"{time.perf_counter() - t0:.3f} s, kernel launches={launches}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    x = torch.randint(-2**31, 2**31, (1 << 28,), generator=gen, device="cuda",
                      dtype=torch.int64).to(torch.int32).view(torch.uint32)
    kernel_ms, plain_ms, sort_ms, err = phase_timing(x, card)
    worst = max(worst, err)
    phase_breakdown(x, sort_ms, card)
    del x
    log("done", f"{time.perf_counter() - t_all:.3f} s in all")
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "bitonic_sweep", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": worst,
        "ms": kernel_ms, "plain_ms": plain_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
