#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tinyhipradixsort_torch) on one NVIDIA GPU.

Run from the root of the repository, on a machine with a Hopper card
(sm_90a), the CUDA toolkit and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases, one output line each (time, kernel launches, result):

1. device: the card's name and power limit (nvidia-smi);
2. build: the four kernels (bitonic sweep, digit histogram, gather floor,
   partition scatter), one nvcc each, all started together, from csrc/ into
   the ignored _build/, with each one's nvcc time and, for each kernel
   function (each word count of the sweep's register body), ptxas registers
   and spill bytes (kept beside a reused library); the main path's 1-, 3-
   and 5-word instantiations are required to spill nothing;
3. kernel vs plain: sweeps of 1, 2, 3, 4, 5, 8 and 12 words (local, cross,
   forced ascending) on 2**20 random words, the cross sweeps over the top
   index bits of the 2**28 and 2**31 one-word and 2**24 three-word
   networks, the row paths' sweeps (stage r forced ascending, on
   b_pad * 2**r words, tiles spanning several rows or lying inside one) and
   the merges' sweeps of stage log2 m alone (2**31 words for the u32Large
   bench's merge), through the CUDA kernel and through
   ``run_sweep_reference``, required bit-equal;
4. main path: the public entry points at real sizes (sort_keys u32 at 2**28,
   the bench workload; pairs at 2**24 and 2**16; f32 with NaN and -0.0;
   u64 pairs; u32 keys and u32+u32 pairs at 160,000,000 through the
   segmented route; a descending, a bit-window and a sort_indices case;
   2-D rows 4096x4096 keys, 16384x1024 pairs, 4096x1040 keys (padded
   rows) and 64x640000 keys (the row-segmented route);
   segment_ids= of 1000 segments on 2**24 pairs; f16 and bf16 keys with
   NaN payloads and -0.0; stable=False pairs at 2**24, which must sort 2
   words), each bit-exact against a numpy oracle on the host, each
   required to launch the kernel and to take its route (read at the
   engine's MARK hook);
5. timing: sort_keys u32 at 2**28 (CUDA events, median of 5 after a
   warm-up) beside torch.sort(stable=True) as the yardstick, and the first
   sweep of its network through the kernel beside its plain version, each
   run on a fresh copy of the random keys and required bit-equal;
   sort_pairs u32+u32 and u64+u64 at 2**24; 160,000,000 u32 keys through
   the segmented and the padded route beside torch.sort; the three row
   cells beside torch.sort(dim=-1) and the counting engine, and both row
   routes on eleven non-power-of-two row shapes from 4096x1040 to
   16x12,500,000 (``phase_row_routes``); stable=False beside stable=True
   pairs at 2**24;
6. breakdown: the device time of each of that network's sweeps, of the
   two pairs sorts' sweeps by group, and of the 160M segmented sort by
   part (prefix network, recursive remainder, dense compare-exchange
   levels, merge sweeps, the rest);
7. histogram kernel vs plain: ``digit_histogram`` through the kernel and
   through ``digit_histogram_reference`` (u32 at 2**20 and 2**28, shifts
   0/8/16/24, tiles 8192 and 2048, widths 1, 2, 5 and 12, an odd tile, an n
   that is no tile multiple, u64 with shift 40), required bit-equal;
8. portable path: the public entry points with method="counting" (u32 at
   160,000,000, pairs, f32 and f16/bf16 specials, u64 pairs, a window,
   descending f64, 2-D rows 4096x4096), "argsort" and "lsd_argsort"
   (pairs), and segment_ids= from segment_ids_from_offsets, each bit-exact
   against the numpy oracle, each counting case required to launch the
   histogram kernel;
9. probes: the gather-floor and partition-scatter probes through their
   tool entry points, each kernel required equal to its plain version;
10. timing of the new kernels and engine: the histogram at 2**28 beside its
   plain version, torch.bincount and its bound; counting sort_keys u32 at
   2**28 beside torch.sort and the bitonic sort_keys, with its per-stage
   breakdown;
11. the distributed sort on a one-rank NCCL group (NCCL allows one rank per
   card): psort_keys ascending, descending and with the two-word index
   (_force_wide), psort_pairs with a u32 payload, psort_indices with both
   index widths and a donated psort_keys, of 2**28 u32 keys drawn as
   np.minimum(zipf(1.3), 2**31), and the dry run (parallel.dryrun) at
   world size 1; each output bit-exact against the host oracle
   (utils.native_oracle, numpy where it does not build; the line says
   which), the keys-only calls required to carry the key word alone in
   the ring (psort.WIRE), the calls required to launch the sweep kernel,
   each timed beside sort_keys/sort_pairs/sort_indices of the same keys,
   the donated call's peak memory required no higher than the plain
   call's; then rank 0's local work at the shapes of an 8-rank group with
   B = 2**28 per rank (the capacities from psort's own arithmetic): the
   local sort of B tuples, the binary-counter merges of 8 sentinel-padded
   runs of length cap, and the rebalance merge of a kept run with 8 pieces
   of length cap3, on (key, index) tuples and on the key word alone, each
   timed and bit-equal to a stable torch.sort lexsort of the same words,
   each merge's route read at the engine's MARK hook;
12. the MSB-partition front-end (ops/partition_engine.py) at
   partition_bits=8 against the direct network: sort_pairs u32+u32 and
   sort_keys u32 of 2**28 uniform keys (route "partition") and sort_keys
   of 2**28 zipf(1.3) keys (route "partition-fallback"), each bit-exact
   against the host oracle, timed (median of 5, CUDA events) and broken
   down by step at MARK;
13. the harness layer in process, on phase 11's group: the bench
   (``tinyhipradixsort_torch.bench``) at 2**28 and at the reference's
   u32Large n = 2**31 + 100 (unittest.cpp:688-717), each with --verify full
   (bit-exact against the host oracle) and its JSON line, its routes at
   MARK (padded at 2**28, segmented at u32Large), peak device memory, the
   oracle's time and the process's peak host memory, the host's memory
   printed before the u32Large step; the matrix (``benchmarks.full``) at 1M, 16M and 256M
   beside torch.sort; ``tools.verify_baseline`` (2**28 u64+u64 pairs);
   ``tools.nonpow2_sweep --big`` (each case exact and on its route);
   ``tools.drive --iters 8``; the three examples (soak with --iters 2);
   ``entry``; ``benchmarks.scaling`` at world size 1; and
   ``tools.baseline_scale``. Each step raises on a failure.

The line before the last is the kernel report, {"kernels": [...]}; the last
line is {"ok": true, "device": {...}}. Any failure raises and exits non-zero
without a result; so does a machine without CUDA. ``timing_only()`` runs
phases 5 and 6 alone (see there).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import resource
import socket
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# the run uses one card: the first, unless the caller chose one
os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch.distributed as dist  # noqa: E402

import tinyhipradixsort_torch as thrs  # noqa: E402
from tinyhipradixsort_torch import keybits  # noqa: E402
from tinyhipradixsort_torch.ops import bitonic_engine as be  # noqa: E402
from tinyhipradixsort_torch.ops import counting_engine  # noqa: E402
from tinyhipradixsort_torch.ops import cuda_lib  # noqa: E402
from tinyhipradixsort_torch.ops import histogram as hist  # noqa: E402
from tinyhipradixsort_torch.ops import network_engine  # noqa: E402
from tinyhipradixsort_torch.parallel import dryrun  # noqa: E402
from tinyhipradixsort_torch.parallel import multihost  # noqa: E402
from tinyhipradixsort_torch.parallel import psort  # noqa: E402
from tinyhipradixsort_torch.tools import H100_BYTES_PER_S  # noqa: E402
from tinyhipradixsort_torch.tools import card as card_line  # noqa: E402
from tinyhipradixsort_torch.tools import cuda_ms  # noqa: E402
from tinyhipradixsort_torch.tools import gather_floor as gf  # noqa: E402
from tinyhipradixsort_torch.tools import partition_dma_floor as pdf  # noqa: E402
from tinyhipradixsort_torch.utils import native_oracle  # noqa: E402

SEED = 20260
#: kernel (its source is csrc/<name>.cu) -> the TPU kernel it replaces
KERNELS = {
    "bitonic_sweep": "tinyhipradixsort_tpu/ops/bitonic_engine.py:267",
    "digit_histogram": "tinyhipradixsort_tpu/ops/histogram.py:38",
    "gather_floor": "tools/gather_floor.py:43",
    "partition_scatter": "tools/partition_dma_floor.py:43",
}
# 32-bit integer operations (compare, min/max, logic, add) outside the
# tensor cores: they issue at 64 lanes per SM on the H100 SXM, so
# 132 SMs x 64 lanes x 1.98 GHz (boost clock) = 16.7e12 a second. (67e12 is
# the float32 rate counted as two FLOPs per fused multiply-add; it does not
# apply to integer work.)
INT_OPS_PER_S = 132 * 64 * 1.98e9


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


# ---------------------------------------------------------------------------
# phase 3: the kernel against its plain version
# ---------------------------------------------------------------------------


def _plan(L: int, nwords: int, tuning: be.EngineTuning) -> list:
    """The sweep plan the main path runs for 2**L elements of nwords words."""
    T = be._tile_bits_for(nwords, L, tuning)
    return be.plan_sweeps(L, T, T, g_max_cross=tuning.cross_g_max)


def sweep_cases(tuning: be.EngineTuning):
    """(label, L, ncmp, nwords, sweep).

    At L=20, for 1, 2, 3, 4, 5 and 8 words (the register body, one
    instantiation each for the main path's 1, 3 and 5) and 12 words (the
    shared-memory body): the first local sweep, a later local
    sweep, the widest and the narrowest cross sweep, and forced-ascending
    variants. Then the cross sweeps of the main path's own plans that reach
    the top index bits (1 word at L=28, the bench workload; 1 word at L=31,
    the 2**31 prefix of the bench's u32Large n = 2**31 + 100; 3 words at
    L=24, the pairs case): the last stage's top sweep, and the widest and
    narrowest sweeps of the stage below it, whose direction bit is the top
    index bit.
    """
    cases = []
    L = 20
    for nwords, ncmp in ((1, 1), (2, 2), (3, 3), (4, 2), (5, 3), (8, 3),
                         (12, 3)):
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
    for L, nwords in ((28, 1), (31, 1), (24, 3)):
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


def row_sweep_cases(tuning: be.EngineTuning):
    """(label, word length, ncmp, nwords, sweep): the sweeps of the row paths
    and of the merges. Rows: stages 1..r, stage r forced ascending, on
    ``b_pad * 2**r`` words (no power of two), for rows of 2**7 one-word
    tuples and 2**10 three-word tuples (tiles spanning 8 rows each) and 3
    rows of 2**16 (tiles inside a row, so cross sweeps); and the same rows'
    merges, stage r alone. Flat merges: stage log2 m alone of the 2**27
    one-word prefix, of the 2**31 one (the u32Large bench's virtual-sentinel
    merge, ``_merge_sorted_runs``) and of a 2**24 three-word one
    (``_merge_pow2``), its widest cross sweep and its local sweep."""
    cases = []
    for B, r, nwords, ncmp in ((5000, 7, 1, 1), (3000, 10, 3, 2),
                               (3, 16, 1, 1)):
        T, b_pad = be._row_plan(B, r, nwords, tuning)
        for kind, stages in (("sort", range(1, r + 1)), ("merge", [r])):
            plan = be.plan_sweeps(max(T, r), T, T, stages, r,
                                  g_max_cross=tuning.cross_g_max)
            cross = [s for s in plan if s.g > 0]
            picks = {plan[0]: "first", plan[-1]: "last"}
            if cross:
                picks.setdefault(max(cross, key=lambda s: s.g),
                                 "cross-widest")
            for s, name in picks.items():
                cases.append((f"rows {B}x2**{r} {nwords}w (tile 2**{T}, "
                              f"b_pad {b_pad})/{kind}/{name}", b_pad << r,
                              ncmp, nwords, s))
    for m_bits, nwords, ncmp in ((27, 1, 1), (31, 1, 1), (24, 3, 2)):
        T = be._tile_bits_for(nwords, m_bits, tuning)
        plan = be.plan_sweeps(m_bits, T, T, [m_bits],
                              g_max_cross=tuning.cross_g_max)
        for name, s in (("cross-widest", max(plan, key=lambda s: s.g)),
                        ("local", plan[-1])):
            cases.append((f"merge 2**{m_bits} {nwords}w/{name}", 1 << m_bits,
                          ncmp, nwords, s))
    return cases


def max_abs_err(got: list, want: list) -> int:
    """The largest difference of two word lists as unsigned values, in
    chunks of 2**26 (the int64 widening of a 2**31-word buffer would take
    16 GiB)."""
    step = 1 << 26
    return max(int((be.unsigned(a[i:i + step]) - be.unsigned(b[i:i + step]))
                   .abs().max())
               for a, b in zip(got, want) for i in range(0, a.shape[0], step))


def phase_sweeps() -> int:
    tuning = be.EngineTuning()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    worst = 0
    cases = [(label, 1 << L, ncmp, nwords, sweep)
             for label, L, ncmp, nwords, sweep in sweep_cases(tuning)]
    for label, n, ncmp, nwords, sweep in cases + row_sweep_cases(tuning):
        words = random_words(nwords, n, gen)
        t0 = time.perf_counter()
        got = be.run_sweep([w.clone() for w in words], sweep, ncmp)
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t0
        # the plain version sweeps the inputs themselves: at 2**31 words
        # a third copy would crowd the card
        want = be.run_sweep_reference(words, sweep, ncmp)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
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


_UNSIGNED = {2: np.uint16, 4: np.uint32, 8: np.uint64}


def _bits_view(a: np.ndarray) -> np.ndarray:
    return a.view(_UNSIGNED[a.dtype.itemsize])


def oracle_bits(keys: np.ndarray, descending: bool, kind=None) -> np.ndarray:
    """The radix sort's total order as unsigned numpy bits, written out here
    so that the oracle does not rest on the port: signed ints flip the sign
    bit; floats flip every bit of negatives and the sign bit of the rest,
    after -0.0 is made +0.0 (so the two zeros tie and keep input order);
    descending complements. ``kind`` overrides the dtype's kind (bfloat16
    keys come as their raw uint16 patterns with kind "f")."""
    width = keys.dtype.itemsize * 8
    kind = kind or keys.dtype.kind
    u = keys.view(_UNSIGNED[keys.dtype.itemsize])
    top = u.dtype.type(1 << (width - 1))
    if kind == "i":
        u = u ^ top
    elif kind == "f":
        u = np.where(u == top, u.dtype.type(0), u)
        u = np.where((u & top) != 0, ~u, u | top)
    return ~u if descending else u


def _perm(keys: np.ndarray, descending=False, start_bit=0, end_bit=None,
          kind=None):
    bits = oracle_bits(keys, descending, kind)
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

    def rows(B, n, with_values=False):
        def run(rng):
            x = rng.integers(0, 2**32, size=(B, n), dtype=np.uint32)
            v = rng.integers(0, 2**32, size=(B, n), dtype=np.uint32)
            xd, vd = torch.from_numpy(x).cuda(), torch.from_numpy(v).cuda()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = (thrs.sort_pairs(xd, vd) if with_values
                   else (thrs.sort_keys(xd),))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got = [o.cpu().numpy() for o in out]
            del xd, vd, out

            def check():
                p = np.argsort(x, axis=1, kind="stable")
                ok = np.array_equal(got[0], np.take_along_axis(x, p, 1))
                return ok and (not with_values or np.array_equal(
                    got[1], np.take_along_axis(v, p, 1)))
            return secs, check
        return run

    def segments(n, nseg):
        def run(rng):
            x = rng.integers(0, 2**32, size=n, dtype=np.uint32)
            v = rng.integers(0, 2**32, size=n, dtype=np.uint32)
            offs = np.sort(rng.integers(0, n, size=nseg)).astype(np.int32)
            xd, vd = torch.from_numpy(x).cuda(), torch.from_numpy(v).cuda()
            seg = thrs.segment_ids_from_offsets(torch.from_numpy(offs).cuda(),
                                                n)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            k, vals = thrs.sort_pairs(xd, vd, segment_ids=seg)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            gk, gv, sid = k.cpu().numpy(), vals.cpu().numpy(), seg.cpu().numpy()
            del xd, vd, seg, k, vals

            def check():
                want = np.searchsorted(offs, np.arange(n), side="right") - \
                    np.searchsorted(offs, 0, side="right")
                p = np.lexsort((x, want))
                return (np.array_equal(sid, want) and np.array_equal(gk, x[p])
                        and np.array_equal(gv, v[p]))
            return secs, check
        return run

    def keys16(tdtype, n):
        def run(rng):
            u = _raw16(rng, n)
            xd = torch.from_numpy(u.view(np.int16)).cuda().view(tdtype)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = thrs.sort_keys(xd)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got = out.view(torch.int16).cpu().numpy().view(np.uint16)
            del xd, out
            return secs, lambda: np.array_equal(got, u[_perm(u, kind="f")])
        return run

    def unstable_pairs(n):
        def run(rng):
            x = rng.integers(0, 1 << 16, size=n, dtype=np.uint32)  # ties
            v = np.arange(n, dtype=np.uint32)
            xd, vd = torch.from_numpy(x).cuda(), torch.from_numpy(v).cuda()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            k, vals = thrs.sort_pairs(xd, vd, stable=False)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            gk, gv = k.cpu().numpy(), vals.cpu().numpy()
            del xd, vd, k, vals

            def check():
                # keys in order; the payloads a permutation that carries
                # each key (v is the index, so x[gv] must be the keys)
                return (np.array_equal(gk, np.sort(x))
                        and np.array_equal(np.sort(gv), v)
                        and np.array_equal(x[gv], gk))
            return secs, check
        return run

    # (label, run, the engine route the case must take, the words sorted)
    return [
        ("sort_keys u32 n=2**28 (bench workload)",
         keys_only(np.uint32, 1 << 28), "padded", None),
        ("sort_pairs u32+u32 n=2**24", pairs(np.uint32, 1 << 24),
         "padded", None),
        ("sort_pairs u32+u32 n=2**16 (graft entry)", pairs(np.uint32, 1 << 16),
         "padded", None),
        ("sort_keys f32 NaN/-0.0/negatives n=2**22",
         keys_only(np.float32, 1 << 22, specials=True), "padded", None),
        ("sort_pairs u64+u64 n=2**24", pairs(np.uint64, 1 << 24),
         "padded", None),
        ("sort_keys u32 n=160,000,000 (reference main.cpp:105)",
         keys_only(np.uint32, 160_000_000), "segmented", None),
        ("sort_pairs u32+u32 n=160,000,000",
         pairs(np.uint32, 160_000_000), "segmented", None),
        ("sort_pairs f64+u32 descending NaN/-0.0 n=2**20",
         pairs(np.float64, 1 << 20, specials=True, order="descending"),
         "padded", None),
        ("sort_pairs u32+u32 window [8,16) n=2**22",
         pairs(np.uint32, 1 << 22, start_bit=8, end_bit=16), "padded", None),
        ("sort_indices i32 n=2**22", indices(np.int32, 1 << 22),
         "padded", None),
        ("sort_keys u32 rows 4096x4096", rows(4096, 4096), "rows", None),
        ("sort_pairs u32+u32 rows 16384x1024", rows(16384, 1024, True),
         "rows", None),
        ("sort_keys u32 rows 4096x1040 (non-power-of-two rows, a batch "
         "below the row-segmented floor)", rows(4096, 1040), "rows", None),
        ("sort_keys u32 rows 64x640000 (non-power-of-two rows, 2**26 "
         "padded)", rows(64, 640_000), "rows-segmented", None),
        ("sort_pairs u32+u32 segment_ids_from_offsets (1000 segments) "
         "n=2**24", segments(1 << 24, 1000), "padded", 4),
        ("sort_keys f16 NaN payloads/-0.0 n=2**22",
         keys16(torch.float16, 1 << 22), "padded", None),
        ("sort_keys bf16 NaN payloads/-0.0 n=2**22",
         keys16(torch.bfloat16, 1 << 22), "padded", None),
        ("sort_pairs u32+u32 stable=False n=2**24", unstable_pairs(1 << 24),
         "padded", 2),
    ]


def phase_main_path() -> int:
    rng = np.random.default_rng(SEED)
    be.KERNEL_LAUNCHES = 0
    for label, run, route, nwords in main_path_cases():
        before = be.KERNEL_LAUNCHES
        # the engine's routing decisions: the first is the sort's own route
        # (and the words it sorts); later ones are its pieces'
        routes = []
        be.MARK = lambda event, name, words: (
            routes.append((name, len(words))) if event == "route" else None)
        try:
            secs, check = run(rng)
        finally:
            be.MARK = None
        launches = be.KERNEL_LAUNCHES - before
        ok = check()
        took, moved = routes[0]
        log("4 main-path", f"{label}: {secs * 1e3:.3f} ms (host clock, "
            f"synchronized) launches={launches} route={took} words={moved} "
            f"{'bit-exact' if ok else 'MISMATCH'} vs numpy oracle")
        torch.cuda.empty_cache()
        if not ok:
            raise AssertionError(f"main path output wrong: {label}")
        if launches == 0:
            raise AssertionError(f"main path did not launch the kernel: {label}")
        if took != route:
            raise AssertionError(f"{label}: took the {took} route, not {route}")
        if nwords is not None and moved != nwords:
            raise AssertionError(f"{label}: sorted {moved} words, not {nwords}")
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


def sweep_times(fn, reps: int = 3) -> tuple[list, list]:
    """The sweeps that ``fn()`` launches and the device ms of each: CUDA
    events around every ``run_sweep`` call of the network (which calls it
    through the module), median of ``reps`` passes after a warm-up pass."""
    real, sweeps, passes = be.run_sweep, [], []
    for rep in range(reps + 1):
        events = []

        def timed(words, sweep, ncmp):
            if not events:
                events.append(torch.cuda.Event(enable_timing=True))
                events[0].record()
            out = real(words, sweep, ncmp)
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
            if rep == 0:
                sweeps.append(sweep)
            return out

        be.run_sweep = timed
        try:
            fn()
        finally:
            be.run_sweep = real
        torch.cuda.synchronize()
        if rep:
            passes.append([a.elapsed_time(b) for a, b in zip(events, events[1:])])
    return sweeps, [statistics.median(col) for col in zip(*passes)]


def phase_pairs(card: str) -> None:
    """sort_pairs u32+u32 (3 words) and u64+u64 (5 words) at 2**24, the
    main path's pairs cases: the sort's median (phase 5) and its sweeps'
    device time by group (phase 6)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 5)
    n = 1 << 24
    for label, dtype, unsigned in (("u32+u32", torch.int32, torch.uint32),
                                   ("u64+u64", torch.int64, torch.uint64)):
        info = torch.iinfo(dtype)
        keys, vals = (torch.randint(info.min, info.max, (n,), generator=gen,
                                    device="cuda", dtype=dtype).view(unsigned)
                      for _ in range(2))
        sort_ms = cuda_ms(lambda: thrs.sort_pairs(keys, vals), 5)
        log("5 timing", f"sort_pairs {label} n=2**24: {sort_ms:.3f} ms "
            f"({n / sort_ms / 1e6:.4f} Gpairs/s); median of 5, CUDA events; "
            f"card: {card}")
        sweeps, med = sweep_times(lambda: thrs.sort_pairs(keys, vals))
        groups = {"first local": [0],
                  "later local": [i for i, s in enumerate(sweeps)
                                  if s.g == 0][1:],
                  "cross": [i for i, s in enumerate(sweeps) if s.g > 0]}
        for name, idx in groups.items():
            log("6 breakdown", f"sort_pairs {label} n=2**24 {name}: "
                f"{len(idx)} sweeps, "
                f"{sum(len(sweeps[i].substages) for i in idx)} substages, "
                f"{sum(med[i] for i in idx):.3f} ms")
        log("6 breakdown", f"sort_pairs {label} n=2**24 all {len(sweeps)} "
            f"sweeps (tile 2**{sweeps[0].c + sweeps[0].g}): {sum(med):.3f} ms,"
            f" {100 * sum(med) / sort_ms:.1f}% of the sort_pairs median; "
            f"median of 3, CUDA events; card: {card}")
        del keys, vals
        torch.cuda.empty_cache()


def _random_u32(n, gen: torch.Generator, shape=None) -> torch.Tensor:
    """n random u32 keys on the card (shaped ``shape`` if given)."""
    x = torch.randint(-2**31, 2**31, (n,), generator=gen, device="cuda",
                      dtype=torch.int64).to(torch.int32).view(torch.uint32)
    return x if shape is None else x.view(shape)


def _flipped(x: torch.Tensor) -> torch.Tensor:
    """int32 with the sign bit flipped: orders as the unsigned keys do."""
    return x.view(torch.int32) ^ -2**31


def _sort_keys_tuned(x: torch.Tensor, tuning: be.EngineTuning):
    """sort_keys of u32 keys (1-D, or 2-D rows) through the engine with
    ``tuning`` (the public API reads the THRS_* knobs instead)."""
    return network_engine.sort_semantics(
        x, [], descending=False, start_bit=0, end_bit=32, want=("keys",),
        tuning=tuning)[0]


def phase_nonpow2_timing(card: str) -> tuple[torch.Tensor, float]:
    """160,000,000 u32 keys (reference main.cpp:105) through the segmented
    route (the default tuning), the padded route (seg_pad_waste=1.0) and
    torch.sort(stable=True). The sort never writes its input, so every run
    sorts the same untouched keys."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 160)
    n = 160_000_000
    x = _random_u32(n, gen)
    seg_t, pad_t = be.EngineTuning(), be.EngineTuning(seg_pad_waste=1.0)
    seg_ms = cuda_ms(lambda: _sort_keys_tuned(x, seg_t), 5)
    pad_ms = cuda_ms(lambda: _sort_keys_tuned(x, pad_t), 5)
    signed = _flipped(x)
    yard_ms = cuda_ms(lambda: torch.sort(signed, stable=True), 5)
    same = torch.equal(_sort_keys_tuned(x, seg_t), _sort_keys_tuned(x, pad_t))
    del signed
    torch.cuda.empty_cache()
    log("5 timing", f"sort_keys u32 n=160,000,000: segmented route "
        f"{seg_ms:.3f} ms ({n / seg_ms / 1e6:.4f} Gkeys/s), padded route "
        f"(seg_pad_waste=1.0, 2**28) {pad_ms:.3f} ms, torch.sort(stable=True)"
        f" {yard_ms:.3f} ms; routes {'bit-equal' if same else 'MISMATCH'}; "
        f"median of 5, CUDA events; card: {card}")
    if not same:
        raise AssertionError("segmented and padded routes disagree at 160M")
    # around the routing threshold (seg_pad_waste=0.15): both routes at n
    # that pad 2**28 with a waste of 5-25%
    seg_all = be.EngineTuning(seg_pad_waste=0.0)
    for waste in (0.05, 0.10, 0.15, 0.20, 0.25):
        m = int((1 << 28) * (1.0 - waste))
        y = _random_u32(m, gen)
        s_ms = cuda_ms(lambda: _sort_keys_tuned(y, seg_all), 5)
        p_ms = cuda_ms(lambda: _sort_keys_tuned(y, pad_t), 5)
        log("5 timing", f"sort_keys u32 n={m} (waste {waste:.2f} of 2**28): "
            f"segmented {s_ms:.3f} ms, padded {p_ms:.3f} ms "
            f"({p_ms / s_ms:.3f}x); median of 5, CUDA events; card: {card}")
        del y
        torch.cuda.empty_cache()
    return x, seg_ms


def phase_rows_timing(card: str) -> None:
    """The row cells beside torch.sort(dim=-1, stable=True) (with a gather
    of the values for pairs) and the counting engine; then both row routes
    from short rows to long ones."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 4096)
    for B, n, with_values in ((4096, 4096, False), (16384, 1024, True),
                              (4096, 1040, False)):
        x = _random_u32(B * n, gen, (B, n))
        v = _random_u32(B * n, gen, (B, n))
        signed = _flipped(x)
        if with_values:
            ms = cuda_ms(lambda: thrs.sort_pairs(x, v), 5)
            count_ms = cuda_ms(
                lambda: thrs.sort_pairs(x, v, method="counting"), 5)

            def library():
                _, idx = torch.sort(signed, dim=-1, stable=True)
                return torch.take_along_dim(v, idx, dim=-1)
        else:
            ms = cuda_ms(lambda: thrs.sort_keys(x), 5)
            count_ms = cuda_ms(lambda: thrs.sort_keys(x, method="counting"), 5)

            def library():
                return torch.sort(signed, dim=-1, stable=True)
        lib_ms = cuda_ms(library, 5)
        what = "sort_pairs u32+u32" if with_values else "sort_keys u32"
        log("5 timing", f"{what} rows {B}x{n}: bitonic {ms:.3f} ms "
            f"({B * n / ms / 1e6:.4f} Gkeys/s), torch.sort(dim=-1, "
            f"stable=True){' + take_along_dim' if with_values else ''} "
            f"{lib_ms:.3f} ms, counting {count_ms:.3f} ms; median of 5, CUDA "
            f"events; card: {card}")
        del x, v, signed
        torch.cuda.empty_cache()
    phase_row_routes(card)


#: (B, n) of phase 5's row-route comparison: about 40% padding from short
#: rows to long ones and from 2**23 to 2**28 padded elements, and one shape
#: just above the 0.24 waste threshold
ROW_ROUTE_SHAPES = ((4096, 1040), (1024, 10_000), (64, 160_000),
                    (4, 2_500_000), (2, 10_000_000), (4, 10_000_000),
                    (64, 640_000), (8, 10_000_000), (16, 10_000_000),
                    (128, 1_250_000), (16, 12_500_000))


def phase_row_routes(card: str) -> None:
    """Both row routes on the shapes of :data:`ROW_ROUTE_SHAPES`: the
    padded row network and the row-segmented route at the JAX package's
    row_seg_waste=0.24 (its Hopper batch floor, ``_ROW_SEG_MIN_PADDED``,
    set from these shapes, lowered so that it runs at each), beside
    torch.sort(dim=-1, stable=True)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1040)
    pad_rows = be.EngineTuning(row_seg_waste=1.0)
    seg_rows = be.EngineTuning(row_seg_waste=0.24)
    # the route at every shape: its batch floor lowered for this phase
    floor = be._ROW_SEG_MIN_PADDED
    be._ROW_SEG_MIN_PADDED = 0
    try:
        for B, n in ROW_ROUTE_SHAPES:
            x = _random_u32(B * n, gen, (B, n))
            pad_ms = cuda_ms(lambda: _sort_keys_tuned(x, pad_rows), 5)
            seg_ms = cuda_ms(lambda: _sort_keys_tuned(x, seg_rows), 5)
            signed = _flipped(x)
            lib_ms = cuda_ms(
                lambda: torch.sort(signed, dim=-1, stable=True), 5)
            same = torch.equal(_sort_keys_tuned(x, pad_rows),
                               _sort_keys_tuned(x, seg_rows))
            log("5 timing", f"sort_keys u32 rows {B}x{n} (waste "
                f"{1 - n / (1 << (n - 1).bit_length()):.3f}): padded rows "
                f"{pad_ms:.3f} ms, row-segmented (row_seg_waste=0.24) "
                f"{seg_ms:.3f} ms ({pad_ms / seg_ms:.3f}x), "
                f"torch.sort(dim=-1, stable=True) {lib_ms:.3f} ms; routes "
                f"{'bit-equal' if same else 'MISMATCH'}; median of 5, CUDA "
                f"events; card: {card}")
            del x, signed
            torch.cuda.empty_cache()
            if not same:
                raise AssertionError(f"row routes disagree at {B}x{n}")
    finally:
        be._ROW_SEG_MIN_PADDED = floor


def phase_unstable_timing(card: str) -> None:
    """sort_pairs u32+u32 at 2**24, stable=False (2 words) beside
    stable=True (3 words)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 24)
    n = 1 << 24
    keys, vals = _random_u32(n, gen), _random_u32(n, gen)
    fast = cuda_ms(lambda: thrs.sort_pairs(keys, vals, stable=False), 5)
    stable = cuda_ms(lambda: thrs.sort_pairs(keys, vals), 5)
    log("5 timing", f"sort_pairs u32+u32 n=2**24: stable=False {fast:.3f} ms,"
        f" stable=True {stable:.3f} ms ({stable / fast:.3f}x); median of 5, "
        f"CUDA events; card: {card}")
    del keys, vals
    torch.cuda.empty_cache()


def part_times(fn, what: str) -> tuple[list, float]:
    """Device time of each outermost part of ``fn()`` at the engine's
    ``MARK`` hook (CUDA events at its "begin" and "end"; parts nest, the
    outermost is the part) and of the whole call, median of 3 passes after
    a warm-up: ``([(name, elements, ms), ...], total_ms)``."""
    passes, sizes = [], []
    for rep in range(4):
        spans, depth = [], [0]

        def mark(event, name, words):
            if event == "begin":
                depth[0] += 1
                if depth[0] == 1:
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record()
                    spans.append([name, int(words[0].shape[0]), ev, None])
            elif event == "end":
                if depth[0] == 1:
                    spans[-1][3] = torch.cuda.Event(enable_timing=True)
                    spans[-1][3].record()
                depth[0] -= 1

        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        be.MARK = mark
        try:
            start.record()
            fn()
            end.record()
        finally:
            be.MARK = None
        torch.cuda.synchronize()
        if depth[0] != 0 or not spans:
            raise AssertionError(f"{what}: unbalanced or no parts")
        if rep:
            passes.append([a.elapsed_time(b) for _, _, a, b in spans]
                          + [start.elapsed_time(end)])
        else:
            sizes = [(name, n) for name, n, _, _ in spans]
    med = [statistics.median(col) for col in zip(*passes)]
    return [(name, n, ms) for (name, n), ms in zip(sizes, med)], med[-1]


def phase_segmented_breakdown(x: torch.Tensor, seg_ms: float,
                              card: str) -> None:
    """Device time of the 160M segmented sort_keys by part
    (:func:`part_times`: prefix network, recursive remainder, dense levels,
    merge sweeps); the rest (the first copy, the flip, the key transform,
    the concatenations and the sentinel blocks) is the sort's time less the
    parts'."""
    tuning = be.EngineTuning()
    parts, total = part_times(lambda: _sort_keys_tuned(x, tuning),
                              "160M segmented sort")
    by_part = {}
    for name, n, ms in parts:
        log("6 breakdown", f"160M segmented: {name} on {n} elements: "
            f"{ms:.3f} ms")
        by_part[name] = by_part.get(name, 0.0) + ms
    by_part["copies, flip, concatenations, key transform (the rest)"] = (
        total - sum(by_part.values()))
    for part, ms in by_part.items():
        log("6 breakdown", f"160M segmented: {part}: {ms:.3f} ms "
            f"({100 * ms / total:.1f}%)")
    log("6 breakdown", f"160M segmented: all {total:.3f} ms (phase 5's median"
        f" {seg_ms:.3f} ms); median of 3, CUDA events; card: {card}")


def bench_keys() -> torch.Tensor:
    """The 2**28 random u32 keys of the sort_keys bench workload."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    return (torch.randint(-2**31, 2**31, (1 << 28,), generator=gen,
                          device="cuda", dtype=torch.int64)
            .to(torch.int32).view(torch.uint32))


def timing_only() -> None:
    """Phases 5 and 6 alone, on the package beside this file. To time
    another tree's kernel with this script in one call (the parent commit,
    or a variant of the kernel), copy the script into that tree and run
    ``python3 -c 'import chip_smoke; chip_smoke.timing_only()'`` there."""
    card = card_line()
    print(card, flush=True)
    x = bench_keys()
    sort_ms = phase_timing(x, card)[2]
    phase_breakdown(x, sort_ms, card)
    del x
    torch.cuda.empty_cache()
    phase_pairs(card)


# ---------------------------------------------------------------------------
# phase 2: build every kernel, one nvcc each, all started together
# ---------------------------------------------------------------------------


def ptxas_report(text: str) -> list:
    """(kernel, registers, spills) for each entry function in the output
    of ``nvcc -Xptxas -v``; a template's word count is shown as <NW>."""
    rows, name, regs, spill = [], None, "", ""
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            if name:
                rows.append((name, regs, spill))
            mangled, regs, spill = m.group(1), "", ""
            m = re.match(r"_Z(\d+)(\w+)", mangled)
            name = m.group(2)[:int(m.group(1))] if m else mangled
            t = re.search(r"ILi(\d+)E", mangled)
            name += f"<{t.group(1)}>" if t else ""
        elif "spill" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln:
            regs = ln.split(":", 1)[-1].strip()
    if name:
        rows.append((name, regs, spill))
    return rows


#: the sweep kernel's register-body instantiations on the main path (u32
#: keys, u32 pairs, u64 pairs): ptxas must report no spill bytes for them
NO_SPILL = ("sweep_registers<1>", "sweep_registers<3>", "sweep_registers<5>")


def phase_build() -> None:
    t0 = time.perf_counter()
    cuda_lib.build(list(KERNELS))
    wall = time.perf_counter() - t0
    spills = {}
    for lib in KERNELS:
        cuda_lib.load(lib)
        info = cuda_lib.BUILD_INFO[lib]
        log("2 build", f"{lib}: nvcc {info['seconds']:.3f} s -> "
            f"{info['path']}")
        for name, regs, spill in ptxas_report(info["log"]):
            log("2 build", f"{lib}: {name}: {regs}; {spill}")
            spills[name] = spill
    log("2 build", f"{len(KERNELS)} libraries in {wall:.3f} s (parallel)")
    for name in NO_SPILL:
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      spills.get(name, ""))
        if m is None:
            raise AssertionError(f"ptxas reported no spill line for {name}")
        if m.groups() != ("0", "0"):
            raise AssertionError(f"{name} spills: {spills[name]}")


# ---------------------------------------------------------------------------
# phase 7: the histogram kernel against its plain version
# ---------------------------------------------------------------------------


def _random_bits(n: int, wide: bool, gen: torch.Generator) -> torch.Tensor:
    """n random u32 (int32) or u64 (int64) bit patterns on the card."""
    if wide:
        hi = torch.randint(-2**31, 2**31, (n,), generator=gen, device="cuda",
                           dtype=torch.int64)
        lo = torch.randint(0, 2**32, (n,), generator=gen, device="cuda",
                           dtype=torch.int64)
        return (hi << 32) | lo
    return torch.randint(-2**31, 2**31, (n,), generator=gen, device="cuda",
                         dtype=torch.int64).to(torch.int32)


def histogram_cases():
    """(n, wide, shift, width, tile)."""
    cases = [(n, False, shift, 8, tile)
             for n in (1 << 20, 1 << 28) for tile in (8192, 2048)
             for shift in (0, 8, 16, 24)]
    cases += [(1 << 20, False, 31, 1, 8192), (1 << 20, False, 30, 2, 8192),
              (1 << 20, False, 4, 5, 8192),
              (1 << 20, False, 3, 8, 3000),          # odd tile: 3072
              ((1 << 20) + 777, False, 0, 8, 8192),  # no tile multiple
              (1 << 24, True, 40, 8, 8192),          # u64, shift 40
              (1 << 22, False, 4, 12, 8192)]         # bins in device memory
    return cases


def phase_histogram() -> int:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 7)
    worst = 0
    cache = {}
    for n, wide, shift, width, tile in histogram_cases():
        if (n, wide) not in cache:
            cache.clear()
            torch.cuda.empty_cache()
            cache[(n, wide)] = _random_bits(n, wide, gen)
        bits = cache[(n, wide)]
        got = hist.digit_histogram(bits, shift, width, tile)
        want = hist.digit_histogram_reference(bits, shift, width, tile)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        ok = torch.equal(got, want)
        log("7 histogram-vs-plain",
            f"{'u64' if wide else 'u32'} n={n} shift={shift} width={width} "
            f"tile={tile}->{hist.round_tile(tile)}: counts "
            f"{tuple(got.shape)} max_abs_err={err} "
            f"{'bit-equal' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"histogram kernel != plain version (n={n} "
                                 f"shift={shift} width={width} tile={tile})")
        worst = max(worst, err)
    return worst


# ---------------------------------------------------------------------------
# phase 8: the portable engines through the public API
# ---------------------------------------------------------------------------


def _raw16(rng, n: int) -> np.ndarray:
    """Raw 16-bit float patterns: uniform (NaNs with every payload, both
    signs, denormals, infinities), with 1% +0.0 and 1% -0.0."""
    u = rng.integers(0, 2**16, size=n, dtype=np.uint16)
    u[rng.random(n) < 0.01] = 0
    u[rng.random(n) < 0.01] = 0x8000
    return u


def portable_cases():
    """(label, method, run); run(rng) -> (device seconds, check)."""

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    def keys_only(dtype, n, method, specials=False, **kw):
        def run(rng):
            x = _rand_keys(rng, dtype, n, specials)
            xd = torch.from_numpy(x).cuda()
            secs, out = timed(lambda: thrs.sort_keys(xd, method=method, **kw))
            got = out.cpu().numpy()
            del xd, out

            def check():
                want = (np.sort(x) if x.dtype.kind in "ui" and not kw
                        else x[_perm(x, kw.get("order") == "descending")])
                return np.array_equal(_bits_view(got), _bits_view(want))
            return secs, check
        return run

    def pairs(kdtype, n, method, specials=False, order="ascending", **kw):
        def run(rng):
            x = _rand_keys(rng, kdtype, n, specials)
            wide = np.dtype(kdtype).itemsize == 8 and kdtype != np.float64
            v = rng.integers(0, 2**64 if wide else 2**32, size=n,
                             dtype=np.uint64 if wide else np.uint32)
            xd, vd = torch.from_numpy(x).cuda(), torch.from_numpy(v).cuda()
            secs, (k, vals) = timed(lambda: thrs.sort_pairs(
                xd, vd, order=order, method=method, **kw))
            gk, gv = k.cpu().numpy(), vals.cpu().numpy()
            del xd, vd, k, vals

            def check():
                p = _perm(x, order == "descending", kw.get("start_bit", 0),
                          kw.get("end_bit"))
                return (np.array_equal(_bits_view(gk), _bits_view(x[p]))
                        and np.array_equal(gv, v[p]))
            return secs, check
        return run

    def keys16(tdtype, n, method):
        def run(rng):
            u = _raw16(rng, n)
            xd = torch.from_numpy(u.view(np.int16)).cuda().view(tdtype)
            secs, out = timed(lambda: thrs.sort_keys(xd, method=method))
            got = out.view(torch.int16).cpu().numpy().view(np.uint16)
            del xd, out
            return secs, lambda: np.array_equal(got, u[_perm(u, kind="f")])
        return run

    def rows(B, n, method):
        def run(rng):
            x = rng.integers(0, 2**32, size=(B, n), dtype=np.uint32)
            xd = torch.from_numpy(x).cuda()
            secs, out = timed(lambda: thrs.sort_keys(xd, method=method))
            got = out.cpu().numpy()
            del xd, out
            return secs, lambda: np.array_equal(got, np.sort(x, axis=1))
        return run

    def segments(n, nseg, method):
        def run(rng):
            x = rng.integers(0, 2**32, size=n, dtype=np.uint32)
            offs = np.sort(rng.integers(0, n, size=nseg)).astype(np.int32)
            xd = torch.from_numpy(x).cuda()
            seg = thrs.segment_ids_from_offsets(torch.from_numpy(offs).cuda(),
                                                n)
            secs, (k, perm) = timed(lambda: (
                thrs.sort_keys(xd, segment_ids=seg, method=method),
                thrs.sort_indices(xd, segment_ids=seg, method=method)))
            gk, gp, sid = k.cpu().numpy(), perm.cpu().numpy(), seg.cpu().numpy()
            del xd, seg, k, perm

            def check():
                want = np.searchsorted(offs, np.arange(n), side="right") - \
                    np.searchsorted(offs, 0, side="right")
                p = np.lexsort((x, want))
                return (np.array_equal(sid, want) and np.array_equal(gp, p)
                        and np.array_equal(gk, x[p]))
            return secs, check
        return run

    c = "counting"
    return [
        ("sort_keys u32 n=160,000,000 (reference main.cpp:105)", c,
         keys_only(np.uint32, 160_000_000, c)),
        ("sort_pairs u32+u32 n=2**24", c, pairs(np.uint32, 1 << 24, c)),
        ("sort_keys f32 NaN/-0.0/negatives n=2**22", c,
         keys_only(np.float32, 1 << 22, c, specials=True)),
        ("sort_pairs u64+u64 n=2**22", c, pairs(np.uint64, 1 << 22, c)),
        ("sort_pairs u32+u32 window [8,16) n=2**22", c,
         pairs(np.uint32, 1 << 22, c, start_bit=8, end_bit=16)),
        ("sort_pairs f64+u32 descending NaN/-0.0 n=2**22", c,
         pairs(np.float64, 1 << 22, c, specials=True, order="descending")),
        ("sort_keys f16 NaN payloads/-0.0 n=2**22", c,
         keys16(torch.float16, 1 << 22, c)),
        ("sort_keys bf16 NaN payloads/-0.0 n=2**22", c,
         keys16(torch.bfloat16, 1 << 22, c)),
        ("sort_keys u32 2-D rows 4096x4096", c, rows(4096, 4096, c)),
        ("sort_pairs u32+u32 n=2**24", "argsort",
         pairs(np.uint32, 1 << 24, "argsort")),
        ("sort_pairs u32+u32 n=2**24", "lsd_argsort",
         pairs(np.uint32, 1 << 24, "lsd_argsort")),
        ("sort_keys+sort_indices u32 segment_ids_from_offsets (1000 "
         "segments) n=2**24", "argsort", segments(1 << 24, 1000, "argsort")),
    ]


def phase_portable() -> int:
    rng = np.random.default_rng(SEED + 8)
    hist.KERNEL_LAUNCHES = 0
    for label, method, run in portable_cases():
        before = hist.KERNEL_LAUNCHES
        secs, check = run(rng)
        launches = hist.KERNEL_LAUNCHES - before
        ok = check()
        log("8 portable-path", f"method={method} {label}: {secs * 1e3:.3f} ms "
            f"(host clock, synchronized) histogram launches={launches} "
            f"{'bit-exact' if ok else 'MISMATCH'} vs numpy oracle")
        torch.cuda.empty_cache()
        if not ok:
            raise AssertionError(f"portable path output wrong: {method} {label}")
        if method == "counting" and launches == 0:
            raise AssertionError(f"counting path did not launch the histogram "
                                 f"kernel: {label}")
    return hist.KERNEL_LAUNCHES


# ---------------------------------------------------------------------------
# phase 9: the probes through their tool entry points
# ---------------------------------------------------------------------------


def phase_probes(card: str) -> tuple[dict, dict, int, int]:
    gf.KERNEL_LAUNCHES = 0
    pdf.KERNEL_LAUNCHES = 0
    g = gf.measure(4096, 2048, 5)
    g_rate = gf.measure(4096, 1 << 18, 5)
    dev = gf.measure_device_gather(1 << 28, 5)
    s64 = pdf.measure(1024, 8, 64, 5)
    s1k = pdf.measure(1024, 8, 1024, 5)
    g_launches, s_launches = gf.KERNEL_LAUNCHES, pdf.KERNEL_LAUNCHES
    for r in (g, g_rate):
        log("9 probes", f"gather_floor m={r['m']} rounds={r['rounds']}: "
            f"kernel {r['ms']:.6f} ms -> {r['ns_per_load']:.6f} ns/load = "
            f"{r['gloads_per_s']:.4f} Gloads/s; plain version "
            f"{r['plain_ms']:.6f} ms; checksum {r['checksum']:#010x} equal "
            f"to the plain version; median of 5, CUDA events; card: {card}")
    log("9 probes", f"device-memory gather src[perm] of 2**28 u32 (counting "
        f"stage 3's gather): {dev['ms']:.6f} ms -> {dev['gelems_per_s']:.4f} "
        f"Gelem/s, {dev['tb_per_s']:.4f} TB/s (bound {dev['bound_ms']:.6f} "
        f"ms); median of 5, CUDA events; card: {card}")
    for r in (s64, s1k):
        log("9 probes", f"partition_scatter r={r['r']} w={r['w']} (unused) "
            f"t={r['t']} ({r['n']} u32): kernel {r['ms']:.6f} ms -> "
            f"{r['tb_per_s'] * 1e3:.1f} GB/s read+write "
            f"({100 * r['bound_ms'] / r['ms']:.1f}% of 3.35 TB/s, bound "
            f"{r['bound_ms']:.6f} ms); plain version {r['plain_ms']:.6f} ms; "
            f"index_copy_ {r['library_ms']:.6f} ms; output equal to the "
            f"plain version; median of 5, CUDA events; card: {card}")
    log("9 probes", f"launches: gather_floor={g_launches} "
        f"partition_scatter={s_launches}")
    if g_launches == 0 or s_launches == 0:
        raise AssertionError("a probe did not launch its kernel")
    return g, s1k, g_launches, s_launches


# ---------------------------------------------------------------------------
# phase 10: timing of the histogram and of the counting sort
# ---------------------------------------------------------------------------


def phase_histogram_timing(x: torch.Tensor, card: str) -> dict:
    """The histogram at 2**28 u32, width 8, at the counting engine's tile
    (2048, the main path's shape) and the default tile (8192)."""
    bits = x.view(torch.int32)
    n = bits.shape[0]
    result = None
    for tile in (counting_engine.DEFAULT_TILE, hist.DEFAULT_TILE):
        ms = cuda_ms(lambda: hist.digit_histogram(bits, 0, 8, tile), 5)
        plain_ms = cuda_ms(
            lambda: hist.digit_histogram_reference(bits, 0, 8, tile), 5)
        T = -(-n // tile)
        keyed = ((torch.arange(n, device="cuda", dtype=torch.int64) // tile)
                 << 8) | (bits.long() & 0xFF)
        library_ms = cuda_ms(lambda: torch.bincount(keyed, minlength=T * 256),
                             5)
        del keyed
        moved = 4 * n + 4 * T * 256
        bound_ms = moved / H100_BYTES_PER_S * 1e3
        log("10 timing", f"digit_histogram u32 n=2**28 width=8 tile={tile}: "
            f"kernel {ms:.6f} ms ({moved / ms / 1e9:.4f} TB/s), plain "
            f"version {plain_ms:.6f} ms, torch.bincount of the precomputed "
            f"(tile << 8) | digit {library_ms:.6f} ms, bound {bound_ms:.6f} "
            f"ms ({moved} bytes at 3.35 TB/s; kernel at "
            f"{100 * bound_ms / ms:.1f}% of it); median of 5, CUDA events; "
            f"card: {card}")
        if result is None:
            result = {"ms": ms, "plain_ms": plain_ms, "bytes": moved,
                      "library_ms": library_ms}
    return result


def phase_counting_timing(x: torch.Tensor, bitonic_ms: float,
                          card: str) -> None:
    n = x.shape[0]
    ms = cuda_ms(lambda: thrs.sort_keys(x, method="counting"), 5)
    signed = x.view(torch.int32) ^ -2**31
    yard_ms = cuda_ms(lambda: torch.sort(signed, stable=True), 5)
    del signed
    log("10 timing", f"counting sort_keys u32 n=2**28: {ms:.3f} ms "
        f"({n / ms / 1e6:.4f} Gkeys/s); torch.sort(stable=True) {yard_ms:.3f} "
        f"ms; bitonic sort_keys (phase 5) {bitonic_ms:.3f} ms; median of 5, "
        f"CUDA events; card: {card}")
    # per-stage device time of the same sort: the engine marks each stage
    bits = keybits.key_bits(x)
    passes = []
    for rep in range(4):
        events = []

        def mark(stage):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((stage, ev))

        mark("start")
        counting_engine.sort_arrays_counting(bits, [x], 0, 32, mark=mark)
        torch.cuda.synchronize()
        if rep:
            stages = {}
            for (_, a), (stage, b) in zip(events, events[1:]):
                stages[stage] = stages.get(stage, 0.0) + a.elapsed_time(b)
            passes.append(stages)
    total = 0.0
    for stage in passes[0]:
        med = statistics.median(p[stage] for p in passes)
        total += med
        log("10 timing", f"counting breakdown {stage}: {med:.3f} ms "
            f"(4 passes)" if stage != "pad" else
            f"counting breakdown pad: {med:.3f} ms")
    log("10 timing", f"counting breakdown sum {total:.3f} ms "
        f"({100 * total / ms:.1f}% of the sort_keys median); median of 3 "
        f"after a warm-up, CUDA events between stages; card: {card}")


# ---------------------------------------------------------------------------
# phase 11: the distributed sort on a one-rank NCCL group
# ---------------------------------------------------------------------------

#: keys per call at world size 1, and per rank of the 8-rank local work
PSORT_N = 1 << 28
PSORT_RANKS = 8


def zipf_keys(n: int, seed: int) -> np.ndarray:
    """n u32 keys drawn as np.minimum(zipf(1.3), 2**31) (BASELINE config
    5's skew), by 8 threads with generators spawned from ``seed``."""
    parts = 8
    seqs = np.random.SeedSequence(seed).spawn(parts)
    bounds = [n * i // parts for i in range(parts + 1)]
    out = np.empty(n, np.uint32)

    def fill(i):
        z = np.random.default_rng(seqs[i]).zipf(1.3, bounds[i + 1] - bounds[i])
        out[bounds[i]:bounds[i + 1]] = np.minimum(z, 2**31)

    with ThreadPoolExecutor(parts) as pool:
        list(pool.map(fill, range(parts)))
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    """A u32/i32 card tensor as host uint32 bits."""
    return t.view(torch.int32).cpu().numpy().view(np.uint32)


def _np(t: torch.Tensor) -> np.ndarray:
    """A card tensor on the host (u32 through its int32 view)."""
    if t.dtype == torch.uint32:
        return _host(t)
    return t.cpu().numpy()


def _one_rank_group() -> None:
    """A one-rank NCCL group over the loopback address: NCCL allows one
    rank per card, and this run has one card."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    multihost.initialize(backend="nccl",
                         init_method=f"tcp://127.0.0.1:{port}",
                         world_size=1, rank=0)


def _lexsorted(words: list) -> list:
    """The words in the stable torch.sort lexsort order (the plain version
    of every local sort and merge of psort)."""
    perm = psort._lexsort_perm(words)
    return [w[perm] for w in words]


def _same(got: list, want: list) -> bool:
    return all(torch.equal(g[:w.shape[0]], w) for g, w in zip(got, want))


def _peak(fn):
    """``fn()``'s result and the most device memory it held above what was
    allocated before it (bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def oracle_line(what: str, seconds: float) -> str:
    how = ("the native host oracle (native/thrs_host.cpp, utils.native_oracle)"
           if native_oracle.available() else
           "numpy's stable argsort (the native oracle did not build)")
    return f"{what}: {how}, waited {seconds:.3f} s"


def phase_psort_main(card: str) -> int:
    """psort_keys (both orders, and with the two-word index), psort_pairs,
    psort_indices (both index widths) and a donated psort_keys of 2**28
    zipf keys at world size 1, and the dry run, through the public entry
    points: the kernel launches of these calls (the counts set to 0 just
    before), the words psort's ring carried (psort.WIRE: 1 on the keys-only
    path), each output bit-exact against the host oracle, and each call
    timed (median of 5, CUDA events) beside the single-card sort of the
    same keys; the donated call's peak memory beside the plain call's."""
    rng_seed = SEED + 11
    t0 = time.perf_counter()
    x = zipf_keys(PSORT_N, rng_seed)
    v = np.random.default_rng(rng_seed).integers(0, 2**32, PSORT_N,
                                                 dtype=np.uint32)
    distinct = len(np.unique(x[:1 << 20]))
    log("11 psort", f"{PSORT_N} zipf(1.3) u32 keys ({distinct} distinct in "
        f"the first 2**20) and u32 payloads made in "
        f"{time.perf_counter() - t0:.3f} s")
    pool = ThreadPoolExecutor(1)
    # the stable argsort on the host (ctypes releases the GIL), beside the
    # card's work
    oracle = pool.submit(native_oracle.oracle_sort, x)
    xd, vd = torch.from_numpy(x).cuda(), torch.from_numpy(v).cuda()
    # each psort call, the single-card sort of the same keys, and whether
    # it is keys-only (its ring must carry the key word alone)
    calls = {
        "psort_keys": (lambda: thrs.psort_keys(xd),
                       lambda: thrs.sort_keys(xd), True),
        "psort_keys descending": (
            lambda: thrs.psort_keys(xd, order="descending"),
            lambda: thrs.sort_keys(xd, order="descending"), True),
        "psort_keys _force_wide": (
            lambda: thrs.psort_keys(xd, _force_wide=True),
            lambda: thrs.sort_keys(xd), True),
        "psort_pairs": (lambda: thrs.psort_pairs(xd, vd),
                        lambda: thrs.sort_pairs(xd, vd), False),
        "psort_indices": (lambda: thrs.psort_indices(xd),
                          lambda: thrs.sort_indices(xd), False),
        "psort_indices _force_wide": (
            lambda: thrs.psort_indices(xd, _force_wide=True),
            lambda: thrs.sort_indices(xd), False),
    }
    got, routes, wires = {}, [], {}
    be.KERNEL_LAUNCHES = 0
    be.MARK = lambda event, name, words: (
        routes.append(name) if event == "route" else None)
    try:
        for label, (run, _, _) in calls.items():
            wire = wires[label] = {}
            psort.WIRE = lambda step, nw: wire.setdefault(step, nw)
            out = run()
            got[label] = [_np(t) for t in
                          (out if isinstance(out, tuple) else (out,))]
        psort.WIRE = None
        donated = xd.clone()
        out = thrs.psort_keys(donated, donate=True)
        got["psort_keys donate=True"] = [_np(out)]
        if out is not donated:
            raise AssertionError("donated psort_keys returned another tensor")
        lines = dryrun.dryrun_multichip()
    finally:
        be.MARK = None
        psort.WIRE = None
    launches = be.KERNEL_LAUNCHES
    log("11 psort", f"main path (world size 1, {len(calls) + 1} calls and the "
        f"dry run): sweep kernel launches={launches}, routes "
        f"{ {r: routes.count(r) for r in dict.fromkeys(routes)} }")
    if launches == 0:
        raise AssertionError("psort did not launch the sweep kernel")
    for label, wire in wires.items():
        log("11 psort", f"{label}: words per element in the ring chunk "
            f"{wire.get('ring')} (psort.WIRE {wire})")
        if calls[label][2] and wire.get("ring") != 1:
            raise AssertionError(f"{label} did not take the keys-only path")
    log("11 psort", f"dry run at world size 1: {len(lines)} scenarios ok")
    for label, (run, single, _) in calls.items():
        ms, single_ms = cuda_ms(run, 5), cuda_ms(single, 5)
        log("11 psort", f"{label} u32 n=2**28 zipf(1.3), world size 1: "
            f"{ms:.3f} ms, {label.split()[0].replace('psort', 'sort')} of the "
            f"same keys {single_ms:.3f} ms (psort's own {ms - single_ms:.3f} "
            f"ms); median of 5, CUDA events; card: {card}")
    plain, plain_peak = _peak(lambda: thrs.psort_keys(xd))
    del plain
    don_ms = cuda_ms(lambda: thrs.psort_keys(donated, donate=True), 5)
    _, don_peak = _peak(lambda: thrs.psort_keys(donated, donate=True))
    log("11 psort", f"psort_keys donate=True u32 n=2**28: {don_ms:.3f} ms "
        f"(median of 5, CUDA events); peak device memory above its inputs "
        f"{don_peak / 2**20:.1f} MiB, without donate {plain_peak / 2**20:.1f} "
        f"MiB (the keys take {PSORT_N * 4 / 2**20:.1f} MiB); card: {card}")
    if don_peak > plain_peak:
        raise AssertionError("donated psort_keys took more memory")
    del xd, vd, donated
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    srt, perm = oracle.result()
    pool.shutdown()
    log("11 psort", oracle_line("oracle", time.perf_counter() - t0))
    checks = {
        "psort_keys": [srt],
        "psort_keys descending": [srt[::-1]],
        "psort_keys _force_wide": [srt],
        "psort_pairs": [srt, v[perm]],
        "psort_indices": [perm],
        "psort_indices _force_wide": [perm],
        "psort_keys donate=True": [srt],
    }
    for label, want in checks.items():
        ok = all(np.array_equal(g, w) for g, w in zip(got[label], want))
        if label.startswith("psort_indices"):
            dt = np.int64 if "wide" in label else np.int32
            ok = ok and got[label][0].dtype == dt
        log("11 psort", f"{label}: {'bit-exact' if ok else 'MISMATCH'} vs "
            "the oracle (sorted keys; stable argsort)")
        if not ok:
            raise AssertionError(f"psort output wrong: {label}")
    return launches


def phase_psort_local(card: str) -> None:
    """Rank 0's local work in an 8-rank group with B = 2**28 per rank, at
    psort's own capacities: the local sort of B (key, index) tuples, then
    :func:`local_merges` on those 2-word tuples and on the key word alone
    (the keys-only path ships no index). Each is timed (median of 5, CUDA
    events) and held bit-equal to the stable torch.sort lexsort of the same
    words."""
    plan = psort.capacity_plan(PSORT_RANKS * PSORT_N, PSORT_RANKS)
    B, cap, cap3 = plan.B, plan.cap, plan.cap3
    log("11 psort", f"P={PSORT_RANKS} shapes: B={B} cap={cap} cap3={cap3} "
        f"(8*cap={PSORT_RANKS * cap} pads to "
        f"2**{(PSORT_RANKS * cap - 1).bit_length()})")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 8)
    keys = torch.from_numpy(zipf_keys(B, SEED + 8)).cuda().view(torch.int32)
    words = [keys, torch.arange(B, dtype=torch.int32, device="cuda")]

    def measure(label, fn, want):
        routes = []
        be.MARK = lambda event, name, w: (
            routes.append(name) if event == "route" else None)
        try:
            out = fn()
        finally:
            be.MARK = None
        torch.cuda.synchronize()
        ok = _same(out, want)
        ms = cuda_ms(fn, 5)
        kinds = {r: routes.count(r) for r in dict.fromkeys(routes)}
        log("11 psort", f"P={PSORT_RANKS} local work, {label}: {ms:.3f} ms; "
            f"routes {kinds}; {'bit-equal' if ok else 'MISMATCH'} to the "
            f"torch.sort lexsort; median of 5, CUDA events; card: {card}")
        if not ok:
            raise AssertionError(f"psort local work wrong: {label}")
        return out

    srt = measure("local sort of B", lambda: be.sort_words(words, [])[0],
                  _lexsorted(words))
    del keys, words
    # the ring's merges and the rebalance merge on the (key, index) tuples
    # of a sort that ships the index, then on the key word alone, as the
    # keys-only path ships it
    for words in (srt, srt[:1]):
        local_merges(words, B, cap, cap3, gen, measure, card)
    del srt
    torch.cuda.empty_cache()


def local_merges(srt: list, B: int, cap: int, cap3: int, gen, measure,
                 card: str) -> None:
    """The 7 binary-counter merges of 8 sentinel-padded runs of length cap
    (built round-robin from the sorted words, 2**25 real each, as the ring
    delivers them) and the rebalance merge of the sorted words with 8
    pieces of length cap3, on the words of ``srt`` (1 or 2)."""
    nw = len(srt)
    what = f"{nw}-word " + ("(key, index)" if nw == 2 else "keys-only")
    real = B // PSORT_RANKS
    runs = []
    for r in range(PSORT_RANKS):
        run = torch.full((nw, cap), psort.SENTINEL, dtype=torch.int32,
                         device="cuda")
        for i in range(nw):
            run[i, :real] = srt[i][r::PSORT_RANKS]
        runs.append(list(run))

    def fold():
        tree = psort.RunTree(nw, "bitonic")
        for run in runs:
            tree.push(run)
        return tree.result()

    measure(f"merges of 8 runs of cap, {what}", fold,
            _lexsorted([torch.cat(ws) for ws in zip(*runs)]))
    merge_breakdown(fold, f"{what}, ", card)
    del runs
    torch.cuda.empty_cache()
    # rebalance: the sorted B kept, 8 boundary pieces of cap3 (each a
    # sorted run of 64 tuples, with later indices, then fill)
    pieces = torch.full((nw, 8, cap3), psort.SENTINEL, dtype=torch.int32,
                        device="cuda")
    pick = torch.randint(0, B, (8, 64), generator=gen, device="cuda")
    for i in range(8):
        piece = _lexsorted([srt[0][pick[i]],
                            B + torch.arange(i * 64, (i + 1) * 64,
                                             dtype=torch.int32,
                                             device="cuda")][:nw])
        for j in range(nw):
            pieces[j, i, :64] = piece[j]
    recv = [pieces[j].reshape(-1) for j in range(nw)]
    measure(f"rebalance merge (B + 8 pieces of cap3), {what}",
            lambda: psort.rebalance_merge(srt, recv, nw, 8, cap3, "bitonic"),
            _lexsorted([torch.cat([a, b]) for a, b in zip(srt, recv)]))
    del recv, pieces
    torch.cuda.empty_cache()


def merge_breakdown(fold, what: str, card: str) -> None:
    """Device time of each merge of the 8-run fold: CUDA events at the
    engine's MARK hook where each merge takes its route (so each span also
    holds the flip of the next merge's second run), median of 3 passes
    after a warm-up."""
    passes, merges = [], []
    for rep in range(4):
        marks = []

        def mark(event, name, words):
            if event == "route":
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append((name, int(words[0].shape[0]), ev))

        be.MARK = mark
        try:
            fold()
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        finally:
            be.MARK = None
        torch.cuda.synchronize()
        evs = [ev for _, _, ev in marks] + [end]
        if rep:
            passes.append([a.elapsed_time(b) for a, b in zip(evs, evs[1:])])
        else:
            merges = [(name, a) for name, a, _ in marks]
    for (name, a), ms in zip(merges, (statistics.median(c)
                                      for c in zip(*passes))):
        m = 1 << max((2 * a - 1).bit_length(), be.MIN_L)
        how = (f"a network on 2**{m.bit_length() - 1}, {2 * a / m:.3f} of "
               "it real" if name == "merge-padded" else "no padding")
        log("11 psort", f"P={PSORT_RANKS} local work, {what}merge of {a}+{a} "
            f"({name}: {how}): {ms:.3f} ms; median of 3, CUDA events; "
            f"card: {card}")


# ---------------------------------------------------------------------------
# phase 12: the MSB-partition front-end against the direct network
# ---------------------------------------------------------------------------

#: the partition knob of phase 12 (the engine's default is 0: off)
PARTITION_BITS = 8


def _with_partition(fn):
    """``fn`` with THRS_PARTITION_BITS set (the public API reads the
    engine's knobs from the environment at each call)."""
    def run():
        old = os.environ.get("THRS_PARTITION_BITS")
        os.environ["THRS_PARTITION_BITS"] = str(PARTITION_BITS)
        try:
            return fn()
        finally:
            if old is None:
                del os.environ["THRS_PARTITION_BITS"]
            else:
                os.environ["THRS_PARTITION_BITS"] = old
    return run


def _routes_of(fn) -> tuple[list, object]:
    routes = []
    be.MARK = lambda event, name, words: (
        routes.append(name) if event == "route" else None)
    try:
        out = fn()
    finally:
        be.MARK = None
    return routes, out


def partition_breakdown(fn, label: str, total_ms: float, card: str) -> None:
    """Device time of each step of the front-end (:func:`part_times`: rank
    sort, counts, scatter, bucket sorts, merges, or the fallback); the rest
    (the key transform, the packing of words, the truncation) is the call's
    time less the steps'."""
    parts, total = part_times(fn, label)
    rest = total - sum(ms for _, _, ms in parts)
    steps = ", ".join(f"{name} {ms:.3f}" for name, _, ms in parts)
    log("12 partition", f"{label} by step (ms): {steps}, the rest {rest:.3f};"
        f" all {total:.3f} (the timed median {total_ms:.3f}); median of 3, "
        f"CUDA events at MARK; card: {card}")


def phase_partition(card: str) -> int:
    """The MSB-partition front-end at partition_bits=8 through the public
    entry points, against the direct network on the same keys: sort_pairs
    u32+u32 and sort_keys u32 at 2**28 uniform keys (route "partition"),
    and sort_keys of the 2**28 zipf(1.3) keys of phase 11 (route
    "partition-fallback": the rank sort and counts are wasted). Each output
    bit-exact against the host oracle, each call timed (median of 5, CUDA
    events) beside the direct one and broken down by step. Returns the
    sweep kernel's launches of the partition calls (counted from 0)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 12)
    n = 1 << 28
    keys, vals = _random_u32(n, gen), _random_u32(n, gen)
    zipf = torch.from_numpy(zipf_keys(n, SEED + 11)).cuda()
    pool = ThreadPoolExecutor(2)
    oracles = {"uniform": pool.submit(native_oracle.oracle_sort, _host(keys)),
               "zipf": pool.submit(native_oracle.oracle_sort, _host(zipf))}
    cases = {
        "sort_pairs u32+u32 uniform": (lambda: thrs.sort_pairs(keys, vals),
                                       "uniform", "partition"),
        "sort_keys u32 uniform": (lambda: thrs.sort_keys(keys), "uniform",
                                  "partition"),
        "sort_keys u32 zipf(1.3)": (lambda: thrs.sort_keys(zipf), "zipf",
                                    "partition-fallback"),
    }
    got = {}
    be.KERNEL_LAUNCHES = 0
    for label, (fn, _, route) in cases.items():
        routes, out = _routes_of(_with_partition(fn))
        got[label] = [_host(t) for t in
                      (out if isinstance(out, tuple) else (out,))]
        log("12 partition", f"{label}: routes {routes}")
        if route not in routes:
            raise AssertionError(f"{label} did not take the {route} route")
    launches = be.KERNEL_LAUNCHES
    log("12 partition", f"main path (3 calls at partition_bits="
        f"{PARTITION_BITS}): sweep kernel launches={launches}")
    if launches == 0:
        raise AssertionError("the partition front-end launched no sweep")
    for label, (fn, _, route) in cases.items():
        part_ms = cuda_ms(_with_partition(fn), 5)
        direct_ms = cuda_ms(fn, 5)
        log("12 partition", f"{label} n=2**28: partition_bits="
            f"{PARTITION_BITS} ({route}) {part_ms:.3f} ms, direct network "
            f"{direct_ms:.3f} ms ({direct_ms / part_ms:.3f}x); median of 5, "
            f"CUDA events; card: {card}")
        partition_breakdown(_with_partition(fn), label, part_ms, card)
    del keys, zipf
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = {k: f.result() for k, f in oracles.items()}
    pool.shutdown()
    log("12 partition", oracle_line("oracles", time.perf_counter() - t0))
    v = _host(vals)
    for label, (_, which, _) in cases.items():
        srt, perm = res[which]
        want = [srt, v[perm]] if label.startswith("sort_pairs") else [srt]
        ok = all(np.array_equal(g, w) for g, w in zip(got[label], want))
        log("12 partition", f"{label}: {'bit-exact' if ok else 'MISMATCH'} "
            "vs the oracle")
        if not ok:
            raise AssertionError(f"partition output wrong: {label}")
    del vals
    torch.cuda.empty_cache()
    return launches


def phase_psort(card: str) -> int:
    """Phase 11 on the running one-rank group (``_one_rank_group``)."""
    launches = phase_psort_main(card)
    phase_psort_local(card)
    return launches


# ---------------------------------------------------------------------------
# phase 13: the harness layer (bench, matrix, drives, examples, entry,
# scaling, the flagship plan)
# ---------------------------------------------------------------------------


def host_memory() -> str:
    """The host's total and available memory (/proc/meminfo)."""
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, value = line.split(":", 1)
            info[key] = int(value.split()[0]) * 1024
    return (f"host memory {info['MemTotal'] / 2**30:.3f} GiB, available "
            f"{info['MemAvailable'] / 2**30:.3f} GiB")


def _step(what: str, fn):
    """Run one harness step, collecting the lines it prints; log its time
    and its last line. Returns (result, lines)."""
    lines = []
    t0 = time.perf_counter()
    result = fn(lines.append)
    log("13 harness", f"{what}: {time.perf_counter() - t0:.3f} s; "
        f"{lines[-1] if lines else ''}")
    return result, lines


def phase_harness(card: str) -> int:
    """The harness layer in process, on the running one-rank group: the
    bench at 2**28 and at the reference's u32Large n = 2**31 + 100 (both
    --verify full), the matrix at 1M, 16M and 256M, verify_baseline,
    nonpow2_sweep --big, drive --iters 8, the three examples, entry,
    scaling at world size 1 and baseline_scale. Each step raises on a
    failure. Returns the sweep kernel's launches of this path."""
    from tinyhipradixsort_torch import bench
    from tinyhipradixsort_torch import entry as entry_mod
    from tinyhipradixsort_torch.benchmarks import full, scaling
    from tinyhipradixsort_torch.examples import helloworld, segmented, soak
    from tinyhipradixsort_torch.tools import (baseline_scale, drive,
                                              nonpow2_sweep, verify_baseline)

    be.KERNEL_LAUNCHES = 0
    for n in (1 << 28, (1 << 31) + 100):
        if n > 1 << 28:
            log("13 harness", f"before the u32Large bench: {host_memory()}")
        routes = []
        be.MARK = lambda event, route, words: (
            routes.append(route) if event == "route" else None)
        t0 = time.perf_counter()
        try:
            line = bench.run(n, 5, "full", "auto", "cuda")
        finally:
            be.MARK = None
        want = "padded" if n & (n - 1) == 0 else "segmented"
        if routes[0] != want:
            raise AssertionError(f"bench n={n}: route {routes[0]}, not {want}")
        host_peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        log("13 harness", f"bench n={n} --verify full: "
            f"{time.perf_counter() - t0:.3f} s in all, routes "
            f"{ {r: routes.count(r) for r in dict.fromkeys(routes)} }, peak "
            f"device memory {line['peak_device_bytes'] / 2**30:.3f} GiB "
            f"(keys {4 * n / 2**30:.3f} GiB), the oracle took "
            f"{line['oracle_s']:.3f} s, the process's peak host memory so "
            f"far {host_peak / 2**20:.3f} GiB; card: {card}")
        print(json.dumps(line), flush=True)
        if line["oracle"] != "native":
            log("13 harness", "the native oracle did not build; numpy's "
                "stable sort checked the bench")
        torch.cuda.empty_cache()

    table, _ = _step("matrix --sizes 1M,16M,256M (best of 3, CUDA events)",
                     lambda out: full.run(("1M", "16M", "256M"), 3, "auto",
                                          "cuda", out=out))
    for row in table["results"]:
        log("13 harness", f"matrix {json.dumps(row)}")
    torch.cuda.empty_cache()
    _step("verify_baseline", lambda out: verify_baseline.verify("cuda",
                                                                 out=out))
    torch.cuda.empty_cache()
    fails, lines = _step("nonpow2_sweep --big", lambda out: nonpow2_sweep.sweep(
        "cuda", big=True, out=out))
    routes = [ln.rsplit("route=", 1)[-1] for ln in lines if "route=" in ln]
    log("13 harness", f"nonpow2_sweep: {len(routes)} cases, routes "
        f"{ {r: routes.count(r) for r in dict.fromkeys(routes)} }")
    if fails:
        raise AssertionError("\n".join(ln for ln in lines
                                       if ln.startswith("FAIL")))
    d, lines = _step("drive --iters 8", lambda out: drive.drive(
        "cuda", "auto", 8, out=out))
    if d.fails:
        raise AssertionError("\n".join(lines))
    _step("examples.helloworld", lambda out: helloworld.run("cuda", out=out))
    _step("examples.segmented", lambda out: segmented.run("cuda", out=out))
    _step("examples.soak --iters 2", lambda out: soak.soak(
        iters=2, dev="cuda", out=out))
    _step("examples.soak --iters 2 --pairs", lambda out: soak.soak(
        pairs=True, iters=2, dev="cuda", out=out))

    _step("entry", lambda out: entry_mod.run("cuda", out=out))
    rows, _ = _step("scaling --per-chip 16M at world size 1 (one-rank NCCL)",
                    lambda out: scaling.run(1 << 24, plist=[1], dev="cuda",
                                            out=out))
    log("13 harness", f"scaling {json.dumps(rows)}; card: {card}")
    bad, lines = _step("baseline_scale --P 64,128,256",
                       lambda out: baseline_scale.report(out=out))
    for line in lines[:-1]:
        log("13 harness", line)
    if bad:
        raise AssertionError("baseline_scale found a problem in the plan")
    return be.KERNEL_LAUNCHES


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

    phase_build()

    t0 = time.perf_counter()
    worst = phase_sweeps()
    log("3 kernel-vs-plain", f"all sweeps bit-equal in "
        f"{time.perf_counter() - t0:.3f} s, max_abs_err={worst}")

    t0 = time.perf_counter()
    launches = phase_main_path()
    log("4 main-path", f"all cases bit-exact in "
        f"{time.perf_counter() - t0:.3f} s, kernel launches={launches}")

    x = bench_keys()
    kernel_ms, plain_ms, sort_ms, err = phase_timing(x, card)
    worst = max(worst, err)
    phase_breakdown(x, sort_ms, card)
    phase_pairs(card)
    del x
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    x160, seg_ms = phase_nonpow2_timing(card)
    phase_segmented_breakdown(x160, seg_ms, card)
    del x160
    torch.cuda.empty_cache()
    phase_rows_timing(card)
    phase_unstable_timing(card)
    log("6 breakdown", f"new timing phases in {time.perf_counter() - t0:.3f} s")
    x = bench_keys()

    t0 = time.perf_counter()
    hist_err = phase_histogram()
    log("7 histogram-vs-plain", f"all cases bit-equal in "
        f"{time.perf_counter() - t0:.3f} s, max_abs_err={hist_err}")

    t0 = time.perf_counter()
    hist_launches = phase_portable()
    log("8 portable-path", f"all cases bit-exact in "
        f"{time.perf_counter() - t0:.3f} s, histogram launches="
        f"{hist_launches}")

    t0 = time.perf_counter()
    g, s, g_launches, s_launches = phase_probes(card)
    log("9 probes", f"done in {time.perf_counter() - t0:.3f} s")

    h = phase_histogram_timing(x, card)
    phase_counting_timing(x, sort_ms, card)
    del x
    torch.cuda.empty_cache()

    # phases 11-13 share one one-rank NCCL group
    _one_rank_group()
    try:
        t0 = time.perf_counter()
        psort_launches = phase_psort(card)
        log("11 psort", f"done in {time.perf_counter() - t0:.3f} s, sweep "
            f"kernel launches on the psort main path={psort_launches}")

        t0 = time.perf_counter()
        part_launches = phase_partition(card)
        log("12 partition", f"done in {time.perf_counter() - t0:.3f} s, sweep "
            f"kernel launches on the partition main path={part_launches}")

        t0 = time.perf_counter()
        harness_launches = phase_harness(card)
        log("13 harness", f"done in {time.perf_counter() - t0:.3f} s, sweep "
            f"kernel launches on the harness path={harness_launches}")
    finally:
        dist.destroy_process_group()
    log("done", f"{time.perf_counter() - t_all:.3f} s in all")

    def entry(name, launches, err, ms, plain_ms, nbytes, ops, library_ms):
        """One kernel's report; its bound is the larger of its bytes at the
        memory rate and its 32-bit operations at the integer rate."""
        t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / INT_OPS_PER_S
        return {"name": name, "route": "cuda",
                "source": f"tinyhipradixsort_torch/csrc/{name}.cu",
                "replaces": KERNELS[name], "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": library_ms}

    # the timed sweep (phase 5): the first local sweep of the 2**28
    # one-word network reads and writes every word once, and each of its
    # compare-exchanges (substages x n/2) is two operations (min and max)
    # on its one compare word
    sweep = _plan(28, 1, be.EngineTuning())[0]
    print(card, flush=True)
    print(json.dumps({"kernels": [
        # launches: the bitonic main path (phase 4), psort's (phase 11),
        # the partition front-end's (phase 12) and the harness's (phase 13)
        entry("bitonic_sweep",
              launches + psort_launches + part_launches + harness_launches,
              worst, kernel_ms,
              plain_ms,
              2 * 4 * (1 << 28), 2 * len(sweep.substages) * (1 << 27), None),
        # digit extraction: a shift, a mask and an add per word
        entry("digit_histogram", hist_launches, hist_err, h["ms"],
              h["plain_ms"], h["bytes"], 3 * (1 << 28), h["library_ms"]),
        # an index load, an add and a dynamic load per (round, element)
        entry("gather_floor", g_launches, 0, g["ms"], g["plain_ms"],
              g["bytes"], 3 * g["loads"], None),
        entry("partition_scatter", s_launches, 0, s["ms"], s["plain_ms"],
              s["bytes"], 0, s["library_ms"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
