#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tinyhipradixsort_torch) on one NVIDIA GPU.

Run from the root of the repository, on a machine with a Hopper card
(sm_90a), the CUDA toolkit and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases, one output line each (time, kernel launches, result):

1. device: the card's name and power limit (nvidia-smi);
2. build: the six kernels (bitonic sweep, digit histogram, the counting
   engine's bucket scan and rank-and-scatter, gather floor, partition
   scatter), one nvcc each, all started together, from csrc/ into the
   ignored _build/, with each one's nvcc time and, for each kernel
   function (each word count of the sweep's register body, each type of
   a template), ptxas registers and spill bytes (kept beside a reused
   library); the main path's 1-, 3- and 5-word instantiations and the
   four rank-and-scatter ones (u32/u64 bits, int32/int64 src; each
   carries every payload row size) are required to spill nothing;
3. kernel vs plain: sweeps of 1, 2, 3, 4, 5, 8 and 12 words (local, cross,
   forced ascending) on 2**20 random words, the cross sweeps over the top
   index bits of the 2**28 and 2**31 one-word and 2**24 three-word
   networks, the row paths' sweeps (stage r forced ascending, on
   b_pad * 2**r words, tiles spanning several rows or lying inside one) and
   the merges' sweeps of stage log2 m alone (2**31 words for the u32Large
   bench's merge), through the CUDA kernel and through
   ``run_sweep_reference``, required bit-equal;
4. main path: the public entry points with method="bitonic" (``NET``; the
   network's routes) at real sizes (sort_keys u32 at 2**28,
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
   that is no tile multiple, u64 with shift 40), required bit-equal; then
   ``digit_histogram_runs`` (the counts and each run's column sums, what
   the counting engine launches) through its kernel and through
   ``digit_histogram_runs_reference`` (the sort_keys pass at 2**28; widths
   1-8 on 3 rows with a short last run; rows of 127, 128 and 129 tiles
   around the run of 128; u64 bits; ragged n; every digit the same; the
   row cells' 4096 and 16384 rows; tiles of 3072, 20480, 65536 and 2**22
   split between the CTAs of a cluster), counts and run sums bit-equal;
   then ``bucket_offsets`` through the bucket-scan kernel on both routes
   (given the run sums, and on the counts alone) and through
   ``bucket_offsets_reference`` (the sort_keys pass's counts at 2**28,
   width 8, tile 2048, int32 and int64 offsets; widths 1-8 x tiles 1024,
   2048 and 2176 x 1, 3 and 64 rows; rows just below, at and above the
   run of 128 tiles; int64 offsets; every count in one bucket), required
   bit-equal and contiguous; then
   ``rank_scatter`` through the kernel and through
   ``rank_scatter_reference`` (2**28 u32 at width 8 and tile 2048: the
   sort_keys pass on the bits alone, the sort_pairs pass with the values
   as one payload, two payloads, bits + src; payload rows of 1, 2, 4, 8 and 16 bytes, four at
   once; src written or not; a u64 pass with a u64 payload; 3- and 1-bit
   digits; rows whose last chunk holds fewer tiles; padded row tails;
   int64 src; a multi-chunk tile; an odd tile; skewed digits), the bits,
   src and every payload bit-equal;
8. portable path: the public entry points with method="counting" (u32 at
   160,000,000, pairs, f32 and f16/bf16 specials, u64 pairs, a window,
   descending f64, 2-D rows 4096x4096), "argsort" and "lsd_argsort"
   (pairs), and segment_ids= from segment_ids_from_offsets, each bit-exact
   against the numpy oracle, each counting case required to launch the
   histogram, bucket-scan and rank-and-scatter kernels;
9. probes: the gather-floor and partition-scatter probes through their
   tool entry points, each kernel required equal to its plain version; the
   gather floor at its default shape (m = 4096, 2048 rounds) and at the
   rate shape (2**18 rounds, which the kernel report carries), each beside
   its bound and its share of it;
10. timing of the new kernels and engine: the histogram at 2**28 beside its
   plain version, torch.bincount and its bound, and with its run sums in
   turns with it (a call and the kernel alone); the bucket scan at 2**28
   (width 8, tile 2048; int32 and int64 offsets) given the run sums and
   without, a call and each route's kernels alone, beside its plain
   version, torch.cumsum of the bucket-major counts and its bound; the
   rank-and-scatter kernel on one pass at 2**28 (width 8, tile 2048) for
   each set of output streams (``STREAM_ROWS``: bits, the sort_keys pass; + src; + a u32
   payload, the sort_pairs pass; + src + a u32 payload; + a 16-byte
   payload; u64 bits + a u64 payload; u64 bits + src; bits and bits + src
   on digits that fill whole aligned lines), each with its bytes, its
   bound and its share of it, four of them beside the plain version and
   torch.sort of the uint8 digits; counting sort_keys u32 and sort_pairs u32+u32 at 2**28
   (checked against torch.sort, required to launch the three counting
   kernels, stage 2 on the run sums with no run_sum_kernel in the
   profiler's trace, to call no torch.cumsum and to gather nothing:
   ``counting_engine.GATHERED``) beside torch.sort and the bitonic
   sort_keys, each with its per-stage breakdown (CUDA events at the ends
   of the engine's ``counting.*`` stage spans, through
   ``tracing.observe``). ``counting_only`` runs phases 2 (the counting
   kernels), 7 and 10 alone;
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
   each merge's route read at the engine's MARK hook; then psort_keys on
   a group of every card this process sees (CUDA_VISIBLE_DEVICES as the
   caller gave it, card 0 alone where it is not set), up to 4, one
   process a card over NCCL (``phase_psort_group``): 2**28 zipf keys a
   rank, each rank's share bit-equal to its slice of the sorted keys of
   every rank, and each psort step's device time from CUDA events at the edges of its
   span (``tracing.observe``), with the bytes the ring carried and the
   counters psort.wire_bytes and psort.host_reads; alone, on four cards:
   ``CUDA_VISIBLE_DEVICES=0,1,2,3 python3 -c "import chip_smoke as c;
   c.phase_psort_group(c.card_line())"``;
12. the harness layer in process, on phase 11's group: the bench
   (``tinyhipradixsort_torch.bench``) at 2**28 and at the reference's
   u32Large n = 2**31 + 100 (unittest.cpp:688-717), each with --verify full
   (bit-exact against the host oracle) and its JSON line, its engine (the
   one ``sort._resolve_method`` names: counting, with no network route
   read at MARK), peak device memory, the oracle's time and the process's
   peak host memory, the host's memory printed before the u32Large step;
   the matrix (``benchmarks.full``) through bitonic, counting and auto at
   1M-256M by the host's clock beside torch.sort, with the size from which
   counting beats the network in every 1-D workload (``crossover``, the
   table that places ``sort.AUTO_COUNTING_MIN_N``; alone: ``python3 -c
   "import chip_smoke as c; c.crossover(c.card_line())"``);
   ``tools.verify_baseline`` (2**28 u64+u64 pairs);
   ``tools.nonpow2_sweep --big`` (each case exact and on its route);
   ``tools.drive --iters 8``; the three examples (soak with --iters 2);
   ``entry``; ``benchmarks.scaling`` at world size 1;
   ``tools.baseline_scale``; and the counting engine through the bench at
   2**28 (--method counting, --verify full) and ``tools.drive --method
   counting``, each required to launch the bucket-scan and
   rank-and-scatter kernels. Each step raises on a failure.

The line before the last is the kernel report, {"kernels": [...]}; the last
line is {"ok": true, "device": {...}}. Any failure raises and exits non-zero
without a result; so does a machine without CUDA. ``timing_only()`` runs
phases 5 and 6 alone (see there). ``rank_scatter_ab(PATH)`` times another
commit's rank_scatter.cu against this tree's in turns (see there).
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import re
import resource
import socket
import statistics
import subprocess
import sys
import time
import traceback
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
from tinyhipradixsort_torch import sort as sort_mod  # noqa: E402
from tinyhipradixsort_torch import tracing  # noqa: E402
from tinyhipradixsort_torch.ops import bitonic_engine as be  # noqa: E402
from tinyhipradixsort_torch.ops import counting_engine  # noqa: E402
from tinyhipradixsort_torch.ops import cuda_lib  # noqa: E402
from tinyhipradixsort_torch.ops import histogram as hist  # noqa: E402
from tinyhipradixsort_torch.ops import network_engine  # noqa: E402
from tinyhipradixsort_torch.parallel import dryrun  # noqa: E402
from tinyhipradixsort_torch.parallel import multihost  # noqa: E402
from tinyhipradixsort_torch.parallel import psort  # noqa: E402
from tinyhipradixsort_torch.tools import H100_BYTES_PER_S  # noqa: E402
from tinyhipradixsort_torch.tools import H100_INT_OPS_PER_S  # noqa: E402
from tinyhipradixsort_torch.tools import card as card_line  # noqa: E402
from tinyhipradixsort_torch.tools import cuda_ms  # noqa: E402
from tinyhipradixsort_torch.tools import gather_floor as gf  # noqa: E402
from tinyhipradixsort_torch.tools import partition_dma_floor as pdf  # noqa: E402
from tinyhipradixsort_torch.utils import native_oracle  # noqa: E402
from tinyhipradixsort_torch.utils import trace  # noqa: E402

SEED = 20260
#: the phases that time or check the bitonic network name it: ``"auto"``
#: runs the counting engine on large 1-D keys
NET = "bitonic"
#: kernel (its source is csrc/<name>.cu) -> the TPU kernel it replaces
KERNELS = {
    "bitonic_sweep": "tinyhipradixsort_tpu/ops/bitonic_engine.py:267",
    "digit_histogram": "tinyhipradixsort_tpu/ops/histogram.py:38",
    "bucket_scan": "no TPU kernel: XLA cumsum of stage 2, "
                   "tinyhipradixsort_tpu/ops/histogram.py:91",
    "rank_scatter": "no TPU kernel: jnp stage 3, "
                    "tinyhipradixsort_tpu/ops/counting_engine.py:35",
    "gather_floor": "tools/gather_floor.py:43",
    "partition_scatter": "tools/partition_dma_floor.py:43",
}


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
            out = thrs.sort_keys(xd, method=NET, **kw)
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
            k, vals = thrs.sort_pairs(xd, vd, order=order, method=NET, **kw)
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
            perm = thrs.sort_indices(xd, method=NET)
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
            out = (thrs.sort_pairs(xd, vd, method=NET) if with_values
                   else (thrs.sort_keys(xd, method=NET),))
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
            k, vals = thrs.sort_pairs(xd, vd, segment_ids=seg, method=NET)
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
            out = thrs.sort_keys(xd, method=NET)
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
            k, vals = thrs.sort_pairs(xd, vd, stable=False, method=NET)
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
    sort_ms = cuda_ms(lambda: thrs.sort_keys(x, method=NET), 5)
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
        sort_ms = cuda_ms(lambda: thrs.sort_pairs(keys, vals, method=NET), 5)
        log("5 timing", f"sort_pairs {label} n=2**24: {sort_ms:.3f} ms "
            f"({n / sort_ms / 1e6:.4f} Gpairs/s); median of 5, CUDA events; "
            f"card: {card}")
        sweeps, med = sweep_times(
            lambda: thrs.sort_pairs(keys, vals, method=NET))
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
            ms = cuda_ms(lambda: thrs.sort_pairs(x, v, method=NET), 5)
            count_ms = cuda_ms(
                lambda: thrs.sort_pairs(x, v, method="counting"), 5)

            def library():
                _, idx = torch.sort(signed, dim=-1, stable=True)
                return torch.take_along_dim(v, idx, dim=-1)
        else:
            ms = cuda_ms(lambda: thrs.sort_keys(x, method=NET), 5)
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
    fast = cuda_ms(lambda: thrs.sort_pairs(keys, vals, stable=False,
                                           method=NET), 5)
    stable = cuda_ms(lambda: thrs.sort_pairs(keys, vals, method=NET), 5)
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


#: Itanium-mangled template type arguments, as the report names them
_MANGLED_TYPES = {"j": "u32", "y": "u64", "i": "i32", "x": "i64"}


def ptxas_report(text: str) -> list:
    """(kernel, registers, spills) for each entry function in the output
    of ``nvcc -Xptxas -v``; a template's word count is shown as <NW>, its
    type arguments as <u32,i32>."""
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
            ty = re.match(r"I([jyix]+)E", m.group(2)[int(m.group(1)):]
                          if m else "")
            name += (f"<{t.group(1)}>" if t else
                     f"<{','.join(_MANGLED_TYPES[c] for c in ty.group(1))}>"
                     if ty else "")
        elif "spill" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln:
            regs = ln.split(":", 1)[-1].strip()
    if name:
        rows.append((name, regs, spill))
    return rows


#: the sweep kernel's register-body instantiations on the main path (u32
#: keys, u32 pairs, u64 pairs) and the rank-and-scatter kernel's (u32/u64
#: bits, int32/int64 src): ptxas must report no spill bytes for them
NO_SPILL = ("sweep_registers<1>", "sweep_registers<3>", "sweep_registers<5>",
            "rank_scatter_kernel<u32,i32>", "rank_scatter_kernel<u32,i64>",
            "rank_scatter_kernel<u64,i32>", "rank_scatter_kernel<u64,i64>")


def phase_build(libs=tuple(KERNELS)) -> None:
    t0 = time.perf_counter()
    cuda_lib.build(list(libs))
    wall = time.perf_counter() - t0
    spills = {}
    for lib in libs:
        cuda_lib.load(lib)
        info = cuda_lib.BUILD_INFO[lib]
        log("2 build", f"{lib}: nvcc {info['seconds']:.3f} s -> "
            f"{info['path']}")
        for name, regs, spill in ptxas_report(info["log"]):
            log("2 build", f"{lib}: {name}: {regs}; {spill}")
            spills[name] = spill
    log("2 build", f"{len(libs)} libraries in {wall:.3f} s (parallel)")
    for name in NO_SPILL:
        if name.split("<")[0] not in {n.split("<")[0] for n in spills}:
            continue  # a library this call did not build
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


def histogram_runs_cases():
    """(n, wide, shift, width, tile, rows, kind) for digit_histogram_runs;
    kind "random" or "one" (every element's digit the same)."""
    w = 2048
    cases = [(1 << 28, False, 0, 8, w, 1, "random")]  # the sort_keys pass
    cases += [(3 * 300 * w, False, 4, width, w, 3, "random")  # short last run
              for width in range(1, 9)]
    # rows of 127, 128 and 129 tiles around the run of 128 tiles
    cases += [(2 * tiles * w, False, 8, 8, w, 2, "random")
              for tiles in (127, 128, 129)]
    cases += [(2 * 200 * w, True, 40, 8, w, 2, "random"),  # u64 bits
              ((1 << 20) + 777, False, 0, 8, w, 1, "random"),  # ragged n
              ((1 << 20) + 777, True, 56, 8, w, 1, "random"),
              (1 << 24, False, 0, 8, w, 1, "one"),
              (4096 * 2 * w, False, 0, 8, w, 4096, "random"),  # rows cells
              (16384 * w, False, 0, 8, w, 16384, "random"),
              (3 * 1000 * 3072, False, 16, 8, 3072, 3, "random"),
              # tiles split between the CTAs of a cluster (16384 elements
              # a CTA at least): 20480 and 65536 straddle two, 2**22 spans 8
              (1 << 24, False, 0, 8, 20480, 1, "random"),
              ((1 << 24) + 3000, False, 0, 8, 65536, 1, "random"),
              (1 << 25, True, 8, 8, 1 << 22, 2, "random"),
              ((1 << 23) + 5, False, 24, 3, 1 << 22, 1, "random")]
    return cases


def phase_histogram_runs() -> int:
    """digit_histogram_runs through its kernel and through its plain
    version: the counts and the run sums bit-equal."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 72)
    worst = 0
    for n, wide, shift, width, tile, R, kind in histogram_runs_cases():
        bits = (torch.full((n,), 0x5A5A5A5A, dtype=torch.int32, device="cuda")
                if kind == "one" else _random_bits(n, wide, gen))
        T = -(-n // hist.round_tile(tile))
        before = hist.RUN_LAUNCHES
        counts, sums = hist.digit_histogram_runs(bits, shift, width, tile,
                                                 T // R)
        if hist.RUN_LAUNCHES != before + 1:
            raise AssertionError("digit_histogram_runs did not launch its "
                                 "kernel")
        want_c, want_s = hist.digit_histogram_runs_reference(
            bits, shift, width, tile, T // R)
        torch.cuda.synchronize()
        err = max(int((counts.long() - want_c.long()).abs().max()),
                  int((sums - want_s).abs().max()))
        ok = torch.equal(counts, want_c) and torch.equal(sums, want_s)
        log("7 histogram-runs-vs-plain",
            f"{'u64' if wide else 'u32'} n={n} shift={shift} width={width} "
            f"tile={tile} rows={R} {kind}: counts {tuple(counts.shape)}, run "
            f"sums {tuple(sums.shape)} (runs of "
            f"{hist.run_tiles(T // R, hist.round_tile(tile))} tiles) "
            f"max_abs_err={err} {'bit-equal' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"run-sum histogram kernel != plain version "
                                 f"(n={n} shift={shift} width={width} "
                                 f"tile={tile} rows={R} {kind})")
        worst = max(worst, err)
        del bits, counts, sums, want_c, want_s
    torch.cuda.empty_cache()
    return worst


def _stage2(bits: torch.Tensor, shift: int, width: int, tile: int, rows: int,
            idx_dt: torch.dtype) -> torch.Tensor:
    """The counting engine's stage 2 for ``rows`` rows of whole tiles by
    the plain versions (histogram and bucket scan); ``(rows, tiles per row,
    2**width)`` in ``idx_dt``."""
    counts = hist.digit_histogram_reference(bits, shift, width, tile)
    return hist.bucket_offsets_reference(
        counts.view(rows, counts.shape[0] // rows, counts.shape[1]), tile,
        idx_dt)


def _tile_counts(rows: int, Tr: int, width: int, tile: int, kind: str,
                 gen: torch.Generator) -> torch.Tensor:
    """(rows, Tr, 2**width) int32 counts on the card whose tiles each sum
    to ``tile``: random cut points, or every element in one bucket."""
    nb = 1 << width
    if kind == "one":
        counts = torch.zeros((rows, Tr, nb), dtype=torch.int32, device="cuda")
        counts[:, :, nb // 3] = tile
        return counts
    cuts = torch.randint(0, tile + 1, (rows, Tr, nb - 1), generator=gen,
                         device="cuda").sort(dim=-1).values
    edges = torch.cat([torch.zeros_like(cuts[..., :1]), cuts,
                       torch.full_like(cuts[..., :1], tile)], dim=-1)
    return edges.diff(dim=-1).to(torch.int32)


def bucket_scan_cases():
    """(rows, tiles per row, width, tile, idx_dt, kind); kind "keys" is
    the histogram of the bench keys (the sort_keys pass at 2**28), with
    its run sums from the kernel."""
    i32, i64 = torch.int32, torch.int64
    cases = [(1, (1 << 28) // 2048, 8, 2048, i32, "keys"),
             (1, (1 << 28) // 2048, 8, 2048, i64, "keys")]
    # rows of 1030, 300 and 130 tiles: several chunks, the last one short
    cases += [(R, {1: 1030, 3: 300, 64: 130}[R], width, tile, i32, "random")
              for width in range(1, 9) for tile in (1024, 2048, 2176)
              for R in (1, 3, 64)]
    cases += [(1, 1030, 8, 2048, i64, "random"),
              (2, 127, 8, 2048, i32, "random"),  # a row is one chunk
              (2, 128, 8, 2048, i64, "random"),
              (2, 129, 8, 2048, i32, "random"),  # a chunk of 1 tile
              (5, 257, 3, 2048, i64, "random"),
              (64, 2, 8, 2048, i32, "random"),
              (3, 300, 8, 2048, i64, "one"),      # the other buckets empty
              (3, 5, 8, 2048, i32, "one")]
    return cases


def phase_bucket_scan(x: torch.Tensor) -> int:
    """The bucket-scan kernel against its plain version on both routes
    (given the run sums: the counts read once; and without), bit-equal and
    contiguous as written. Returns the largest absolute difference (0)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 71)
    worst = 0
    for R, Tr, width, tile, idx_dt, kind in bucket_scan_cases():
        if kind == "keys":
            counts, sums = hist.digit_histogram_runs(x.view(torch.int32), 0,
                                                     width, tile, Tr)
            counts = counts.view(R, Tr, 1 << width)
        else:
            counts = _tile_counts(R, Tr, width, tile, kind, gen)
            sums = hist.run_sums_reference(counts, tile)
        want = hist.bucket_offsets_reference(counts, tile, idx_dt)
        for route in ("run sums", "counts alone"):
            before = (hist.SCAN_LAUNCHES, hist.SCAN_SUM_WALKS)
            got = hist.bucket_offsets(
                counts, tile, idx_dt,
                run_sums=sums if route == "run sums" else None)
            walks = hist.SCAN_SUM_WALKS - before[1]
            if (hist.SCAN_LAUNCHES != before[0] + 1 or walks != (
                    route == "counts alone" and Tr > hist.run_tiles(Tr,
                                                                    tile))):
                raise AssertionError(f"bucket_offsets ({route}) did not "
                                     f"launch its kernel's route")
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            ok = (got.dtype == idx_dt and got.is_contiguous()
                  and torch.equal(got, want))
            log("7 bucket-scan-vs-plain",
                f"rows={R} tiles={Tr} width={width} tile={tile} "
                f"{str(idx_dt)[6:]} {kind}, {route}: max_abs_err={err} "
                f"{'bit-equal' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(f"bucket scan kernel != plain version "
                                     f"(rows={R} tiles={Tr} width={width} "
                                     f"tile={tile} {idx_dt} {kind}, {route})")
            worst = max(worst, err)
        del counts, sums, got, want
    torch.cuda.empty_cache()
    return worst


def _payloads(n: int, row_bytes, gen: torch.Generator) -> list:
    """Random payloads of n rows on the card, one per entry of row_bytes
    (1: uint8, 2: int16, 4: int32, 8: int64, 16: an (n, 4) int32 leaf)."""
    out = []
    for rb in row_bytes:
        shape = (n, 4) if rb == 16 else (n,)
        dt = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64,
              16: torch.int32}[rb]
        lo, hi = (0, 256) if rb == 1 else (-2**15, 2**15) if rb == 2 else \
            (-2**31, 2**31)
        t = torch.randint(lo, hi, shape, generator=gen, device="cuda",
                          dtype=torch.int64)
        if rb == 8:
            t = (t << 32) ^ torch.randint(0, 2**32, shape, generator=gen,
                                          device="cuda", dtype=torch.int64)
        out.append(t.to(dt))
    return out


def rank_scatter_cases():
    """(n, wide, shift, width, tile, rows, idx_dt, kind, payload row
    bytes, want_src)."""
    i32, i64 = torch.int32, torch.int64
    return [
        # the main path's passes: sort_keys (the bits alone: no payload,
        # no src; the keys come back from the sorted bits), sort_pairs
        # u32+u32 (the values as one 4-byte payload), and two payloads
        (1 << 28, False, 0, 8, 2048, 1, i32, "random", (), False),
        (1 << 28, False, 0, 8, 2048, 1, i32, "random", (4,), False),
        (1 << 28, False, 24, 8, 2048, 1, i32, "random", (4, 4), False),
        (1 << 28, False, 0, 8, 2048, 1, i32, "random", (), True),  # src
        (1 << 24, False, 8, 8, 2048, 1, i32, "random", (1, 2, 4, 8), True),
        (1 << 24, False, 16, 8, 2048, 1, i64, "random", (16, 4, 16, 1), True),
        (1 << 26, True, 56, 8, 2048, 1, i32, "random", (8,), False),  # u64
        (1 << 24, False, 29, 3, 2048, 1, i32, "random", (4,), True),  # 3 bits
        (1 << 20, False, 0, 1, 2048, 1, i32, "random", (2,), False),  # 1 bit
        # rows of 1030 tiles: their last chunk holds 2 tiles, not 4
        (3 * 1030 * 2048, False, 8, 8, 2048, 3, i32, "random", (4, 16), False),
        (5 * 9 * 1024, False, 0, 8, 1024, 5, i32, "padded", (4,), True),
        (3 * 6 * 1024, True, 8, 8, 1024, 3, i64, "random", (16, 8), True),
        (1 << 24, True, 0, 8, 1 << 20, 4, i64, "random", (16,), True),
        (3072 << 12, False, 24, 8, 3072, 1, i32, "random", (2,), True),
        (1 << 22, False, 0, 8, 2048, 1, i32, "one", (4,), False),
        (1 << 22, False, 0, 8, 2048, 1, i32, "two", (8,), True)]


def phase_rank_scatter() -> int:
    """The rank-and-scatter kernel against its plain version: the bits,
    ``src`` and every payload bit-equal. Returns the largest absolute
    difference (0)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 77)
    worst = 0
    for (n, wide, shift, width, tile, rows, idx_dt, kind, row_bytes,
         want_src) in rank_scatter_cases():
        bits = _random_bits(n, wide, gen)
        if kind == "one":
            bits[:] = bits[0].item()
        elif kind == "two":
            bits = torch.where(bits < 0, bits[0], ~bits[0])
        elif kind == "padded":  # each row's tail all ones, as the engine pads
            bits.view(rows, -1)[:, -(tile // 2 + 17):] = -1
        payloads = _payloads(n, row_bytes, gen)
        base = _stage2(bits, shift, width, tile, rows, idx_dt)
        before = counting_engine.KERNEL_LAUNCHES
        got = counting_engine.rank_scatter(bits, shift, width, base, tile,
                                           idx_dt, payloads, want_src)
        if counting_engine.KERNEL_LAUNCHES != before + 1:
            raise AssertionError("rank_scatter did not launch its kernel")
        want = counting_engine.rank_scatter_reference(
            bits, shift, width, base, tile, idx_dt, payloads, want_src)
        torch.cuda.synchronize()
        pairs = [(got[0], want[0])] + list(zip(got[2], want[2]))
        if want_src:
            pairs.append((got[1], want[1]))
        err = max(int((a.long() - b.long()).abs().max()) for a, b in pairs)
        ok = ((got[1] is None) != want_src
              and all(a.dtype == b.dtype and torch.equal(a, b)
                      for a, b in pairs))
        log("7 rank-scatter-vs-plain",
            f"{'u64' if wide else 'u32'} n={n} shift={shift} width={width} "
            f"tile={tile} rows={rows} src "
            f"{str(idx_dt)[6:] if want_src else 'not written'} payload rows "
            f"{list(row_bytes)} B {kind}: max_abs_err={err} "
            f"{'bit-equal' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"rank_scatter kernel != plain version "
                                 f"(n={n} shift={shift} width={width} "
                                 f"tile={tile} rows={rows} {kind} payloads "
                                 f"{row_bytes} want_src={want_src})")
        worst = max(worst, err)
        del bits, base, got, want, pairs, payloads
        torch.cuda.empty_cache()
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


def phase_portable() -> tuple[int, int, int]:
    """Returns the histogram's, the bucket scan's and the rank-and-scatter
    kernel's launches."""
    rng = np.random.default_rng(SEED + 8)
    hist.KERNEL_LAUNCHES = 0
    hist.SCAN_LAUNCHES = 0
    counting_engine.KERNEL_LAUNCHES = 0
    for label, method, run in portable_cases():
        before = hist.KERNEL_LAUNCHES
        scan_before = hist.SCAN_LAUNCHES
        walks = hist.SCAN_SUM_WALKS
        rs_before = counting_engine.KERNEL_LAUNCHES
        gathered = counting_engine.GATHERED
        secs, check = run(rng)
        launches = hist.KERNEL_LAUNCHES - before
        scan_launches = hist.SCAN_LAUNCHES - scan_before
        rs_launches = counting_engine.KERNEL_LAUNCHES - rs_before
        gathered = counting_engine.GATHERED - gathered
        ok = check()
        log("8 portable-path", f"method={method} {label}: {secs * 1e3:.3f} ms "
            f"(host clock, synchronized) histogram launches={launches} "
            f"bucket_scan launches={scan_launches} "
            f"rank_scatter launches={rs_launches} gathered={gathered} "
            f"{'bit-exact' if ok else 'MISMATCH'} vs numpy oracle")
        if method == "counting" and gathered:
            raise AssertionError(f"the counting engine gathered {gathered} "
                                 f"arrays it should carry: {label}")
        if hist.SCAN_SUM_WALKS != walks:
            raise AssertionError(f"the counting engine launched a summing "
                                 f"walk: {label}")
        torch.cuda.empty_cache()
        if not ok:
            raise AssertionError(f"portable path output wrong: {method} {label}")
        if method == "counting" and 0 in (launches, scan_launches,
                                          rs_launches):
            raise AssertionError(f"counting path did not launch the "
                                 f"histogram, bucket_scan and rank_scatter "
                                 f"kernels: {label}")
    return (hist.KERNEL_LAUNCHES, hist.SCAN_LAUNCHES,
            counting_engine.KERNEL_LAUNCHES)


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
        log("9 probes", f"gather_floor {gf.describe(r)} to the plain version;"
            f" median of 5, CUDA events; card: {card}")
    log("9 probes", f"device-memory gather src[perm] of 2**28 u32 (the "
        f"counting engine's gather of each array): {dev['ms']:.6f} ms -> "
        f"{dev['gelems_per_s']:.4f} Gelem/s, {dev['tb_per_s']:.4f} TB/s "
        f"(bound {dev['bound_ms']:.6f} ms); median of 5, CUDA events; "
        f"card: {card}")
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
    return g_rate, s1k, g_launches, s_launches


# ---------------------------------------------------------------------------
# phase 10: timing of the histogram and of the counting sort
# ---------------------------------------------------------------------------


def phase_histogram_timing(x: torch.Tensor, card: str) -> dict:
    """The histogram at 2**28 u32, width 8, at the counting engine's tile
    (2048, the main path's shape) and the default tile (8192); at 2048 also
    with its run sums (digit_histogram_runs, what the counting engine
    launches), a call and the kernel alone in turns with digit_histogram.
    Returns the run-sum kernel's numbers for the report."""
    bits = x.view(torch.int32)
    n = bits.shape[0]
    tile = counting_engine.DEFAULT_TILE
    T = n // tile

    def plain():
        return hist.digit_histogram(bits, 0, 8, tile)

    def runs():
        return hist.digit_histogram_runs(bits, 0, 8, tile, T)

    calls = [cuda_ms(f, 10) for f in (plain, runs, runs, plain)]
    alone = [_kernels_alone(f, (name,), 10)[name] for f, name in (
        (plain, "digit_histogram_smem_kernel"),
        (runs, "digit_histogram_runs_kernel"),
        (runs, "digit_histogram_runs_kernel"),
        (plain, "digit_histogram_smem_kernel"))]
    runs_plain_ms = cuda_ms(
        lambda: hist.digit_histogram_runs_reference(bits, 0, 8, tile, T), 5)
    sums_numel = hist.digit_histogram_runs(bits, 0, 8, tile, T)[1].numel()
    moved = 4 * n + 4 * T * 256 + 8 * sums_numel
    bound_ms = moved / H100_BYTES_PER_S * 1e3
    log("10 timing", f"digit_histogram_runs u32 n=2**28 width=8 tile={tile} "
        f"(run sums {sums_numel} int64): digit_histogram / runs / runs / "
        f"digit_histogram a call {' / '.join(f'{t:.6f}' for t in calls)} ms "
        f"(median of 10, CUDA events), the kernel alone "
        f"{' / '.join(f'{t:.6f}' for t in alone)} ms (torch.profiler, "
        f"median of 10); plain version {runs_plain_ms:.6f} ms; bound "
        f"{bound_ms:.6f} ms ({moved} bytes at 3.35 TB/s; a call at "
        f"{100 * bound_ms / statistics.median(calls[1:3]):.1f}% of it); "
        f"card: {card}")
    result = {"ms": statistics.median(calls[1:3]), "plain_ms": runs_plain_ms,
              "bytes": moved}
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
        result.setdefault("library_ms", library_ms)
    return result


def phase_bucket_scan_timing(x: torch.Tensor, card: str) -> dict:
    """The bucket scan at the main path's shape (the sort_keys pass's counts
    at 2**28 u32, width 8, tile 2048), int32 and int64 offsets: a call
    given stage 1's run sums (the engine's route) and without them, each
    route's kernels alone, beside its plain version, torch.cumsum of the
    bucket-major flat counts and its bound. Returns the engine route's
    int32 numbers for the report. The kernel scans the run sums in place, so the timed calls
    after the first scan sums already scanned: the work and the bytes do
    not depend on their values (the sums wrap as unsigned)."""
    tile = counting_engine.DEFAULT_TILE
    counts, sums = hist.digit_histogram_runs(x.view(torch.int32), 0, 8, tile,
                                             x.shape[0] // tile)
    counts = counts.view(1, *counts.shape)
    fresh = sums.clone()
    flat = counts[0].t().contiguous().view(-1)  # the reference's counters
    library_ms = cuda_ms(lambda: torch.cumsum(flat, 0, dtype=torch.int32), 20)
    del flat
    result = None
    for idx_dt in (torch.int32, torch.int64):
        want = hist.bucket_offsets_reference(counts, tile, idx_dt)
        sums.copy_(fresh)
        if not torch.equal(hist.bucket_offsets(counts, tile, idx_dt,
                                               run_sums=sums), want):
            raise AssertionError("bucket_offsets with run sums != plain")
        del want
        ms = cuda_ms(lambda: hist.bucket_offsets(counts, tile, idx_dt,
                                                 run_sums=sums), 20)
        bare_ms = cuda_ms(lambda: hist.bucket_offsets(counts, tile, idx_dt),
                          20)
        plain_ms = cuda_ms(
            lambda: hist.bucket_offsets_reference(counts, tile, idx_dt), 5)
        alone = _kernels_alone(lambda: hist.bucket_offsets(
            counts, tile, idx_dt, run_sums=sums), SCAN_KERNELS, 10)
        bare = _kernels_alone(lambda: hist.bucket_offsets(
            counts, tile, idx_dt), SCAN_BARE_KERNELS, 10)
        moved = counts.numel() * (4 + idx_dt.itemsize) + 8 * sums.numel()
        bound_ms = moved / H100_BYTES_PER_S * 1e3
        for route, times in (("run sums", alone), ("counts alone", bare)):
            log("10 timing", f"bucket_scan u32 n=2**28 width=8 tile={tile} "
                f"{str(idx_dt)[6:]}, {route}: the kernels alone "
                f"(torch.profiler, median of 10) "
                + ", ".join(f"{k} {v:.6f} ms" for k, v in times.items())
                + f", {sum(times.values()):.6f} ms in all "
                f"({100 * bound_ms / sum(times.values()):.1f}% of the "
                f"bound); card: {card}")
        log("10 timing", f"bucket_scan u32 n=2**28 width=8 tile={tile} "
            f"{str(idx_dt)[6:]}: a call with the run sums {ms:.6f} ms "
            f"({moved / ms / 1e9:.4f} TB/s), without {bare_ms:.6f} ms, plain "
            f"version {plain_ms:.6f} ms, torch.cumsum of the bucket-major "
            f"int32 counts {library_ms:.6f} ms, bound {bound_ms:.6f} ms "
            f"({moved} bytes: counts and run sums read, offsets written, at "
            f"3.35 TB/s; a call with the run sums at "
            f"{100 * bound_ms / ms:.1f}% of it); median of 20 (plain: 5), "
            f"CUDA events; card: {card}")
        if result is None:
            result = {"ms": ms, "plain_ms": plain_ms, "bytes": moved,
                      "ops": counts.numel(), "library_ms": library_ms}
    del counts, sums, fresh
    torch.cuda.empty_cache()
    return result


#: the bucket scan's kernels given the run sums, in launch order (rows of
#: one run take the last alone), and without them
SCAN_KERNELS = ("run_scan_kernel", "run_write_kernel")
SCAN_BARE_KERNELS = ("run_sum_kernel", "run_scan_kernel", "run_write_kernel")


def _kernels_alone(fn, names, reps: int) -> dict:
    """Median device time in ms of each kernel of ``names`` that ``fn()``
    launches, over ``reps`` calls, as ``torch.profiler`` traces them (the
    kernels alone, without the host's enqueue or the gaps between them)."""
    fn()
    torch.cuda.synchronize()
    with trace() as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = {name: [] for name in names}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CPU:
            continue
        for name in names:
            if name in ev.name:
                times[name].append(ev.time_range.elapsed_us() / 1e3)
    missing = [name for name, t in times.items() if not t]
    if missing:
        raise AssertionError(f"the profiler traced no {missing}")
    return {name: statistics.median(t) for name, t in times.items()}


#: the rank-and-scatter kernel's integer operations per element at width
#: w: the digit (a shift and a mask), w ballots and w selects for the peers,
#: two popcounts and an add for the rank, three adds and the digit again to
#: place it, two adds and the digit once more to write it
def rank_scatter_ops(width: int) -> int:
    return 2 * width + 14


#: phase 10's stream table at 2**28 words, width 8, tile 2048: (label,
#: keys, payload row bytes, want_src). Keys "u32" and "u64" are random;
#: "runs" are u32 whose digits each fill a whole aligned 128-byte line of
#: every output stream a chunk (digit (97 i) mod 256: each digit 32 times in
#: every 8192 words), so no write is a partial sector. The first row is the
#: sort_keys pass (the bits alone: no payload, no src), the third the
#: sort_pairs u32+u32 pass (the values as one payload), the second the
#: outputs of the kernel before payloads.
STREAM_ROWS = [("bits", "u32", (), False),
               ("bits + src", "u32", (), True),
               ("bits + 1 u32 payload", "u32", (4,), False),
               ("bits + src + 1 u32 payload", "u32", (4,), True),
               ("bits + 1 16-byte payload", "u32", (16,), False),
               ("u64 bits + 1 u64 payload", "u64", (8,), False),
               ("u64 bits + src", "u64", (), True),
               ("bits, whole-line runs", "runs", (), False),
               ("bits + src, whole-line runs", "runs", (), True)]


def rank_scatter_bytes(n: int, word_bytes: int, row_bytes, want_src: bool,
                       base_numel: int, idx_bytes: int = 4) -> int:
    """Bytes one call must move: the bits and each payload row read and
    written once, base read once, src written once if it is."""
    return (2 * n * (word_bytes + sum(row_bytes)) + idx_bytes * base_numel
            + (idx_bytes * n if want_src else 0))


def phase_rank_scatter_timing(x: torch.Tensor, card: str) -> dict:
    """One pass of the rank-and-scatter kernel at the main path's shape
    (2**28 words, shift 0, width 8, tile 2048) for each set of output
    streams of STREAM_ROWS, with its bytes, its bound and its share of it;
    the sort_keys and sort_pairs passes, bits + src and u64 bits + src
    also beside the plain version and torch.sort of the digits as uint8
    (whose indices are src for one row). Returns the sort_keys pass's
    numbers (the "bits" row) for the report."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 10)
    tile, width, n = counting_engine.DEFAULT_TILE, 8, x.shape[0]
    words = {"u32": x.view(torch.int32)}
    result = None
    for label, keys, row_bytes, want_src in STREAM_ROWS:
        if keys not in words:
            words.clear()
            torch.cuda.empty_cache()
            words[keys] = (_random_bits(n, True, gen) if keys == "u64" else
                           ((torch.arange(n, device="cuda") * 97) & 255)
                           .to(torch.int32))
        bits = words[keys]
        base = _stage2(bits, 0, width, tile, 1, torch.int32)
        payloads = _payloads(n, row_bytes, gen)
        args = (bits, 0, width, base, tile, torch.int32, payloads, want_src)
        ms = cuda_ms(lambda: counting_engine.rank_scatter(*args), 5)
        moved = rank_scatter_bytes(n, bits.dtype.itemsize, row_bytes,
                                   want_src, base.numel())
        ops = rank_scatter_ops(width) * n
        bound_ms = max(moved / H100_BYTES_PER_S,
                       ops / H100_INT_OPS_PER_S) * 1e3
        extra = ""
        row = {"ms": ms, "bytes": moved, "ops": ops, "bound_ms": bound_ms}
        if label in ("bits", "bits + src", "bits + 1 u32 payload",
                     "u64 bits + src"):
            row["plain_ms"] = cuda_ms(
                lambda: counting_engine.rank_scatter_reference(*args), 3)
            digits = (bits & 0xFF).to(torch.uint8)
            row["library_ms"] = cuda_ms(
                lambda: torch.sort(digits, stable=True), 5)
            if want_src:
                _, src, _ = counting_engine.rank_scatter(*args)
                if not torch.equal(torch.sort(digits, stable=True).indices,
                                   src.long()):
                    raise AssertionError("rank_scatter src != torch.sort's "
                                         "indices")
                del src
            del digits
            extra = (f"; plain version {row['plain_ms']:.6f} ms (median of "
                     f"3), torch.sort(uint8 digits, stable=True) "
                     f"{row['library_ms']:.6f} ms")
        log("10 streams", f"rank_scatter {label} n=2**28 width=8 tile={tile}: "
            f"kernel {ms:.6f} ms ({moved / ms / 1e9:.4f} TB/s); {moved} "
            f"bytes, bound {bound_ms:.6f} ms (3.35 TB/s; {ops} integer "
            f"operations take {ops / H100_INT_OPS_PER_S * 1e3:.6f} ms), "
            f"kernel at "
            f"{100 * bound_ms / ms:.1f}% of it{extra}; median of 5, CUDA "
            f"events; card: {card}")
        if label == "bits":
            result = row
        del base, payloads, args
    words.clear()
    torch.cuda.empty_cache()
    return result


#: rank_scatter_ab's cases at 2**28 words, width 8, tile 2048, int32 src:
#: (label, u64 bits, payload row bytes, want_src)
AB_ROWS = [("bits", False, (), False),
           ("keys as a 4-byte payload", False, (4,), False),
           ("bits + src", False, (), True),
           ("u64 bits + src", True, (), True),
           ("u64 bits + u64 payload", True, (8,), False)]


def rank_scatter_ab(parent_rs, reps: int = 5) -> dict:
    """The rank-and-scatter kernel of another commit's ``rank_scatter.cu``
    (``parent_rs``, unpacked from git) against this tree's, in turns in one
    process: ``python3 -c "import chip_smoke as c;
    c.rank_scatter_ab('PATH')"``. Both are built as the package's own is
    (``cuda_lib.NVCC_FLAGS``), and on each case of AB_ROWS timed parent,
    change, change, parent, each turn a median of ``reps`` calls by CUDA
    events through ``counting_engine.rank_scatter`` with that library in
    place of the package's, each output bit-equal to the plain version's.
    Logs, for each case and source, the turns' ms, the share of the bound,
    the blocks a SM (``thrs_rank_scatter_per_sm``, or "-" where the source
    has none) and ptxas's registers and spills; returns ``{(case, label):
    [ms, ...]}``."""
    card = card_line()
    sources = {"parent": Path(parent_rs),
               "change": cuda_lib.CSRC_DIR / "rank_scatter.cu"}
    cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}  # both nvcc at once
    for label, src in sources.items():
        so = cuda_lib.BUILD_DIR / f"librs_ab_{label}.so"
        jobs[label] = so, subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, regs = {}, {}
    for label, (so, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {label}:\n{out}")
        libs[label] = ctypes.CDLL(str(so))
        regs[label] = {name: (r, sp) for name, r, sp in ptxas_report(out)}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 25)
    tile, width, n = counting_engine.DEFAULT_TILE, 8, 1 << 28
    order = list(sources) + list(sources)[::-1]
    own = counting_engine._rank_scatter_fn
    times = {}
    try:
        for label, wide, row_bytes, want_src in AB_ROWS:
            bits = _random_bits(n, wide, gen)
            base = _stage2(bits, 0, width, tile, 1, torch.int32)
            payloads = _payloads(n, row_bytes, gen)
            args = (bits, 0, width, base, tile, torch.int32, payloads,
                    want_src)
            want = counting_engine.rank_scatter_reference(*args)
            moved = rank_scatter_bytes(n, bits.dtype.itemsize, row_bytes,
                                       want_src, base.numel())
            bound_ms = moved / H100_BYTES_PER_S * 1e3
            for src_label in order:
                fn = libs[src_label].thrs_rank_scatter
                fn.argtypes, fn.restype = own().argtypes, own().restype
                counting_engine._rank_scatter_fn = lambda fn=fn: fn
                got = counting_engine.rank_scatter(*args)
                same = (torch.equal(got[0], want[0])
                        and all(torch.equal(a, b)
                                for a, b in zip(got[2], want[2]))
                        and (not want_src or torch.equal(got[1], want[1])))
                if not same:
                    raise AssertionError(f"rank_scatter of {src_label} != "
                                         f"plain version on {label}")
                del got
                times.setdefault((label, src_label), []).append(cuda_ms(
                    lambda: counting_engine.rank_scatter(*args), reps))
            kernel = (f"rank_scatter_kernel<{'u64' if wide else 'u32'},i32>")
            for src_label, lib in libs.items():
                per_sm = "-"
                if hasattr(lib, "thrs_rank_scatter_per_sm"):
                    fn = lib.thrs_rank_scatter_per_sm
                    fn.argtypes = \
                        counting_engine._rank_scatter_per_sm_fn().argtypes
                    per_sm = fn(bits.dtype.itemsize, 4,
                                (ctypes.c_longlong * 4)(*row_bytes),
                                len(row_bytes), n, 1, tile,
                                ctypes.byref(ctypes.c_longlong()))
                ms = times[(label, src_label)]
                r, sp = regs[src_label].get(kernel, ("?", "?"))
                log("10 rank-scatter A/B",
                    f"{label} n=2**28 width=8 tile={tile}: {src_label} "
                    f"{' / '.join(f'{t:.6f}' for t in ms)} ms (turns), "
                    f"{100 * bound_ms / statistics.median(ms):.1f}% of its "
                    f"{bound_ms:.6f} ms bound; blocks a SM {per_sm}; "
                    f"{kernel}: {r}; {sp}; bit-equal to the plain version; "
                    f"card: {card}")
            del bits, base, payloads, args, want
            torch.cuda.empty_cache()
    finally:
        counting_engine._rank_scatter_fn = own
    return times


#: the counting engine's stage spans, in the order their ends come
COUNTING_STAGES = ("counting.pad", "counting.histogram", "counting.scan",
                   "counting.rank_scatter", "counting.gathers")


def _stage_breakdown(run, card: str, what: str) -> None:
    """Per-stage device time of ``run()``, which calls the counting
    engine: CUDA events at the ends of its stage spans, recorded through
    ``tracing.observe``; median of 3 after a warm-up."""
    passes = []
    for rep in range(4):
        events = []

        def mark(stage):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((stage, ev))

        def at_end(event, name, attrs):
            if event == "end" and name in COUNTING_STAGES:
                mark(name.split(".", 1)[1])

        mark("start")
        with tracing.observe(at_end):
            run()
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
        log("10 timing", f"counting {what} breakdown {stage}: {med:.3f} ms"
            + (" (4 passes)" if stage != "pad" else ""))
    log("10 timing", f"counting {what} breakdown sum {total:.3f} ms; median "
        f"of 3 after a warm-up, CUDA events at the stage spans' ends; card: "
        f"{card}")


def _route_of_counting(call) -> dict:
    """The kernels one run of ``call`` launches, by name, as
    torch.profiler traces them: the counting path must launch the run-sum
    histogram and the one-read scan, and no run_sum_kernel."""
    torch.cuda.synchronize()
    with trace() as prof:
        call()
        torch.cuda.synchronize()
    names = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CPU:
            name = ev.name.split("(")[0].split("<")[0].split()
            if name:
                names[name[-1]] = names.get(name[-1], 0) + 1
    want = ("digit_histogram_runs_kernel", "run_scan_kernel",
            "run_write_kernel", "rank_scatter_kernel")
    if any(w not in names for w in want) or "run_sum_kernel" in names:
        raise AssertionError(f"the counting path's kernels {names} are not "
                             f"{want} without run_sum_kernel")
    return {k: v for k, v in names.items() if "kernel" in k}


def phase_counting_timing(x: torch.Tensor, bitonic_ms, card: str) -> None:
    """Counting sort_keys u32 and sort_pairs u32+u32 at 2**28: bit-exact
    against torch.sort, the three counting kernels launched (stage 2 given
    stage 1's run sums: the counts read once, SCAN_SUM_WALKS unchanged,
    no run_sum_kernel in the trace), nothing gathered (the kernel carries
    the values; the keys come back from the sorted bits); timed, and
    broken down by stage as the API calls the engine."""
    n = x.shape[0]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 13)
    vals = torch.randint(-2**31, 2**31, (n,), generator=gen, device="cuda",
                         dtype=torch.int64).to(torch.int32).view(torch.uint32)
    signed = x.view(torch.int32) ^ -2**31
    srt = torch.sort(signed, stable=True)

    def no_cumsum(*args, **kwargs):
        raise AssertionError("torch.cumsum on the counting path")

    calls = [("sort_keys u32", lambda: thrs.sort_keys(x, method="counting")),
             ("sort_pairs u32+u32", lambda: thrs.sort_pairs(
                 x, vals, method="counting"))]
    for what, call in calls:
        before = (hist.KERNEL_LAUNCHES, counting_engine.KERNEL_LAUNCHES,
                  counting_engine.GATHERED, hist.SCAN_LAUNCHES,
                  hist.RUN_LAUNCHES, hist.SCAN_SUM_WALKS)
        cumsum, torch.cumsum = torch.cumsum, no_cumsum
        try:
            got = call()
        finally:
            torch.cumsum = cumsum
        keys, v = got if isinstance(got, tuple) else (got, None)
        ok = torch.equal(keys.view(torch.int32), srt.values ^ -2**31)
        if v is not None:
            ok = ok and torch.equal(v.view(torch.int32),
                                    vals.view(torch.int32)[srt.indices])
        gathered = counting_engine.GATHERED - before[2]
        log("10 timing", f"counting {what} n=2**28: "
            f"{'bit-exact' if ok else 'MISMATCH'} against torch.sort; "
            f"histogram launches={hist.KERNEL_LAUNCHES - before[0]} "
            f"(with run sums {hist.RUN_LAUNCHES - before[4]}) "
            f"bucket_scan launches={hist.SCAN_LAUNCHES - before[3]} "
            f"(with a summing walk {hist.SCAN_SUM_WALKS - before[5]}) "
            f"rank_scatter launches="
            f"{counting_engine.KERNEL_LAUNCHES - before[1]} "
            f"gathered={gathered}; no torch.cumsum")
        if not ok:
            raise AssertionError(f"counting {what} n=2**28 != torch.sort")
        if (hist.RUN_LAUNCHES == before[4]
                or hist.SCAN_LAUNCHES == before[3]
                or counting_engine.KERNEL_LAUNCHES == before[1]):
            raise AssertionError(f"counting {what} did not launch the "
                                 f"histogram, bucket_scan and rank_scatter "
                                 f"kernels")
        if hist.SCAN_SUM_WALKS != before[5]:
            raise AssertionError(f"counting {what} launched a summing walk")
        log("10 timing", f"counting {what} n=2**28: kernels in one call "
            f"(torch.profiler) {_route_of_counting(call)}")
        if gathered:
            raise AssertionError(f"counting {what} gathered {gathered} "
                                 f"arrays")
        del got, keys, v
        ms = cuda_ms(call, 5)
        log("10 timing", f"counting {what} n=2**28: {ms:.3f} ms "
            f"({n / ms / 1e6:.4f} Gkeys/s); median of 5, CUDA events; card: "
            f"{card}")
    del srt
    yard_ms = cuda_ms(lambda: torch.sort(signed, stable=True), 5)
    del signed
    log("10 timing", f"torch.sort(stable=True) u32 n=2**28 {yard_ms:.3f} ms; "
        f"bitonic sort_keys (phase 5) "
        f"{'not run' if bitonic_ms is None else f'{bitonic_ms:.3f} ms'}; "
        f"card: {card}")
    bits = keybits.key_bits(x)
    _stage_breakdown(lambda: counting_engine.sort_arrays_counting(
        bits, [], 0, 32, with_bits=True), card, "sort_keys u32")
    _stage_breakdown(lambda: counting_engine.sort_arrays_counting(
        bits, [vals], 0, 32, with_bits=True), card, "sort_pairs u32+u32")
    del bits, vals
    torch.cuda.empty_cache()


def counting_only() -> None:
    """Phases 1, 2 (the counting kernels only), 7 (run sums, bucket scan
    and rank-and-scatter) and 10 alone: ``python3 -c "import chip_smoke as
    c; c.counting_only()"``."""
    card = card_line()
    print(card, flush=True)
    phase_build(["digit_histogram", "bucket_scan", "rank_scatter"])
    x = bench_keys()
    t0 = time.perf_counter()
    err = phase_histogram_runs()
    log("7 histogram-runs-vs-plain", f"all cases bit-equal in "
        f"{time.perf_counter() - t0:.3f} s, max_abs_err={err}")
    t0 = time.perf_counter()
    err = phase_bucket_scan(x)
    log("7 bucket-scan-vs-plain", f"all cases bit-equal in "
        f"{time.perf_counter() - t0:.3f} s, max_abs_err={err}")
    t0 = time.perf_counter()
    err = phase_rank_scatter()
    log("7 rank-scatter-vs-plain", f"all cases bit-equal in "
        f"{time.perf_counter() - t0:.3f} s, max_abs_err={err}")
    phase_histogram_timing(x, card)
    phase_bucket_scan_timing(x, card)
    phase_rank_scatter_timing(x, card)
    phase_counting_timing(x, None, card)


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
                       lambda: thrs.sort_keys(xd, method=NET), True),
        "psort_keys descending": (
            lambda: thrs.psort_keys(xd, order="descending"),
            lambda: thrs.sort_keys(xd, order="descending", method=NET), True),
        "psort_keys _force_wide": (
            lambda: thrs.psort_keys(xd, _force_wide=True),
            lambda: thrs.sort_keys(xd, method=NET), True),
        "psort_pairs": (lambda: thrs.psort_pairs(xd, vd),
                        lambda: thrs.sort_pairs(xd, vd, method=NET), False),
        "psort_indices": (lambda: thrs.psort_indices(xd),
                          lambda: thrs.sort_indices(xd, method=NET), False),
        "psort_indices _force_wide": (
            lambda: thrs.psort_indices(xd, _force_wide=True),
            lambda: thrs.sort_indices(xd, method=NET), False),
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
    psort's own capacities: the local sort of B (key, index) tuples on the
    network, then on counting (the zipf keys, then uniform ones), then
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

    want = _lexsorted(words)
    srt = measure("local sort of B", lambda: be.sort_words(words, [])[0],
                  want)
    # the engine "auto" takes from AUTO_COUNTING_MIN_N: the key word
    # sorted alone, the ascending index carried; on the zipf keys, then
    # on uniform keys of the same shape (rank_scatter under skew)
    measure("local sort of B on counting, zipf keys",
            lambda: psort._local_sort_words(words, [], "counting",
                                            sort_bits=[32, 0])[0], want)
    del want
    uniform = [torch.randint(-2**31, 2**31, (B,), generator=gen,
                             device="cuda", dtype=torch.int64)
               .to(torch.int32), words[1]]
    measure("local sort of B on counting, uniform keys",
            lambda: psort._local_sort_words(uniform, [], "counting",
                                            sort_bits=[32, 0])[0],
            _lexsorted(uniform))
    del keys, words, uniform
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


#: psort's spans, in the order a call opens them (psort.merge inside the
#: ring's rounds, or after the last one)
PSORT_STEPS = ("psort.relay_in", "psort.pre_exchange", "psort.local_sort",
               "psort.splitters", "psort.refine", "psort.cuts", "psort.ring",
               "psort.merge", "psort.rebalance", "psort.relay_out")


def psort_step_times(fn) -> dict:
    """One call of ``fn`` inside ``tracing.record()``: the device time (ms)
    between CUDA events at the begin and end of each psort span, summed by
    name (the root's under ``"call"``), the most device memory each held
    above what was allocated when the call began (``"peak"``, bytes: the
    allocator's peak read and reset at every psort span's edge, so a
    nested span's peak counts for its parent too), the bytes
    psort.wire_bytes counted inside the ring's rounds (``"ring_bytes"``),
    and the call's counters."""
    open_, ms, peak = [], {}, {}
    ring = [0]
    base = []

    def wire() -> int:
        return sum(v for (_, k), v in rec.counts.items()
                   if k == "psort.wire_bytes")

    def watch(event, name, attrs):
        if not name.startswith("psort") or event == "instant":
            return
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        if not base:
            base.append(torch.cuda.memory_allocated())
        top = torch.cuda.max_memory_allocated() - base[0]
        torch.cuda.reset_peak_memory_stats()
        for began, _, _ in open_:
            key = "call" if began.startswith("psort_") else began
            peak[key] = max(peak.get(key, 0), top)
        if event == "begin":
            open_.append((name, ev, wire()))
            return
        began, start, sent = open_.pop()
        assert began == name, (began, name)
        ms.setdefault(name, []).append((start, ev))
        if name == "psort.ring":
            ring[0] += wire() - sent

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with tracing.record() as rec, tracing.observe(watch):
        fn()
    torch.cuda.synchronize()
    out = {("call" if name.startswith("psort_") else name):
           sum(a.elapsed_time(b) for a, b in pairs)
           for name, pairs in ms.items()}
    counts = {}
    for (_, k), v in rec.counts.items():
        counts[k] = counts.get(k, 0) + v
    return {"ms": out, "peak": peak, "ring_bytes": ring[0],
            "counts": counts}


def _psort_rank(rank: int, world: int, port: int, n: int, reps: int,
                queue) -> None:
    """One rank of phase 11's group: psort_keys of its ``n`` zipf keys,
    checked against its slice of the sorted keys of every rank, then
    ``reps`` calls timed by step (:func:`psort_step_times`); puts
    ``(rank, report)`` on ``queue``."""
    report = {"rank": rank}
    try:
        torch.cuda.set_device(rank)
        multihost.initialize(backend="nccl",
                             init_method=f"tcp://127.0.0.1:{port}",
                             world_size=world, rank=rank)
        x = torch.from_numpy(zipf_keys(n, SEED + 40 + rank)).cuda()
        got = thrs.psort_keys(x)
        # the keys of every rank, sorted by their unsigned bits (the sign
        # bit flipped for the signed sort)
        bits = x.view(torch.int32)
        every = [torch.empty_like(bits) for _ in range(world)]
        dist.all_gather(every, bits)
        flip = torch.cat(every) ^ (-(1 << 31))
        del every
        want = torch.sort(flip).values[rank * n:(rank + 1) * n] ^ (-(1 << 31))
        del flip
        report["mismatches"] = int((got.view(torch.int32) != want).sum())
        del got, want
        torch.cuda.synchronize()
        report["peak_bytes"] = torch.cuda.max_memory_allocated()
        calls = [psort_step_times(lambda: thrs.psort_keys(x))
                 for _ in range(reps)]
        report["ms"] = {k: statistics.median(c["ms"].get(k, 0.0)
                                             for c in calls)
                        for k in calls[0]["ms"]}
        report["step_peak"] = {k: max(c["peak"].get(k, 0) for c in calls)
                               for k in calls[0]["peak"]}
        report["ring_bytes"] = calls[0]["ring_bytes"]
        report["counts"] = calls[0]["counts"]
        dist.destroy_process_group()
    except Exception:  # the parent reports it and raises
        report["error"] = traceback.format_exc()
    queue.put((rank, report))


def phase_psort_group(card: str, n: int = PSORT_N, reps: int = 5) -> None:
    """psort_keys on a group of every card this process sees, up to 4: one
    process a card (``_psort_rank``, which inherits this process's
    CUDA_VISIBLE_DEVICES), each rank's output bit-equal to its slice of
    the sorted keys of every rank, each step's device time (median of
    ``reps`` calls) and the bytes on the wire."""
    import multiprocessing
    world = min(torch.cuda.device_count(), 4)
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = [ctx.Process(target=_psort_rank,
                         args=(r, world, port, n, reps, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    reports = {}
    try:
        for _ in range(world):
            rank, report = queue.get(timeout=900)
            reports[rank] = report
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    plan = psort.capacity_plan(world * n, world)
    log("11 psort", f"group of {world} card(s), NCCL: "
        f"psort_keys of {n} zipf(1.3) u32 keys a rank; B={plan.B} "
        f"cap={plan.cap} cap3={plan.cap3} refine={plan.refine}; card: "
        f"{card}")
    for rank in sorted(reports):
        rep = reports[rank]
        if "error" in rep or rep["mismatches"]:
            raise AssertionError(f"psort group, rank {rank}: {rep}")
        steps = ", ".join(f"{k.removeprefix('psort.')} {rep['ms'][k]:.3f}"
                          for k in PSORT_STEPS if k in rep["ms"])
        peaks = ", ".join(
            f"{k.removeprefix('psort.')} {rep['step_peak'][k] / n:.4f}"
            for k in ("call",) + PSORT_STEPS if k in rep["step_peak"])
        engines = {k: v for k, v in rep["counts"].items()
                   if k.startswith("psort.local.")}
        log("11 psort", f"group of {world}, rank {rank}: call "
            f"{rep['ms']['call']:.3f} ms; by step (ms, median of {reps}, "
            f"CUDA events at the spans' edges; merge: the run tree's "
            f"merges, inside ring's rounds or after them): {steps}; "
            f"the ring carried {rep['ring_bytes']} B, "
            f"psort.wire_bytes {rep['counts'].get('psort.wire_bytes', 0)}, "
            f"psort.host_reads {rep['counts'].get('psort.host_reads')}, "
            f"local sort engine {engines or 'not counted'}; the most "
            f"memory each step held above the call's start, B/key (the "
            f"max of {reps}): {peaks}; peak memory of the check "
            f"{rep['peak_bytes'] / 2**30:.3f} GiB; bit-equal to its slice "
            f"of the sorted keys of every rank")


def phase_psort(card: str) -> int:
    """Phase 11 on the running one-rank group (``_one_rank_group``), then
    on a group of every visible card (``phase_psort_group``)."""
    launches = phase_psort_main(card)
    phase_psort_local(card)
    torch.cuda.empty_cache()
    phase_psort_group(card)
    return launches


# ---------------------------------------------------------------------------
# phase 12: the harness layer (bench, matrix, drives, examples, entry,
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
    log("12 harness", f"{what}: {time.perf_counter() - t0:.3f} s; "
        f"{lines[-1] if lines else ''}")
    return result, lines


#: the sizes of the crossover table that places sort.AUTO_COUNTING_MIN_N
CROSSOVER_SIZES = ("1M", "2M", "4M", "8M", "16M", "64M", "256M")
#: its rows beside the matrix's: 2-byte keys (counting carries a -0.0 flag
#: and rebuilds the keys) and a 16-byte payload, the widest a pass carries
#: (name, key kind, value kind)
CROSSOVER_EXTRA = (("sort_keys f16", "f16", None),
                   ("sort_pairs u32+u128", "u32", "u128"))


def crossover(card: str, methods=("bitonic", "counting", "auto"),
              reps: int = 20, sizes=CROSSOVER_SIZES) -> dict:
    """The matrix (``benchmarks.full``) and :data:`CROSSOVER_EXTRA` at
    ``sizes`` through each of ``methods``, every call by the host's clock
    from a synchronized card until its work is done, ``reps`` calls a row
    (ten times as many below 1 ms): one line a workload with each method's
    engine, median and p95 beside torch.sort's; then, for each 1-D
    workload, the smallest size from which counting beat the network's
    median at every larger size, and the smallest from which it did so in
    every workload, which places ``sort.AUTO_COUNTING_MIN_N`` (PERF.md §6).
    Alone (~5 min): ``python3 -c "import chip_smoke as c;
    c.crossover(c.card_line())"``. Returns {workload: {method: row}}."""
    from tinyhipradixsort_torch.benchmarks import full

    got = {}
    for method in methods:
        t0 = time.perf_counter()
        table = full.run(sizes, reps, method, "cuda", out=lambda line: None)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(full.SEED)
        table["results"] += [
            full.run_row(f"{name} {label}", kind, full.SIZES[label], vkind,
                         reps=reps, method=method, gen=gen,
                         dev=torch.device("cuda"))
            for label in sizes for name, kind, vkind in CROSSOVER_EXTRA]
        for row in table["results"]:
            got.setdefault(row["workload"], {})[method] = row
        log("12 crossover", f"--method {method}: "
            f"{time.perf_counter() - t0:.3f} s")
    for name, by in got.items():
        ref = next(iter(by.values()))
        cols = "; ".join(
            f"{m} ({r['engine']}) median {r['ours_median_s'] * 1e3:.4f} ms, "
            f"p95 {r['ours_p95_s'] * 1e3:.4f}" for m, r in by.items())
        log("12 crossover", f"{name}: {cols}; torch.sort median "
            f"{ref['torch_median_s'] * 1e3:.4f} ms, p95 "
            f"{ref['torch_p95_s'] * 1e3:.4f}; {ref['reps']} calls a column, "
            f"host clock; card: {card}")
    wins = {}  # 1-D workload -> [(n, counting's median below the network's)]
    for name, by in got.items():
        if "batched" in name or not {"bitonic", "counting"} <= set(by):
            continue
        wins.setdefault(name.rsplit(" ", 1)[0], []).append(
            (by["bitonic"]["n"], by["counting"]["ours_median_s"]
             < by["bitonic"]["ours_median_s"]))
    froms = {}
    for kind, rows in wins.items():
        froms[kind] = None
        for n, win in sorted(rows, reverse=True):
            if not win:
                break
            froms[kind] = n
        log("12 crossover", f"{kind}: counting's median beats the network's "
            f"at every measured size from n = {froms[kind]}")
    if froms:
        every = (None if None in froms.values() else max(froms.values()))
        log("12 crossover", f"in every 1-D workload from n = {every}; "
            f"sort.AUTO_COUNTING_MIN_N = {sort_mod.AUTO_COUNTING_MIN_N}; "
            f"card: {card}")
    return got


def phase_harness(card: str) -> int:
    """The harness layer in process, on the running one-rank group: the
    bench at 2**28 and at the reference's u32Large n = 2**31 + 100 (both
    --verify full; "auto" runs counting at both), the matrix through bitonic, counting and auto at
    :data:`CROSSOVER_SIZES` (:func:`crossover`), verify_baseline,
    nonpow2_sweep --big, drive --iters 8, the three examples, entry,
    scaling at world size 1 and baseline_scale; then the counting engine
    through the bench at 2**28 and the drive. Each step raises on a
    failure. Returns the sweep kernel's launches of this path and the
    rank-and-scatter and bucket-scan kernels' of its counting steps."""
    from tinyhipradixsort_torch import bench
    from tinyhipradixsort_torch import entry as entry_mod
    from tinyhipradixsort_torch.benchmarks import scaling
    from tinyhipradixsort_torch.examples import helloworld, segmented, soak
    from tinyhipradixsort_torch.tools import (baseline_scale, drive,
                                              nonpow2_sweep, verify_baseline)

    be.KERNEL_LAUNCHES = 0
    for n in (1 << 28, (1 << 31) + 100):
        if n > 1 << 28:
            log("12 harness", f"before the u32Large bench: {host_memory()}")
        routes = []
        be.MARK = lambda event, route, words: (
            routes.append(route) if event == "route" else None)
        t0 = time.perf_counter()
        try:
            line = bench.run(n, 5, "full", "auto", "cuda")
        finally:
            be.MARK = None
        # "auto" runs counting at both sizes (1-D, from
        # sort.AUTO_COUNTING_MIN_N): no network route
        engine = line["method"]
        if engine != "counting" or routes:
            raise AssertionError(f"bench n={n}: engine {engine}, routes "
                                 f"{routes[:1]}; not counting, none")
        host_peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        log("12 harness", f"bench n={n} --verify full: "
            f"{time.perf_counter() - t0:.3f} s in all, engine {engine}, routes "
            f"{ {r: routes.count(r) for r in dict.fromkeys(routes)} }, peak "
            f"device memory {line['peak_device_bytes'] / 2**30:.3f} GiB "
            f"(keys {4 * n / 2**30:.3f} GiB), the oracle took "
            f"{line['oracle_s']:.3f} s, the process's peak host memory so "
            f"far {host_peak / 2**20:.3f} GiB; card: {card}")
        print(json.dumps(line), flush=True)
        if line["oracle"] != "native":
            log("12 harness", "the native oracle did not build; numpy's "
                "stable sort checked the bench")
        torch.cuda.empty_cache()

    crossover(card)
    torch.cuda.empty_cache()
    _step("verify_baseline", lambda out: verify_baseline.verify("cuda",
                                                                 out=out))
    torch.cuda.empty_cache()
    fails, lines = _step("nonpow2_sweep --big", lambda out: nonpow2_sweep.sweep(
        "cuda", big=True, out=out))
    routes = [ln.rsplit("route=", 1)[-1] for ln in lines if "route=" in ln]
    log("12 harness", f"nonpow2_sweep: {len(routes)} cases, routes "
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
    log("12 harness", f"scaling {json.dumps(rows)}; card: {card}")
    bad, lines = _step("baseline_scale --P 64,128,256",
                       lambda out: baseline_scale.report(out=out))
    for line in lines[:-1]:
        log("12 harness", line)
    if bad:
        raise AssertionError("baseline_scale found a problem in the plan")
    sweep_launches = be.KERNEL_LAUNCHES

    counting_engine.KERNEL_LAUNCHES = 0
    hist.SCAN_LAUNCHES = 0
    walks = hist.SCAN_SUM_WALKS
    line, _ = _step("bench --method counting --verify full (2**28)",
                    lambda out: bench.run(1 << 28, 5, "full", "counting",
                                          "cuda"))
    print(json.dumps(line), flush=True)
    bench_launches = (counting_engine.KERNEL_LAUNCHES, hist.SCAN_LAUNCHES)
    torch.cuda.empty_cache()
    d, lines = _step("drive --method counting", lambda out: drive.drive(
        "cuda", "counting", 0, out=out))
    if d.fails:
        raise AssertionError("\n".join(lines))
    log("12 harness", f"rank_scatter launches: bench "
        f"{bench_launches[0]}, drive "
        f"{counting_engine.KERNEL_LAUNCHES - bench_launches[0]}; "
        f"bucket_scan launches: bench {bench_launches[1]}, drive "
        f"{hist.SCAN_LAUNCHES - bench_launches[1]}")
    if 0 in bench_launches or (counting_engine.KERNEL_LAUNCHES,
                               hist.SCAN_LAUNCHES) == bench_launches:
        raise AssertionError("a counting step did not launch rank_scatter "
                             "and bucket_scan")
    if hist.SCAN_SUM_WALKS != walks:
        raise AssertionError("a counting step launched a summing walk")
    return (sweep_launches, counting_engine.KERNEL_LAUNCHES,
            hist.SCAN_LAUNCHES)


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
    runs_err = phase_histogram_runs()
    log("7 histogram-runs-vs-plain", f"all cases bit-equal in "
        f"{time.perf_counter() - t0:.3f} s, max_abs_err={runs_err}")
    hist_err = max(hist_err, runs_err)

    t0 = time.perf_counter()
    scan_err = phase_bucket_scan(x)
    log("7 bucket-scan-vs-plain", f"all cases bit-equal in "
        f"{time.perf_counter() - t0:.3f} s, max_abs_err={scan_err}")

    t0 = time.perf_counter()
    rs_err = phase_rank_scatter()
    log("7 rank-scatter-vs-plain", f"all cases bit-equal in "
        f"{time.perf_counter() - t0:.3f} s, max_abs_err={rs_err}")

    t0 = time.perf_counter()
    hist_launches, scan_launches, rs_launches = phase_portable()
    log("8 portable-path", f"all cases bit-exact in "
        f"{time.perf_counter() - t0:.3f} s, histogram launches="
        f"{hist_launches}, bucket_scan launches={scan_launches}, "
        f"rank_scatter launches={rs_launches}")

    t0 = time.perf_counter()
    g, s, g_launches, s_launches = phase_probes(card)
    log("9 probes", f"done in {time.perf_counter() - t0:.3f} s")

    h = phase_histogram_timing(x, card)
    sc = phase_bucket_scan_timing(x, card)
    r = phase_rank_scatter_timing(x, card)
    phase_counting_timing(x, sort_ms, card)
    del x
    torch.cuda.empty_cache()

    # phases 11-12 share one one-rank NCCL group
    _one_rank_group()
    try:
        t0 = time.perf_counter()
        psort_launches = phase_psort(card)
        log("11 psort", f"done in {time.perf_counter() - t0:.3f} s, sweep "
            f"kernel launches on the psort main path={psort_launches}")

        t0 = time.perf_counter()
        harness_launches, rs_harness, scan_harness = phase_harness(card)
        log("12 harness", f"done in {time.perf_counter() - t0:.3f} s, sweep "
            f"kernel launches on the harness path={harness_launches}, "
            f"rank_scatter launches on its counting steps={rs_harness}, "
            f"bucket_scan launches={scan_harness}")
    finally:
        dist.destroy_process_group()
    log("done", f"{time.perf_counter() - t_all:.3f} s in all")

    def bound(nbytes, ops):
        """The larger of a kernel's bytes at the memory rate and its 32-bit
        operations at the integer rate, in ms, and which of the two."""
        t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_INT_OPS_PER_S
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations")

    def entry(name, launches, err, ms, plain_ms, bound_, library_ms):
        """One kernel's report; ``bound_`` is its (bound_ms, bound_by)."""
        return {"name": name, "route": "cuda",
                "source": f"tinyhipradixsort_torch/csrc/{name}.cu",
                "replaces": KERNELS[name], "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_[0], "bound_by": bound_[1],
                "library_ms": library_ms}

    # the timed sweep (phase 5): the first local sweep of the 2**28
    # one-word network reads and writes every word once, and each of its
    # compare-exchanges (substages x n/2) is two operations (min and max)
    # on its one compare word
    sweep = _plan(28, 1, be.EngineTuning())[0]
    print(card, flush=True)
    print(json.dumps({"kernels": [
        # launches: the bitonic main path (phase 4), psort's (phase 11) and
        # the harness's (phase 12)
        entry("bitonic_sweep", launches + psort_launches + harness_launches,
              worst, kernel_ms,
              plain_ms,
              bound(2 * 4 * (1 << 28), 2 * len(sweep.substages) * (1 << 27)),
              None),
        # the counting engine's stage 1 at 2**28 u32, tile 2048: the run-sum
        # kernel (the words read once, the counts and run sums written
        # once); digit extraction: a shift, a mask and an add per word
        entry("digit_histogram", hist_launches, hist_err, h["ms"],
              h["plain_ms"], bound(h["bytes"], 3 * (1 << 28)),
              h["library_ms"]),
        # the sort_keys pass's scan at 2**28 (int32 offsets) given the run
        # sums: the counts and run sums read once, the offsets written
        # once, one add a count; its library call, torch.cumsum, scans the
        # counts already in bucket-major order; launches: the counting
        # paths of phases 8 and 12
        entry("bucket_scan", scan_launches + scan_harness, scan_err,
              sc["ms"], sc["plain_ms"], bound(sc["bytes"], sc["ops"]),
              sc["library_ms"]),
        # the sort_keys pass at 2**28 u32 (the bits alone: no payload, no
        # src; its library call, torch.sort of the uint8 digits, computes
        # src too);
        # launches: the counting paths of phases 8 and 12
        entry("rank_scatter", rs_launches + rs_harness, rs_err, r["ms"],
              r["plain_ms"], bound(r["bytes"], r["ops"]), r["library_ms"]),
        # at the rate shape (2**18 rounds), where the loads set the time;
        # its bound is the probe's own: one shared-memory load operation
        # per (round, element) at one conflict-free wavefront a clock per SM
        entry("gather_floor", g_launches, 0, g["ms"], g["plain_ms"],
              (g["bound_ms"], g["bound_by"]), None),
        entry("partition_scatter", s_launches, 0, s["ms"], s["plain_ms"],
              bound(s["bytes"], 0), s["library_ms"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
