"""Bitonic sort-merge engine (PyTorch port of
``tinyhipradixsort_tpu/ops/bitonic_engine.py``).

The engine sorts fixed tuples of 32-bit words: ``cmp`` words compared
lexicographically as unsigned ints (key bits, then a stability index word
when needed) and ``carry`` words (payloads, hidden key bits) that move with
their tuple. Appending the element index to the compare tuple gives the
reference's stable-sort contract and makes every tuple distinct.

Word representation (decided once, here, for the whole port)
-------------------------------------------------------------
* A u32 word lives in a contiguous 1-D ``torch.int32`` tensor that holds the
  same 32-bit pattern as the JAX package's ``uint32`` word: the all-ones
  sentinel ``0xFFFFFFFF`` is ``-1``. Torch on the CPU lacks ``<``, shifts and
  ``minimum`` for ``torch.uint32``/``torch.uint64``, so the port never
  computes on unsigned dtypes; it only views them.
* The CUDA kernel reads the same buffer as ``uint32_t``.
* The plain version widens a word with :func:`unsigned`
  (``w.to(torch.int64) & 0xFFFFFFFF``) before it compares, so the signed
  order of int32 never stands in for the unsigned one. :func:`as_word` is
  the way back.
* 64-bit keys and payloads split into (hi, lo) words by ``.view(torch.int32)``,
  a bit-exact reinterpretation (little-endian, lo first) — the same split as
  the JAX ``64f`` recipe. Never a value cast.
* ``>>`` on int32 and int64 is an arithmetic shift, so every extraction
  masks after it shifts.

Execution model
---------------
The network for ``N = 2**L`` elements is the ``(k, j)`` substages, ``k`` in
``1..L``, ``j`` in ``k-1..0``: compare-exchange with partner ``i ^ 2**j``,
ascending iff bit ``k`` of ``i`` is 0. :func:`plan_sweeps` groups substages
into *sweeps*; one sweep is one launch of the CUDA kernel
(``csrc/bitonic_sweep.cu``), whose block loads a tile covering index bits
``[0, c) ∪ [j_lo, j_lo + g)`` into shared memory, runs every substage of the
sweep there, and stores it back in place: one device-memory round trip per
sweep instead of one per substage. :func:`run_sweep` launches it on CUDA
tensors; on CPU tensors it runs :func:`run_sweep_reference`, the plain
PyTorch version.

Hopper tiling (re-derived; the TPU's lane, VMEM and compiler limits do not
apply): a tile of ``2**T`` elements of ``nwords`` words takes
``nwords * 4 * 2**T`` bytes of shared memory, which must stay within the
227 KB a block may use. :func:`_tile_bits_for` takes the largest ``T`` with
``nwords * 4 * 2**T <= EngineTuning.smem_tile_bytes`` (200 KB): ``T = 15``
for 1 word, 14 for 3 words, 13 for 5 words. The network always plans with
storage rotation 0.

Routes (all of them end in the same sweep kernel)
-------------------------------------------------
* :func:`sort_words`, power of two or little padding: the whole network on
  fresh buffers padded to ``2**L``.
* :func:`sort_words`, other ``n``: :func:`_sort_segmented`, the largest
  power-of-two prefix by the full network, the rest recursively, and one
  truncated merge (:func:`_merge_sorted_runs`): dense compare-exchange
  levels in torch (:func:`_ce_pair`) and merge sweeps of one stage
  (:func:`_merge_pow2`), with no padding.
* :func:`sort_words_rows`: rows padded to ``2**r`` and the network of
  stages ``1..r`` with stage ``r`` forced ascending, on a word length of
  ``b_pad * 2**r`` (a batch padded to a tile multiple, :func:`_row_plan`);
  :func:`_sort_segmented_rows` for non-power-of-two rows of a batch large
  enough to repay its small launches (:data:`_ROW_SEG_MIN_PADDED`).
* :func:`sort_words` with ``EngineTuning.partition_bits > 0`` (off by
  default): the MSB-partition front-end of :mod:`.partition_engine`, whose
  rank sort, bucket rows and merges are row networks of this module.

The sweeps run in place, so every buffer a sweep sees is one the engine
allocated: a caller's tensors (a 32-bit payload's words are views of it)
are copied once before the first sweep. With ``in_place=True`` (the API's
``donate=``) the caller hands its words over: a route that needs no padding
sweeps them where they lie.

Each call records into :mod:`..tracing` while a recording is on: the
spans ``bitonic.sort_words`` and ``bitonic.sort_words_rows``, the route
each takes and the route of each merge of two sorted runs as the instant
``bitonic.route``, each part of a segmented sort or of the partition
front-end as a span ``bitonic.<part>``, and each kernel launch as a span
``launch.bitonic_sweep``; a tool times the parts by CUDA events at their
edges through ``tracing.observe``. :data:`MARK`, an older observer that
tests and the benchmark's route line read, sees the same routes and
parts.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
from dataclasses import dataclass, fields

import torch

from .. import keybits, tracing
from . import common, cuda_lib

# ---------------------------------------------------------------------------
# Word representation helpers
# ---------------------------------------------------------------------------

_U32_MASK = 0xFFFFFFFF


def unsigned(w: torch.Tensor) -> torch.Tensor:
    """The unsigned value of an int32 word, as int64 in ``[0, 2**32)``."""
    return w.to(torch.int64) & _U32_MASK


def as_word(x: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2**32)`` -> int32 words with the same low 32
    bits (an exact cast: values above ``2**31 - 1`` move down by
    ``2**32``)."""
    return torch.where(x > 0x7FFFFFFF, x - (1 << 32), x).to(torch.int32)


def iota_word(n: int, device) -> torch.Tensor:
    """The index word ``0..n-1`` (``n <= 2**32``)."""
    if n <= 1 << 31:
        return torch.arange(n, dtype=torch.int32, device=device)
    return as_word(torch.arange(n, dtype=torch.int64, device=device))


# ---------------------------------------------------------------------------
# Network / sweep planning (host side)
# ---------------------------------------------------------------------------

MIN_L = 10  # minimum network size: 2**10 elements
# shared memory a block may opt into on Hopper (227 KB)
SMEM_MAX_BYTES = 232448
# cross sweeps keep each contiguous run of the tile at >= 2**5 words
# (128 B), so a warp reading a run uses whole 32-byte sectors
MIN_CHUNK_BITS = 5
# kernel parameter-block capacities (mirror csrc/bitonic_sweep.cu)
MAX_WORDS = 56
MAX_SUBSTAGES = 120
# largest tile exponent the kernel's register body (tuples of 1-8 words)
# takes: 512 threads of 2**reg_bits(nwords) elements (csrc/bitonic_sweep.cu)
REGISTER_TILE_BITS = {1: 15, 2: 14, 3: 14, 4: 13, 5: 13, 6: 13, 7: 12, 8: 12}


@dataclass(frozen=True)
class Sweep:
    """One kernel launch: the tile covers bits [0, c) ∪ [j_lo, j_lo + g)."""

    c: int  # low contiguous chunk bits
    g: int  # high group bits
    j_lo: int  # global bit position of the first group bit (j_lo >= c)
    L: int  # total problem bits
    # substages executed, in order: (k, j) with j in the tile's bits
    substages: tuple[tuple[int, int], ...]
    # stage k whose direction is forced ascending
    forced_asc: int | None = None

    @property
    def tile_elems(self) -> int:
        return 1 << (self.c + self.g)

    def tile_bit(self, j: int) -> int:
        """Map global index bit j (in the tile) to the tile-local bit."""
        if j < self.c:
            return j
        if not self.j_lo <= j < self.j_lo + self.g:
            raise ValueError(f"bit {j} is not in the tile of {self}")
        return self.c + (j - self.j_lo)

    def grid(self) -> tuple[int, int]:
        # global index i = a * 2**(j_lo+g) + e * 2**j_lo + b * 2**c + t
        A = 1 << (self.L - (self.j_lo + self.g))
        B = 1 << (self.j_lo - self.c)
        return (A, B)


def plan_sweeps(L: int, tile_bits: int, chunk_bits: int, stages=None,
                forced_asc: int | None = None,
                g_max_cross: int | None = None) -> list[Sweep]:
    """Greedy sweep plan for the bitonic network on ``2**L`` elements.

    ``tile_bits``: tile size exponent (shared-memory budget). ``chunk_bits``:
    low contiguous chunk of local sweeps. ``g_max_cross``: max high-group
    bits per cross sweep (default ``tile_bits - chunk_bits``), clamped so the
    low chunk keeps ``MIN_CHUNK_BITS``. A cross sweep's low chunk carries no
    substage, so it takes the rest of the tile (``c = tile_bits - g``).
    ``stages`` restricts the network to those stages; ``forced_asc`` names a
    stage that always sorts ascending.
    """
    tile_bits = min(tile_bits, L)
    chunk_bits = min(chunk_bits, tile_bits)
    g_max = tile_bits - chunk_bits
    if g_max_cross is not None:
        g_max = max(1, min(g_max_cross, tile_bits - MIN_CHUNK_BITS))
    stages = range(1, L + 1) if stages is None else stages
    subs = [(k, j) for k in stages for j in range(k - 1, -1, -1)]
    sweeps: list[Sweep] = []
    pos = 0
    while pos < len(subs):
        _, j0 = subs[pos]
        if j0 < tile_bits:
            # local sweep: one contiguous block of 2**tile_bits
            c = chunk_bits
            g, j_lo = tile_bits - c, c
            take = []
            while pos < len(subs) and subs[pos][1] < tile_bits:
                take.append(subs[pos])
                pos += 1
        else:
            # cross (hyperblock) sweep: group [j_lo, j0]
            j_lo = max(tile_bits, j0 - max(g_max, 1) + 1)
            g = j0 - j_lo + 1
            c = tile_bits - g
            take = []
            while pos < len(subs) and j_lo <= subs[pos][1] <= j0:
                take.append(subs[pos])
                pos += 1
        sweeps.append(Sweep(c=c, g=g, j_lo=j_lo, L=L, substages=tuple(take),
                            forced_asc=forced_asc))
    return sweeps


def _ceil_log2(n: int) -> int:
    return (max(n, 1) - 1).bit_length()


@dataclass(frozen=True)
class EngineTuning:
    """Sweep-planner knobs, read from ``THRS_<FIELD>`` environment variables
    at call time by :meth:`from_env` (e.g. ``THRS_CROSS_G_MAX=6``).

    smem_tile_bytes: shared memory one sweep's tile may take, all words
    together. 200 KB of the 227 KB a block may use gives 2**15 one-word,
    2**14 three-word and 2**13 five-word tiles.

    cross_g_max: index bits a cross sweep fuses per device-memory round
    trip. Each contiguous run of the tile shrinks to ``2**(T - g)`` words,
    which :data:`MIN_CHUNK_BITS` bounds from below.

    The routing knobs of non-power-of-two sizes keep the JAX package's
    names:

    seg_pad_waste: a flat non-power-of-two ``n`` takes the segmented route
    (power-of-two prefix, the rest recursively, one truncated merge) when
    padding it to ``2**L`` would waste more than this fraction. 0.15 is
    the JAX package's TPU value; on an H100 the routes cross between 0.15
    and 0.20 at 2**28 (PERF.md), and the retune is open.

    row_seg_waste, row_seg_min_nr: the same for the row length of batched
    sorts (``>= 1.0`` always pads rows); rows of at most
    ``max(row_seg_min_nr, 32)`` elements always pad, and so do batches
    below :data:`_ROW_SEG_MIN_PADDED` padded elements.

    partition_bits, partition_min_n, partition_row_bits,
    partition_tile_bits: the MSB-partition front-end
    (:mod:`.partition_engine`). ``partition_bits=0`` turns it off, as in
    the JAX package; ``> 0`` routes stable :func:`sort_words` calls of
    ``partition_min_n <= n < 2**31`` through it. Row and tile bits 0 pick
    ``L - partition_bits + 1`` and 18.
    """

    smem_tile_bytes: int = 200 * 1024
    cross_g_max: int = 8
    seg_pad_waste: float = 0.15
    row_seg_waste: float = 0.24
    row_seg_min_nr: int = 1024
    partition_bits: int = 0
    partition_min_n: int = 1 << 24
    partition_row_bits: int = 0
    partition_tile_bits: int = 0

    @classmethod
    def from_env(cls) -> "EngineTuning":
        kw = {}
        for f in fields(cls):
            raw = os.environ.get(f"THRS_{f.name.upper()}")
            if raw is not None:
                kw[f.name] = type(f.default)(raw)
        return cls(**kw)


def _tile_bits_for(nwords: int, L: int, tuning: EngineTuning) -> int:
    """Largest tile exponent whose ``nwords`` words fit the shared-memory
    budget (capped at ``L``, and at :data:`REGISTER_TILE_BITS`: with a
    budget above 224 KB, 7-word tuples would otherwise get a 2**13 tile,
    which the kernel refuses)."""
    budget = min(tuning.smem_tile_bytes, SMEM_MAX_BYTES) // (4 * nwords)
    T = budget.bit_length() - 1
    if T < MIN_L or nwords > MAX_WORDS:
        raise ValueError(
            f"{nwords} words do not fit a 2**{MIN_L}-element tile in "
            f"{tuning.smem_tile_bytes} bytes of shared memory")
    return min(T, REGISTER_TILE_BITS.get(nwords, T), L)


# ---------------------------------------------------------------------------
# The sweep: plain version and CUDA kernel
# ---------------------------------------------------------------------------

#: launches of the CUDA sweep kernel in this process (counted only where
#: the kernel is launched)
KERNEL_LAUNCHES = 0


def _lex_lt(a: list, b: list) -> torch.Tensor:
    """a <_lex b elementwise over equal-length lists of words that order
    as their tensors' dtype orders."""
    lt = a[-1] < b[-1]
    for w in range(len(a) - 2, -1, -1):
        lt = (a[w] < b[w]) | ((a[w] == b[w]) & lt)
    return lt


def _check_span(words: list, sweep: Sweep) -> None:
    total = words[0].shape[0]
    span = 1 << (sweep.j_lo + sweep.g)
    if total % span:
        raise ValueError(f"word length {total} is not a multiple of the "
                         f"sweep's block span {span}")


def run_sweep_reference(words: list, sweep: Sweep, ncmp: int) -> list:
    """Plain PyTorch version of the sweep kernel, on any device, in place.

    Applies the sweep's substages ``(k, j)`` in order to the whole array:
    element ``i`` compare-exchanges with ``i ^ 2**j``, ascending iff bit
    ``k`` of ``i`` is 0 or ``k`` is ``sweep.forced_asc``. Order is
    lexicographic unsigned on the first ``ncmp`` words; a pair swaps only
    when strictly out of order and every word moves with it. The result does
    not depend on tiling, so this twin is independent of the kernel's.
    Returns ``words``, whose tensors it has overwritten.
    """
    _check_span(words, sweep)
    n = words[0].shape[0]
    for k, j in sweep.substages:
        d = 1 << j
        views = [w.view(-1, 2, d) for w in words]
        lo = [v[:, 0] for v in views]
        hi = [v[:, 1] for v in views]
        # int32 with the sign bit flipped orders as the unsigned word does
        lo_u = [x ^ _INT32_MIN for x in lo[:ncmp]]
        hi_u = [x ^ _INT32_MIN for x in hi[:ncmp]]
        swap = _lex_lt(hi_u, lo_u)
        if k != sweep.forced_asc:
            # element i sits in pair row i >> (j + 1); as k > j, bit k of i
            # is bit k - j - 1 of its row
            row = torch.arange(n >> (j + 1), device=words[0].device)
            row >>= k - j - 1
            row &= 1
            desc = row.view(-1, 1) == 1
            del row
            swap = torch.where(desc, _lex_lt(lo_u, hi_u), swap)
            del desc
        for v, x, y in zip(views, lo, hi):
            nx, ny = torch.where(swap, y, x), torch.where(swap, x, y)
            v[:, 0] = nx
            v[:, 1] = ny
    return words


@functools.cache
def _sweep_fn():
    fn = cuda_lib.load("bitonic_sweep").thrs_bitonic_sweep
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_sweep(words: list, sweep: Sweep, ncmp: int) -> list:
    global KERNEL_LAUNCHES
    nwords = len(words)
    if not 1 <= ncmp <= nwords <= MAX_WORDS:
        raise ValueError(f"need 1 <= ncmp ({ncmp}) <= nwords ({nwords}) "
                         f"<= {MAX_WORDS}")
    w0 = words[0]
    for w in words:
        if not w.is_cuda or w.device != w0.device:
            raise ValueError("the sweep kernel needs every word on one CUDA "
                             f"device, got {w.device} and {w0.device}")
        if w.dtype != torch.int32:
            raise TypeError(f"sweep words must be torch.int32, got {w.dtype}")
        if w.dim() != 1 or not w.is_contiguous() or w.shape != w0.shape:
            raise ValueError("sweep words must be contiguous 1-D tensors of "
                             "equal length")
    _check_span(words, sweep)
    subs = sweep.substages
    if len(subs) > MAX_SUBSTAGES:
        raise ValueError(f"{len(subs)} substages > {MAX_SUBSTAGES}")
    if nwords * 4 * sweep.tile_elems > SMEM_MAX_BYTES:
        raise ValueError(f"a {sweep.tile_elems}-element tile of {nwords} "
                         f"words exceeds {SMEM_MAX_BYTES} B of shared memory")
    with tracing.span("launch.bitonic_sweep", n=w0.shape[0], words=nwords):
        tracing.count("launches")
        fn = _sweep_fn()
        ptrs = (ctypes.c_void_p * nwords)(*[w.data_ptr() for w in words])
        ks = (ctypes.c_int * len(subs))(*[k for k, _ in subs])
        fbs = (ctypes.c_int * len(subs))(*[sweep.tile_bit(j)
                                           for _, j in subs])
        forced = -1 if sweep.forced_asc is None else sweep.forced_asc
        with torch.cuda.device(w0.device):
            stream = torch.cuda.current_stream(w0.device).cuda_stream
            rc = fn(ptrs, nwords, ncmp, sweep.c, sweep.g, sweep.j_lo,
                    w0.shape[0], forced, ks, fbs, len(subs), stream)
    if rc != 0:
        raise RuntimeError(f"bitonic sweep kernel launch failed: CUDA error "
                           f"{rc} ({sweep})")
    KERNEL_LAUNCHES += 1
    return words


def run_sweep(words: list, sweep: Sweep, ncmp: int) -> list:
    """Run one sweep in place on int32 words; returns ``words``.

    CUDA tensors go through the hand-written kernel (built at first use);
    CPU tensors through :func:`run_sweep_reference`. Any other device
    raises. There is no fallback from the kernel to the plain version.
    """
    if common.on_cuda(words[0]):
        return _launch_sweep(words, sweep, ncmp)
    if words[0].device.type != "cpu":
        raise ValueError(f"no sweep implementation for {words[0].device}")
    return run_sweep_reference(words, sweep, ncmp)


# ---------------------------------------------------------------------------
# Word packing
# ---------------------------------------------------------------------------


def split_u64(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """64-bit tensor -> (hi, lo) int32 words by a bit-exact view
    (little-endian: lo first in memory)."""
    pairs = x.contiguous().view(torch.int32).view(*x.shape, 2)
    return pairs[..., 1], pairs[..., 0]


def join_u64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) int32 words -> int64 with the same 64-bit pattern."""
    return torch.stack([lo, hi], dim=-1).view(torch.int64).squeeze(-1)


def array_to_words(a: torch.Tensor) -> tuple[list, dict]:
    """Decompose a tensor (leading axis n) into int32 words + recipe."""
    dtype = a.dtype
    if dtype.is_complex:
        raise TypeError(f"unsupported payload dtype {dtype}")
    if a.ndim == 1:
        size = dtype.itemsize
        if size == 8:
            kind = "64f" if dtype.is_floating_point else "64"
            return list(split_u64(a)), {"kind": kind, "dtype": dtype}
        if size == 4:
            return [a.view(torch.int32)], {"kind": "32", "dtype": dtype}
        if size == 2:
            # bit-exact zero-extension (keeps 16-bit float NaN payloads)
            u = a.view(torch.int16).to(torch.int32) & 0xFFFF
            return [u], {"kind": "narrow16", "dtype": dtype}
        if size == 1:
            u = (a.to(torch.float32).view(torch.int32)
                 if dtype.is_floating_point else a.to(torch.int32))
            return [u], {"kind": "narrow", "dtype": dtype}
        raise TypeError(f"unsupported payload dtype {dtype}")
    if a.ndim == 2 and dtype.itemsize == 4:
        return [a[:, i].view(torch.int32) for i in range(a.shape[1])], {
            "kind": "2d32", "dtype": dtype, "cols": a.shape[1]}
    raise TypeError(f"unsupported payload tensor: shape {tuple(a.shape)} "
                    f"dtype {dtype}")


def words_to_array(words: list, recipe: dict) -> torch.Tensor:
    dtype = recipe["dtype"]
    kind = recipe["kind"]
    if kind in ("64", "64f"):
        return join_u64(words[0], words[1]).view(dtype)
    if kind == "32":
        return words[0].view(dtype)
    if kind == "narrow16":
        return keybits.raw_to_keys(words[0], dtype)
    if kind == "narrow":
        if dtype.is_floating_point:
            return words[0].view(torch.float32).to(dtype)
        return words[0].to(dtype)
    if kind == "2d32":
        return torch.stack([w.view(dtype) for w in words], dim=1)
    raise AssertionError(kind)


def bits_to_cmp_words(bits: torch.Tensor, start_bit: int, end_bit: int) -> list:
    """Window-extracted key bits -> list of int32 compare words (hi first)."""
    window = common.window_values(bits, start_bit, end_bit)
    if window.dtype == torch.int32:
        return [window]
    hi, lo = split_u64(window)
    # a window of <= 32 bits is a value below 2**32: its lo word is all of it
    return [lo] if end_bit - start_bit <= 32 else [hi, lo]


# ---------------------------------------------------------------------------
# Engine entry
# ---------------------------------------------------------------------------


def check_word_contract(cmp_words: list, carry_words: list) -> bool:
    """Debug validator for the :func:`sort_words` word contract: True iff
    there are no carry words or the cmp tuples are all distinct. O(n log n);
    for tests and debugging, not the hot path."""
    if not carry_words or cmp_words[0].shape[0] <= 1:
        return True
    tuples = torch.stack([unsigned(w) for w in cmp_words], dim=1)
    return torch.unique(tuples, dim=0).shape[0] == tuples.shape[0]


#: nesting cap of the pow2-segment decomposition, and the size at which a
#: truncated merge's upper chain materializes its sentinels: the JAX
#: package's values, which it needs for an XLA:TPU layout. The output does
#: not depend on them (it is unique under the word contract); whether
#: Hopper is faster without them is not measured yet.
_MAX_SEG_DEPTH = 2
_TAIL_MAX = 1 << 16
_INT32_MIN = -(1 << 31)

#: the fewest padded elements (``B * 2**r``) for which a batch of
#: non-power-of-two rows takes the row-segmented route (Hopper's own; the
#: JAX package has no such floor). The route's chain of small launches
#: costs 1-4 ms whatever the batch: on an H100 at about 40% padding it
#: lost at 2**25 padded elements and below (0.16-0.64x the padded time)
#: and won at 2**26 and above (1.11-1.42x; PERF.md section 5).
_ROW_SEG_MIN_PADDED = 1 << 26

#: observer of routes and parts (``None``: off). Called as
#: ``MARK(event, name, words)``: ``event="route"`` once per routing decision
#: (``name`` one of "padded", "segmented", "rows", "rows-segmented",
#: "partition", "partition-fallback", and for a merge of two sorted runs
#: "merge-virtual" or "merge-padded"; the words it sorts or merges), and
#: ``"begin"``/``"end"`` around each part of a segmented sort ("prefix
#: network", "recursive remainder", "dense levels", "merge sweeps") or of
#: the partition front-end ("rank sort", "counts", "scatter", "bucket
#: sorts", "merges", "fallback"); parts nest, the outermost is the part.
#: The same calls also record into :mod:`..tracing`: a route as the
#: instant ``bitonic.route`` (attribute ``route``), a part as the span
#: ``bitonic.<part>``.
MARK = None


def _mark_route(name: str, words: list) -> None:
    tracing.event("bitonic.route", route=name, n=words[0].shape[0],
                  words=len(words))
    if MARK is not None:
        MARK("route", name, words)


def _part(name: str, words: list):
    """The span ``bitonic.<name>`` of one part of a route, shown to
    :data:`MARK` too when it is set."""
    sp = tracing.span(f"bitonic.{name}", n=words[0].shape[0],
                      words=len(words))
    return sp if MARK is None else _marked_part(sp, name, words)


@contextlib.contextmanager
def _marked_part(sp, name: str, words: list):
    with sp:
        MARK("begin", name, words)
        yield
        MARK("end", name, words)


def _fill(i: int, ncmp: int) -> int:
    """Pad value of word ``i``: the all-ones sentinel in a compare word,
    zero in a carry word."""
    return -1 if i < ncmp else 0


def _tuning_or_env(tuning: EngineTuning | None) -> EngineTuning:
    return EngineTuning.from_env() if tuning is None else tuning


def sort_words(cmp_words: list, carry_words: list, *,
               tuning: EngineTuning | None = None,
               allow_tied_carries: bool = False, in_place: bool = False):
    """Sort int32 word tuples by lexicographic unsigned order of cmp_words.

    Returns ``(cmp_words, carry_words)`` reordered; the inputs are not
    modified. Words must share one length and device.

    ``in_place=True`` hands the words over: where the route needs no
    padding (a power-of-two ``n >= 2**MIN_L``, or the segmented route) the
    sweeps run on the given words themselves, and their content afterwards
    is unspecified except where a returned word is one of them. A word that
    is not contiguous is copied first. The words must not overlap.

    Contract: either the cmp tuples are all distinct (e.g. they end in an
    index word), or equal cmp tuples are bit-identical in every word (e.g.
    there are no carry words). The kernel never swaps ties, but pad
    sentinels must sort after every real tuple.

    ``allow_tied_carries=True`` lifts the contract: tied cmp tuples with
    distinct carries come out in some order (an unstable sort). Since the
    kernel and :func:`_ce_pair` never swap a tied pair, every
    compare-exchange already moves whole tuples and no separate tie-safe
    kernel is needed. It is only valid pad-free (``n`` a power of two
    ``>= 2**MIN_L``): an all-ones real tuple would tie the pad sentinels
    and could be truncated in their place, so other sizes raise.

    Routes: with ``tuning.partition_bits > 0``, a stable sort of
    ``partition_min_n <= n < 2**31`` goes through the MSB-partition
    front-end (:func:`.partition_engine.sort_words_partition`, which never
    sweeps the given words). A non-power-of-two ``n`` whose padding to
    ``2**L`` would waste more than ``tuning.seg_pad_waste`` takes the
    segmented route
    (:func:`_sort_segmented`); every other ``n`` is copied into fresh
    buffers of ``2**max(ceil_log2 n, MIN_L)`` (all-ones in cmp words, zeros
    in carry words), the whole network runs in place on them, and the
    result is truncated to ``n``. The output is unique under the contract,
    so both routes give the JAX package's output bit for bit.
    ``tuning=None`` reads the ``THRS_*`` knobs at call time.
    """
    tuning = _tuning_or_env(tuning)
    n = cmp_words[0].shape[0]
    if n <= 1:
        return list(cmp_words), list(carry_words)
    tie_safe = bool(allow_tied_carries and carry_words)
    if tie_safe and (n & (n - 1) or n < 1 << MIN_L):
        raise ValueError(f"allow_tied_carries needs pad-free n (power of two "
                         f">= {1 << MIN_L}), got {n}")
    ncmp = len(cmp_words)
    words = list(cmp_words) + list(carry_words)
    with tracing.span("bitonic.sort_words", n=n, words=len(words)):
        if (not tie_safe and tuning.partition_bits > 0
                and tuning.partition_min_n <= n < 1 << 31):
            from . import partition_engine

            return partition_engine.sort_words_partition(
                list(cmp_words), list(carry_words), tuning=tuning)
        if in_place:
            words = [w.contiguous() for w in words]
        words = _sort_flat(words, ncmp, tuning, 0, owned=in_place)
    return words[:ncmp], words[ncmp:]


def _sort_flat(words: list, ncmp: int, tuning: EngineTuning, depth: int,
               owned: bool) -> list:
    """:func:`sort_words` on one list of words. ``owned``: the words are
    contiguous buffers this sort may sweep in place (views of its own copy,
    or words the caller handed over); otherwise the segmented route copies
    them once and the padded route sorts a padded copy."""
    n = words[0].shape[0]
    if n <= 1:
        return words
    L = max(_ceil_log2(n), MIN_L)
    if (n > (1 << MIN_L) and n & (n - 1) and depth < _MAX_SEG_DEPTH
            and n < int((1 << L) * (1.0 - tuning.seg_pad_waste))):
        _mark_route("segmented", words)
        if not owned:
            words = [w.clone(memory_format=torch.contiguous_format)
                     for w in words]
        return _sort_segmented(words, n, ncmp, tuning, depth)
    _mark_route("padded", words)
    if owned and n == 1 << L:
        return _run_network(words, ncmp, L, tuning)
    words = [common.pad_to_multiple(w, 1 << L, _fill(i, ncmp))
             for i, w in enumerate(words)]
    return [w[:n] for w in _run_network(words, ncmp, L, tuning)]


def _run_network(words: list, ncmp: int, L: int, tuning: EngineTuning,
                 stages=None, forced_asc: int | None = None,
                 tile_bits: int | None = None) -> list:
    """Run the (sub)network of ``stages`` (default: all of ``1..L``) on the
    words, in place; ``L`` is the network's index-bit span.

    The word length need not be ``2**L``: any multiple of every sweep's
    block span works (the kernel takes its block count from the length),
    which the row paths use with a batch padded to a tile multiple.
    ``tile_bits`` overrides the shared-memory tile choice. A local sweep's
    tile is one contiguous run of ``2**T`` elements that a block reads with
    coalesced loads however the run is split, so the low chunk is the whole
    tile (``chunk_bits = T``, ``g = 0``).
    """
    if tile_bits is None:
        tile_bits = _tile_bits_for(len(words), L, tuning)
    for sweep in plan_sweeps(L, tile_bits, tile_bits, stages, forced_asc,
                             g_max_cross=tuning.cross_g_max):
        words = run_sweep(words, sweep, ncmp)
    return words


# ---------------------------------------------------------------------------
# Non-power-of-two n: pow2 segments and truncated merges
# ---------------------------------------------------------------------------


def _ce_pair(x_words: list, y_words: list, ncmp: int) -> tuple[list, list]:
    """Elementwise lexicographic compare-exchange of two word lists ->
    ``(mins, maxs)``. Ties keep x in the min slot, as the kernel never
    swaps a tied pair.

    Plain torch ops on every device (in the JAX package these are jnp ops
    outside any kernel). Unsigned order without widening: a word with its
    sign bit flipped orders as int32 as the unsigned word does.
    """
    with _part("dense levels", x_words):
        xs = [w ^ _INT32_MIN for w in x_words[:ncmp]]
        ys = [w ^ _INT32_MIN for w in y_words[:ncmp]]
        swap = ys[-1] < xs[-1]  # y <lex x
        for w in range(ncmp - 2, -1, -1):
            swap = (ys[w] < xs[w]) | ((ys[w] == xs[w]) & swap)
        mins = [torch.where(swap, y, x) for x, y in zip(x_words, y_words)]
        maxs = [torch.where(swap, x, y) for x, y in zip(x_words, y_words)]
    return mins, maxs


def _dense_merge(words: list, ncmp: int, m: int) -> list:
    """Ascending bitonic merge of each run of ``m`` (a power of two) in the
    flat words, by dense compare-exchange levels; for ``m < 2**MIN_L``,
    below the smallest tile."""
    for lev in range(m.bit_length() - 2, -1, -1):
        v = [w.reshape(-1, 2, 1 << lev) for w in words]
        mins, maxs = _ce_pair([x[:, 0] for x in v], [x[:, 1] for x in v],
                              ncmp)
        words = [torch.stack([lo, hi], dim=1).reshape(-1)
                 for lo, hi in zip(mins, maxs)]
    return words


def _merge_pow2(words: list, ncmp: int, m: int,
                tuning: EngineTuning) -> list:
    """Ascending bitonic merge of a bitonic sequence of ``m`` (a power of
    two) elements: the network's stage ``log2 m`` alone. Sweeps the words
    in place, so they must be buffers of the caller's own."""
    if m <= 1:
        return words
    with _part("merge sweeps", words):
        if m < (1 << MIN_L):
            return _dense_merge(words, ncmp, m)
        lg = m.bit_length() - 1
        return _run_network(words, ncmp, lg, tuning, stages=[lg])


def _merge_sorted_runs(asc_words: list, desc_words: list, ncmp: int,
                       tuning: EngineTuning | None = None) -> list:
    """Merge a sorted-ascending run (length ``a``) with a sorted-descending
    run (length ``b``) into one ascending run of ``a + b``; the inputs are
    not modified.

    The construction is the virtual bitonic array ``[asc, all-ones
    sentinel block, desc]`` at a power of two: the maximal sentinels sit at
    the peak and never move before real data. When ``a`` is a power of two
    ``>= 2**MIN_L`` and ``b <= a`` (every :func:`_sort_segmented` call) the
    sentinels stay virtual: a compare-exchange against a sentinel is a
    no-op, so each split level is computed densely on the real elements
    (slices and one :func:`_ce_pair`), every all-real half is an exact
    power of two merged by the stage-``log2`` sweeps with no padding, and
    all-sentinel halves are dropped as bookkeeping. Other shapes (for the
    merge trees of a distributed sort) take :func:`_merge_sorted_runs_padded`.
    """
    a = asc_words[0].shape[0]
    b = desc_words[0].shape[0]
    if b == 0:
        return list(asc_words)
    if a == 0:
        return [torch.flip(w, (0,)) for w in desc_words]
    tuning = _tuning_or_env(tuning)
    if a & (a - 1) or b > a or a < (1 << MIN_L):
        _mark_route("merge-padded", asc_words)
        return _merge_sorted_runs_padded(asc_words, desc_words, ncmp, tuning)
    _mark_route("merge-virtual", asc_words)
    # virtual array [asc(a), SENT(a-b), desc(b)] of 2a. First split (stride
    # a): indices [0, a-b) face sentinels (no-ops); the rest compare-
    # exchange against the descending run.
    mid = a - b
    mins, maxs = _ce_pair([w[mid:] for w in asc_words], list(desc_words),
                          ncmp)
    lower = [torch.cat([w[:mid], mn]) for w, mn in zip(asc_words, mins)]
    # bitonic split: max(lower half) <= min(upper half), and the lower half
    # is all real and bitonic: its merge gives the smallest a outputs
    pieces = [_merge_pow2(lower, ncmp, a, tuning)]
    # upper chain: the virtual [SENT(s), R] of M = s + len(R) (a power of
    # two), bitonic with a maximal sentinel prefix
    R, s, M = maxs, mid, a
    while True:
        if s == 0:
            pieces.append(_merge_pow2(R, ncmp, M, tuning))
            break
        if M <= _TAIL_MAX:
            # small tail: materialize [SENT(s), R] once, one padded merge
            full = [torch.cat([torch.full((s,), _fill(i, ncmp),
                                          dtype=w.dtype, device=w.device), w])
                    for i, w in enumerate(R)]
            pieces.append([w[:M - s]
                           for w in _merge_pow2(full, ncmp, M, tuning)])
            break
        h = M // 2
        if s >= h:
            # upper half all sentinel; the lower half is [SENT(s-h), R]
            s, M = s - h, h
            continue
        # split at h: lower[i < s] = R[h-s+i] faces a sentinel, the rest
        # is the min pair; the upper half [SENT(s), maxes] has the same form
        mins, maxs = _ce_pair([w[:h - s] for w in R], [w[h:] for w in R],
                              ncmp)
        low = [torch.cat([w[h - s:h], mn]) for w, mn in zip(R, mins)]
        pieces.append(_merge_pow2(low, ncmp, h, tuning))
        R, M = maxs, h
    return [torch.cat(ws) for ws in zip(*pieces)]


def _merge_sorted_runs_padded(asc_words: list, desc_words: list, ncmp: int,
                              tuning: EngineTuning | None = None) -> list:
    """The padded merge: ``[asc, sentinel block, desc]`` materialized at the
    next power of two (at least ``2**MIN_L``) and merged by one stage."""
    tuning = _tuning_or_env(tuning)
    a = asc_words[0].shape[0]
    b = desc_words[0].shape[0]
    m = 1 << max(_ceil_log2(a + b), MIN_L)
    out = []
    for i, (aw, dw) in enumerate(zip(asc_words, desc_words)):
        pad = torch.full((m - a - b,), _fill(i, ncmp), dtype=aw.dtype,
                         device=aw.device)
        out.append(torch.cat([aw, pad, dw]))
    lg = m.bit_length() - 1
    out = _run_network(out, ncmp, lg, tuning, stages=[lg])
    return [w[:a + b] for w in out]


def _sort_segmented(words: list, n: int, ncmp: int, tuning: EngineTuning,
                    depth: int) -> list:
    """Sort a non-power-of-two ``n``: the largest power-of-two prefix by the
    full network, the rest recursively (nesting capped at
    :data:`_MAX_SEG_DEPTH`), then one truncated merge. Sweeps the words in
    place: they are buffers of the sort's own, and ``w[:a]``, ``w[a:]`` are
    disjoint contiguous views of them."""
    a = 1 << (n.bit_length() - 1)
    left = [w[:a] for w in words]
    with _part("prefix network", left):
        left = _run_network(left, ncmp, a.bit_length() - 1, tuning)
    right = [w[a:] for w in words]
    with _part("recursive remainder", right):
        right = _sort_flat(right, ncmp, tuning, depth + 1, owned=True)
    right = [torch.flip(w, (0,)) for w in right]
    return _merge_sorted_runs(left, right, ncmp, tuning)


# ---------------------------------------------------------------------------
# Batched rows
# ---------------------------------------------------------------------------


def _row_plan(B: int, r: int, nwords: int,
              tuning: EngineTuning) -> tuple[int, int]:
    """``(tile_bits, b_pad)`` for the row network of ``B`` rows of ``2**r``
    elements (stages ``1..r``, stage ``r`` forced ascending).

    Rows never interact (every substage bit is below ``r``), so the batch
    only pads to a tile multiple: ``2**(T - r)`` rows when the tile spans
    several rows, nothing when ``T <= r``. Re-derived for Hopper: the JAX
    cost model weighs the TPU's roll against its pair-split substages,
    neither of which exists here. Every candidate ``T`` in
    ``[max(r, MIN_L), T_hi]`` runs the whole row network in one local
    sweep, and a substage costs the same at any tile bit, so the work is
    the padded element count times a fixed substage count: the fewest
    padded elements wins, and on a tie the larger tile (fewer, fuller
    blocks for the same bytes).
    """
    T_hi = _tile_bits_for(nwords, max(r + _ceil_log2(max(B, 1)), MIN_L),
                          tuning)
    if T_hi <= r:
        return T_hi, B  # the tile lies inside one row: any B divides

    def b_pad(T: int) -> int:
        m = 1 << (T - r) if T > r else 1
        return -(-B // m) * m

    best = min(range(max(r, MIN_L), T_hi + 1), key=lambda T: (b_pad(T), -T))
    return best, b_pad(best)


def _pad_rows(w: torch.Tensor, B: int, nr: int, r: int, b_pad: int,
              fill: int) -> torch.Tensor:
    """Flat ``(B, nr)`` words -> a fresh flat ``(b_pad, 2**r)`` buffer, rows
    padded with ``fill`` and ``b_pad - B`` rows of ``fill`` below them
    (always a copy: the network sweeps it in place)."""
    out = torch.empty((b_pad, 1 << r), dtype=w.dtype, device=w.device)
    out[:B, :nr] = w.reshape(B, nr)
    out[:B, nr:] = fill
    out[B:] = fill
    return out.view(-1)


def sort_words_rows(cmp_words: list, carry_words: list, shape, *,
                    tuning: EngineTuning | None = None,
                    allow_tied_carries: bool = False, in_place: bool = False,
                    _seg_depth: int = 0):
    """Row-wise :func:`sort_words`: each of the ``B`` rows of the row-major
    flat words (``shape = (B, nr)``, word length ``B * nr``) sorts on its
    own; the inputs are not modified.

    Rows pad to ``2**r`` with sentinels and the network runs stages
    ``1..r`` only, with stage ``r`` forced ascending: every partner differs
    in a bit below ``r``, so rows never interact and the work is ``B``
    times one row's. The batch pads only to a tile multiple
    (:func:`_row_plan`). A non-power-of-two row whose padding would waste
    more than ``tuning.row_seg_waste``, in a batch of at least
    :data:`_ROW_SEG_MIN_PADDED` padded elements, takes
    :func:`_sort_segmented_rows`.
    Same word contract as :func:`sort_words`, per row;
    ``allow_tied_carries`` needs power-of-two rows (batch sentinel rows are
    safe, in-row sentinels are not). ``in_place`` has :func:`sort_words`
    semantics: power-of-two rows whose batch needs no padding rows are
    swept where they lie.
    """
    B, nr = shape
    if nr <= 1 or B == 0:
        return list(cmp_words), list(carry_words)
    ncmp = len(cmp_words)
    nwords = ncmp + len(carry_words)
    r = _ceil_log2(nr)
    if allow_tied_carries and carry_words and nr != (1 << r):
        raise ValueError(
            f"allow_tied_carries needs power-of-two rows, got {nr}")
    tuning = _tuning_or_env(tuning)
    words = list(cmp_words) + list(carry_words)
    with tracing.span("bitonic.sort_words_rows", n=B * nr, words=nwords):
        if (nr & (nr - 1) and _seg_depth < _MAX_SEG_DEPTH
                and nr > max(tuning.row_seg_min_nr, 32)
                and B << r >= _ROW_SEG_MIN_PADDED
                and nr < int((1 << r) * (1.0 - tuning.row_seg_waste))):
            _mark_route("rows-segmented", words)
            words = _sort_segmented_rows(words, B, nr, ncmp, tuning,
                                         _seg_depth)
            return words[:ncmp], words[ncmp:]
        _mark_route("rows", words)
        T, b_pad = _row_plan(B, r, nwords, tuning)
        if in_place and nr == 1 << r and b_pad == B:
            words = [w.contiguous() for w in words]
        else:
            words = [_pad_rows(w, B, nr, r, b_pad, _fill(i, ncmp))
                     for i, w in enumerate(words)]
        words = _run_network(words, ncmp, max(T, r), tuning,
                             stages=range(1, r + 1), forced_asc=r,
                             tile_bits=T)
        words = [w.view(b_pad, 1 << r)[:B, :nr].reshape(-1) for w in words]
    return words[:ncmp], words[ncmp:]


def _merge_rows(words: list, ncmp: int, B: int, nr: int,
                tuning: EngineTuning, owned: bool) -> list:
    """Merge each bitonic row of the flat ``(B, nr)`` words (``nr`` a power
    of two) to ascending order: stage ``log2 nr`` alone, forced ascending.
    ``owned``: the words are fresh buffers that may be swept in place."""
    r = nr.bit_length() - 1
    if nr < (1 << MIN_L):
        return _dense_merge(words, ncmp, nr)
    T, b_pad = _row_plan(B, r, len(words), tuning)
    if b_pad != B or not owned:
        # sentinel rows (constant, so bitonic) up to a tile multiple, in a
        # fresh buffer
        words = [_pad_rows(w, B, nr, r, b_pad, _fill(i, ncmp))
                 for i, w in enumerate(words)]
    words = _run_network(words, ncmp, max(T, r), tuning, stages=[r],
                         forced_asc=r, tile_bits=T)
    return [w[:B * nr] for w in words]


def merge_words_rows(cmp_words: list, carry_words: list, shape, *,
                     tuning: EngineTuning | None = None):
    """Merge each row of the flat words to ascending order; the inputs are
    not modified.

    ``shape = (B, nr)`` with ``nr`` a power of two, and every row must be a
    bitonic sequence (e.g. ``[ascending run, descending run]``, sentinel
    plateaus allowed). Runs the final merge stage alone: ``log2 nr``
    substages per row instead of a full sort; below ``2**MIN_L`` the dense
    compare-exchange levels of :func:`_merge_pow2`.
    """
    B, nr = shape
    if nr <= 1 or B == 0:
        return list(cmp_words), list(carry_words)
    if nr & (nr - 1):
        raise ValueError(f"merge_words_rows needs power-of-two rows, got {nr}")
    ncmp = len(cmp_words)
    words = _merge_rows(list(cmp_words) + list(carry_words), ncmp, B, nr,
                        _tuning_or_env(tuning), owned=False)
    return words[:ncmp], words[ncmp:]


def _merge_pow2_rows(words2d: list, ncmp: int, m: int,
                     tuning: EngineTuning) -> list:
    """Row-wise :func:`_merge_pow2` of the ``(B, m)`` words (fresh buffers,
    swept in place)."""
    if m <= 1:
        return words2d
    B = words2d[0].shape[0]
    flat = _merge_rows([w.reshape(-1) for w in words2d], ncmp, B, m, tuning,
                       owned=True)
    return [w.view(B, m) for w in flat]


def _merge_sorted_runs_rows(asc: list, desc: list, ncmp: int,
                            tuning: EngineTuning) -> list:
    """Row-wise :func:`_merge_sorted_runs`: each ascending row of the
    ``(B, a)`` words with the matching descending row of the ``(B, b)``
    words, into one ascending row of ``a + b``. Needs ``a`` a power of two
    and ``0 < b <= a`` (every :func:`_sort_segmented_rows` shape). Unlike
    the flat form, the chain runs to its end: its pieces are ``(B, h)``
    column blocks, at most ``log2 a`` of them."""
    B, a = asc[0].shape
    b = desc[0].shape[1]
    if b == 0:
        return list(asc)
    if a & (a - 1) or b > a:
        raise ValueError(f"row merge needs a power-of-two a >= b, got "
                         f"a={a}, b={b}")
    mid = a - b
    mins, maxs = _ce_pair([w[:, mid:] for w in asc], list(desc), ncmp)
    lower = [torch.cat([w[:, :mid], mn], dim=1) for w, mn in zip(asc, mins)]
    pieces = [_merge_pow2_rows(lower, ncmp, a, tuning)]
    R, s, M = maxs, mid, a
    while True:
        if s == 0:
            pieces.append(_merge_pow2_rows(R, ncmp, M, tuning))
            break
        h = M // 2
        if s >= h:
            s, M = s - h, h
            continue
        mins, maxs = _ce_pair([w[:, :h - s] for w in R],
                              [w[:, h:] for w in R], ncmp)
        low = [torch.cat([w[:, h - s:h], mn], dim=1)
               for w, mn in zip(R, mins)]
        pieces.append(_merge_pow2_rows(low, ncmp, h, tuning))
        R, M = maxs, h
    return [torch.cat(ws, dim=1) for ws in zip(*pieces)]


def _sort_segmented_rows(words: list, B: int, nr: int, ncmp: int,
                         tuning: EngineTuning, depth: int) -> list:
    """Row-wise :func:`_sort_segmented`: each row's largest power-of-two
    prefix by the row network, the rest of each row recursively (nesting
    capped at :data:`_MAX_SEG_DEPTH`), then one truncated row merge; no
    in-row sentinels."""
    a = 1 << (nr.bit_length() - 1)
    w2d = [w.reshape(B, nr) for w in words]
    left = [w[:, :a].reshape(-1) for w in w2d]
    right = [w[:, a:].reshape(-1) for w in w2d]
    lc, lk = sort_words_rows(left[:ncmp], left[ncmp:], (B, a), tuning=tuning)
    rc, rk = sort_words_rows(right[:ncmp], right[ncmp:], (B, nr - a),
                             tuning=tuning, _seg_depth=depth + 1)
    asc = [w.view(B, a) for w in lc + lk]
    desc = [torch.flip(w.reshape(B, nr - a), (1,)) for w in rc + rk]
    out = _merge_sorted_runs_rows(asc, desc, ncmp, tuning)
    return [w.reshape(-1) for w in out]


def pack_carries(arrays) -> tuple[list, list]:
    """Tensors (leading axis n) -> their carry words, concatenated, and one
    recipe per tensor for :func:`unpack_carries`."""
    words, recipes = [], []
    for a in arrays:
        ws, recipe = array_to_words(a)
        recipe["nwords"] = len(ws)
        words.extend(ws)
        recipes.append(recipe)
    return words, recipes


def unpack_carries(words: list, recipes: list) -> list:
    """Inverse of :func:`pack_carries`: one tensor per recipe."""
    out, pos = [], 0
    for recipe in recipes:
        k = recipe["nwords"]
        out.append(words_to_array(words[pos:pos + k], recipe))
        pos += k
    return out


def sort_arrays_bitonic(bits, arrays, start_bit, end_bit, *,
                        tuning: EngineTuning | None = None):
    """Engine entry: stable sort of ``arrays`` by ``bits[start:end)`` window."""
    n = bits.shape[0]
    if n <= 1:
        return list(arrays)
    if n >= (1 << 32):
        raise ValueError("stable bitonic sort supports n < 2**32")
    cmp_words = bits_to_cmp_words(bits, start_bit, end_bit)
    cmp_words.append(iota_word(n, bits.device))
    carry_words, recipes = pack_carries(arrays)
    _, carry_out = sort_words(cmp_words, carry_words, tuning=tuning)
    return unpack_carries(carry_out, recipes)
