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
"""

from __future__ import annotations

import ctypes
import functools
import os
from dataclasses import dataclass, fields

import torch

from .. import keybits
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


def _stage_groups(substages):
    """Group consecutive substages by stage k: [(k, [j, ...]), ...]."""
    groups: list[tuple[int, list[int]]] = []
    for k, j in substages:
        if groups and groups[-1][0] == k:
            groups[-1][1].append(j)
        else:
            groups.append((k, [j]))
    return groups


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
    """

    smem_tile_bytes: int = 200 * 1024
    cross_g_max: int = 8

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
    """a <_lex b elementwise over equal-length lists of widened words."""
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
    for k, js in _stage_groups(sweep.substages):
        desc = None
        if k != sweep.forced_asc:
            idx = torch.arange(n, dtype=torch.int64, device=words[0].device)
            desc = ((idx >> k) & 1) == 1
        for j in js:
            d = 1 << j
            views = [w.view(-1, 2, d) for w in words]
            lo = [v[:, 0] for v in views]
            hi = [v[:, 1] for v in views]
            lo_u = [unsigned(x) for x in lo[:ncmp]]
            hi_u = [unsigned(x) for x in hi[:ncmp]]
            swap = _lex_lt(hi_u, lo_u)
            if desc is not None:
                swap = torch.where(desc.view(-1, 2, d)[:, 0],
                                   _lex_lt(lo_u, hi_u), swap)
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
    fn = _sweep_fn()
    ptrs = (ctypes.c_void_p * nwords)(*[w.data_ptr() for w in words])
    ks = (ctypes.c_int * len(subs))(*[k for k, _ in subs])
    fbs = (ctypes.c_int * len(subs))(*[sweep.tile_bit(j) for _, j in subs])
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


def sort_words(cmp_words: list, carry_words: list, *,
               tuning: EngineTuning | None = None):
    """Sort int32 word tuples by lexicographic unsigned order of cmp_words.

    Returns ``(cmp_words, carry_words)`` reordered; the inputs are not
    modified. Words must share one length and device.

    Contract: either the cmp tuples are all distinct (e.g. they end in an
    index word), or equal cmp tuples are bit-identical in every word (e.g.
    there are no carry words). The kernel never swaps ties, but the padded
    sentinels must sort after every real tuple.

    Every n takes the padded route: the words are copied into fresh buffers
    of ``2**max(ceil_log2 n, MIN_L)`` (all-ones in cmp words, zeros in carry
    words), the whole network runs in place on them, and the result is
    truncated to n. The output is unique under the contract, so it is
    bit-identical to the JAX package's segmented route for the same input.
    ``tuning=None`` reads the ``THRS_*`` knobs at call time.
    """
    tuning = EngineTuning.from_env() if tuning is None else tuning
    n = cmp_words[0].shape[0]
    if n <= 1:
        return list(cmp_words), list(carry_words)
    ncmp = len(cmp_words)
    L = max(_ceil_log2(n), MIN_L)
    words = [common.pad_to_multiple(w, 1 << L, -1) for w in cmp_words]
    words += [common.pad_to_multiple(w, 1 << L, 0) for w in carry_words]
    words = [w[:n] for w in _run_network(words, ncmp, L, tuning)]
    return words[:ncmp], words[ncmp:]


def _run_network(words: list, ncmp: int, L: int,
                 tuning: EngineTuning) -> list:
    """Run the full network on ``2**L`` words, in place.

    A local sweep's tile is one contiguous run of ``2**T`` elements that a
    block reads with coalesced loads however the run is split, so the low
    chunk is the whole tile (``chunk_bits = T``, ``g = 0``).
    """
    tile_bits = _tile_bits_for(len(words), L, tuning)
    for sweep in plan_sweeps(L, tile_bits, tile_bits,
                             g_max_cross=tuning.cross_g_max):
        words = run_sweep(words, sweep, ncmp)
    return words


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
