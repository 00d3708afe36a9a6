"""Tiled counting-sort engine (PyTorch port of
``tinyhipradixsort_tpu/ops/counting_engine.py``).

The reference's three-stage pass, in the same functional form as the JAX
package (reference: tinyhipradixsort.hpp:867-933,
kernel.cu:73-103/136-204/206-429):

1. per-tile histogram of the current digit (<- blockCount), with each run
   of tiles' column sums where a row holds more than one run
   (:func:`histogram.digit_histogram_runs`): on CUDA tensors the
   hand-written kernel of :mod:`.histogram`, on CPU tensors its plain
   version;
2. bucket-major exclusive scan of the ``[B, T]`` counters
   (<- prefixSumExclusiveInplace; the layout ``bucket * numTiles + tile`` is
   the reference's, kernel.cu:97, so a flat exclusive scan gives each
   (bucket, tile) its global base offset), :func:`histogram.bucket_offsets`
   given stage 1's run sums: on CUDA tensors the hand-written kernel
   ``csrc/bucket_scan.cu``, which reads the counts once and writes the
   offsets in the tile-major layout stage 3 reads (rows of one run, which
   need no run sums, take its one-kernel route), on CPU tensors its plain
   version;
3. stable rank within the tile + scatter (<- reorderKey/reorderKeyPair),
   :func:`rank_scatter`: on CUDA tensors the hand-written kernel
   ``csrc/rank_scatter.cu`` (per-warp digit masks and counters, the
   reference's warp-level match), on CPU tensors
   :func:`rank_scatter_reference`, the JAX package's one-hot cumulative
   sum taken a chunk of tiles at a time (its ``lax.map``). Both move up to
   :data:`MAX_PAYLOADS` arrays with the bits (the reference's
   ``reorderKeyPair`` moves its values so); an array left over is gathered
   by the pass's inverse permutation ``src``, which is written only then.

Padding sorts to the tail: all-ones bits take the top digit in every pass,
and stability keeps them after every real element. Batched ``(B, n)`` rows
are padded row by row, so each row owns a range of whole tiles and one pass
sorts every row at once (the JAX package vmaps the row sort).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import tracing
from . import common, cuda_lib, histogram

DEFAULT_TILE = 2048  # reference RADIX_SORT_BLOCK_SIZE (hpp:19)
# one-hot rank transient of the plain version: elements x buckets per chunk
# of tiles (1 byte of compare and 4 bytes of cumulative sum each: ~1.3 GB)
RANK_CHUNK = 1 << 28
#: widest digit the rank-and-scatter kernel takes (the reference's 8 bits)
KERNEL_MAX_WIDTH = 8

#: payloads one rank-and-scatter call carries, and the row sizes it takes
#: (the reference's 4-, 8- and 16-byte values, the 1-byte -0.0 flag and
#: 2-byte 16-bit keys)
MAX_PAYLOADS = 4
ROW_BYTES = (1, 2, 4, 8, 16)

#: launches of the CUDA rank-and-scatter kernel in this process (counted
#: only where the kernel is launched)
KERNEL_LAUNCHES = 0
#: arrays the engine gathered by ``src`` with :func:`common.take` on CUDA
#: tensors (those it could not carry through the kernel)
GATHERED = 0


def _index_dtype(n: int) -> torch.dtype:
    return torch.int32 if n < 2**31 else torch.int64


def _pad_rows(a: torch.Tensor, multiple: int, fill: int) -> torch.Tensor:
    """Pad the element axis (axis 1) of batched ``(B, n, ...)`` ``a`` to a
    multiple of ``multiple`` with ``fill``; a fresh contiguous tensor.
    Trailing axes (an ``(n, 4)`` u128 payload per row) pad by whole rows."""
    B, n = a.shape[:2]
    npad = -(-max(n, 1) // multiple) * multiple
    out = torch.empty((B, npad, *a.shape[2:]), dtype=a.dtype, device=a.device)
    out[:, :n] = a
    out[:, n:] = fill
    return out


def _tile_ranks(digits: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """digits: ``(T, tile)`` int32 -> ``(T, tile)`` int32 stable rank of each
    element among the equal digits before it in its tile (one-hot cumulative
    sum, a chunk of tiles at a time)."""
    T, tile = digits.shape
    ids = torch.arange(num_buckets, dtype=torch.int32,
                       device=digits.device).view(1, -1, 1)
    rank = torch.empty_like(digits)
    step = max(1, RANK_CHUNK // (num_buckets * tile))
    for t0 in range(0, T, step):
        d = digits[t0:t0 + step]
        csum = torch.cumsum(d.unsqueeze(1) == ids, dim=2, dtype=torch.int32)
        rank[t0:t0 + step] = csum.gather(1, d.unsqueeze(1).long()).squeeze(1) - 1
        del csum
    return rank


def payload_row_bytes(p: torch.Tensor, n: int) -> int:
    """Bytes of one row of a payload of ``n`` rows: ``numel // n *
    itemsize`` (an ``(n, 4)`` u32 leaf is one 16-byte row)."""
    return p.numel() // n * p.dtype.itemsize if n else p.dtype.itemsize


def _check_rank_scatter(bits, shift, width, base, tile, idx_dtype, payloads):
    if bits.dtype not in (torch.int32, torch.int64) or bits.ndim != 1:
        raise TypeError("rank_scatter takes 1-D int32/int64 key bits, got "
                        f"{bits.dtype} of shape {tuple(bits.shape)}")
    if idx_dtype not in (torch.int32, torch.int64):
        raise TypeError(f"rank_scatter indices are int32 or int64, not "
                        f"{idx_dtype}")
    nbits = bits.dtype.itemsize * 8
    if not (0 <= shift and width >= 1 and shift + width <= nbits):
        raise ValueError(f"digit window shift={shift} width={width} does not "
                         f"fit {nbits}-bit bits")
    n = bits.shape[0]
    if (base.ndim != 3 or base.shape[2] != 1 << width
            or base.dtype != idx_dtype):
        raise ValueError(f"base must be (rows, tiles per row, {1 << width}) "
                         f"{idx_dtype}, got {tuple(base.shape)} {base.dtype}")
    if tile < 1 or n != base.shape[0] * base.shape[1] * tile:
        raise ValueError(f"{n} bits are not {base.shape[0]} rows of "
                         f"{base.shape[1]} tiles of {tile}")
    if len(payloads) > MAX_PAYLOADS:
        raise ValueError(f"rank_scatter carries at most {MAX_PAYLOADS} "
                         f"payloads, got {len(payloads)}")
    for k, p in enumerate(payloads):
        if p.ndim == 0 or p.shape[0] != n or not p.is_contiguous():
            raise ValueError(f"payload {k} must be a contiguous tensor with "
                             f"{n} rows on axis 0, got {tuple(p.shape)}")
        if payload_row_bytes(p, n) not in ROW_BYTES:
            raise ValueError(f"payload {k} has rows of "
                             f"{payload_row_bytes(p, n)} bytes; rank_scatter "
                             f"carries rows of {ROW_BYTES} bytes")
        if p.device != bits.device:
            raise ValueError(f"payload {k} is on {p.device}, bits on "
                             f"{bits.device}")


def rank_scatter_reference(bits: torch.Tensor, shift: int, width: int,
                           base: torch.Tensor, tile: int,
                           idx_dtype: torch.dtype, payloads=(),
                           want_src: bool = True):
    """Plain PyTorch version of the kernel: the one-hot rank of
    :func:`_tile_ranks`, the ``dest`` gather from ``base``, the scatter of
    an iota into ``src``, and the bits and each payload gathered by
    ``src``."""
    _check_rank_scatter(bits, shift, width, base, tile, idx_dtype, payloads)
    digits = common.extract_digit(bits, shift, width).view(-1, tile)
    rank = _tile_ranks(digits, 1 << width)
    dest = base.reshape(-1, 1 << width).gather(1, digits.long()) + rank
    n = bits.shape[0]
    src = torch.empty(n, dtype=idx_dtype, device=bits.device)
    src[dest.view(-1).long()] = torch.arange(n, dtype=idx_dtype,
                                             device=bits.device)
    moved = [common.take(p, src) for p in payloads]
    return common.take(bits, src), src if want_src else None, moved


class _Payload(ctypes.Structure):
    """One entry of the C interface's payload array."""
    _fields_ = [("src", ctypes.c_void_p), ("dst", ctypes.c_void_p),
                ("row_bytes", ctypes.c_longlong)]


@functools.cache
def _rank_scatter_fn():
    fn = cuda_lib.load("rank_scatter").thrs_rank_scatter
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(_Payload), ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous, at an address the kernel's 16-byte copies take."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_rank_scatter(bits, shift, width, base, tile, idx_dtype, payloads,
                         want_src):
    global KERNEL_LAUNCHES
    _check_rank_scatter(bits, shift, width, base, tile, idx_dtype, payloads)
    if width > KERNEL_MAX_WIDTH:
        raise ValueError(f"the rank-and-scatter kernel takes digits of at "
                         f"most {KERNEL_MAX_WIDTH} bits, got {width}")
    if tile % 128:
        raise ValueError(f"the rank-and-scatter kernel takes tiles that are "
                         f"multiples of 128, got {tile}")
    if base.device != bits.device:
        raise ValueError(f"base is on {base.device}, bits on {bits.device}")
    bits = _aligned(bits)
    payloads = [_aligned(p) for p in payloads]
    base = base.contiguous()
    n = bits.shape[0]
    bits_out = torch.empty_like(bits)
    src = torch.empty(n, dtype=idx_dtype, device=bits.device) if want_src \
        else None
    moved = [torch.empty_like(p) for p in payloads]
    if n == 0:
        return bits_out, src, moved
    # the kernel hands its blocks their work in order from this counter
    tickets = torch.zeros(1, dtype=torch.int32, device=bits.device)
    with tracing.span("launch.rank_scatter", n=n, words=len(payloads)):
        tracing.count("launches")
        table = (_Payload * MAX_PAYLOADS)()
        for k, (p, q) in enumerate(zip(payloads, moved)):
            table[k] = _Payload(p.data_ptr(), q.data_ptr(),
                                payload_row_bytes(p, n))
        fn = _rank_scatter_fn()
        with torch.cuda.device(bits.device):
            stream = torch.cuda.current_stream(bits.device).cuda_stream
            rc = fn(bits.data_ptr(), bits.dtype.itemsize, n, base.shape[0],
                    shift, width, tile, base.data_ptr(), idx_dtype.itemsize,
                    bits_out.data_ptr(), src.data_ptr() if want_src else None,
                    table, len(payloads), stream, tickets.data_ptr())
    if rc != 0:
        raise RuntimeError(f"rank-and-scatter kernel launch failed: CUDA "
                           f"error {rc} (n={n} shift={shift} width={width} "
                           f"tile={tile} rows={base.shape[0]} payloads="
                           f"{len(payloads)})")
    KERNEL_LAUNCHES += 1
    return bits_out, src, moved


def rank_scatter(bits: torch.Tensor, shift: int, width: int,
                 base: torch.Tensor, tile: int, idx_dtype: torch.dtype,
                 payloads=(), want_src: bool = True):
    """Stage 3 of one pass: ``(bits_out, src, moved)`` with ``bits_out =
    bits[src]`` and ``moved[k] = payloads[k][src]``, where element ``i`` of
    tile ``t`` with digit ``d`` goes to ``base[t, d]`` plus its stable rank
    among the equal digits before it in its tile.

    bits: the flat padded key bits of the pass (int32/int64 holding the
    unsigned pattern), ``rows`` rows of whole tiles of ``tile``; base:
    ``(rows, tiles per row, 2**width)`` in ``idx_dtype`` (int32 or int64),
    stage 2's offsets (each row's bucket-major exclusive scan plus the
    row's start). ``src`` is the inverse permutation in ``idx_dtype``
    (``out = x[src]``), or None when ``want_src`` is false. payloads: at
    most :data:`MAX_PAYLOADS` contiguous tensors with the n elements on
    axis 0 and rows of :data:`ROW_BYTES` bytes, moved bit for bit; any
    other payload raises.

    CUDA tensors go through the kernel (built at first use; digits of at
    most :data:`KERNEL_MAX_WIDTH` bits), CPU tensors through
    :func:`rank_scatter_reference`; any other device raises.
    """
    payloads = tuple(payloads)
    if common.on_cuda(bits):
        return _launch_rank_scatter(bits, shift, width, base, tile, idx_dtype,
                                    payloads, want_src)
    if bits.device.type != "cpu":
        raise ValueError(f"no rank_scatter implementation for {bits.device}")
    return rank_scatter_reference(bits, shift, width, base, tile, idx_dtype,
                                  payloads, want_src)


def _pass(bits, shift: int, width: int, counts, tile: int, idx_dt, payloads,
          want_src: bool, run_sums=None, at=None):
    """One pass of R rows of Tr tiles: ``bits`` flat, its per-tile counts
    ``(R, Tr, 2**width)`` and their run sums (consumed, see
    :func:`histogram.bucket_offsets`) -> :func:`rank_scatter`'s
    ``(bits_out, src, moved)``, ``src`` indexing the flat rows with ``out =
    x[src]``. ``at``: the pass's span attributes."""
    at = at or {}
    # stage 2: each row's bucket-major exclusive scan, offset to its range
    with tracing.span("counting.scan", **at):
        base = histogram.bucket_offsets(counts, tile, idx_dt,
                                        run_sums=run_sums)
    with tracing.span("counting.rank_scatter", **at):
        return rank_scatter(bits, shift, width, base, tile, idx_dt, payloads,
                            want_src)


def carried(arrays, n: int) -> list[int]:
    """Which of ``arrays`` (each with ``n`` rows on axis 0) the kernel
    carries as payloads: the first :data:`MAX_PAYLOADS` whose rows it
    takes. The others are gathered by ``src``."""
    ok = [k for k, a in enumerate(arrays)
          if payload_row_bytes(a, n) in ROW_BYTES]
    return ok[:MAX_PAYLOADS]


def sort_arrays_counting(bits, arrays, start_bit: int, end_bit: int,
                         radix_bits: int = common.RADIX_BITS,
                         tile: int = DEFAULT_TILE):
    """Stable sort of ``arrays`` by the window ``[start_bit, end_bit)`` of
    ``bits`` (``(n,)``, or ``(B, n)`` rows sorted each on its own).

    ``tile`` must be a histogram tile (:func:`histogram.round_tile` leaves it
    as it is), and ``radix_bits`` at most :data:`histogram.SCAN_MAX_WIDTH`
    (the reference's 8).

    Up to :data:`MAX_PAYLOADS` arrays ride through :func:`rank_scatter` as
    payloads (:func:`carried`); ``src`` is asked for only when an array is
    left over, and the leftovers are gathered by it.

    While :mod:`..tracing` records, the sort is the span ``counting.sort``
    and its stages its children: ``counting.pad``, then in each pass
    (attributes ``pass`` and ``shift``) ``counting.histogram``,
    ``counting.scan``, ``counting.rank_scatter`` and ``counting.gathers``.
    """
    if tile != histogram.round_tile(tile):
        raise ValueError(f"tile {tile} is not a histogram tile (a multiple "
                         "of 128 in [1024, 2**22])")
    with tracing.span("counting.sort", n=bits.shape[-1], words=len(arrays)):
        return _sort_counting(bits, arrays, start_bit, end_bit, radix_bits,
                              tile)


def _sort_counting(bits, arrays, start_bit, end_bit, radix_bits, tile):
    """:func:`sort_arrays_counting` inside its span."""
    global GATHERED
    batched = bits.ndim == 2
    if not batched:
        bits = bits.unsqueeze(0)
        arrays = [a.unsqueeze(0) for a in arrays]
    R, n = bits.shape
    if n <= 1 or R == 0:
        out = [a.clone() for a in arrays]
    else:
        with tracing.span("counting.pad"):
            bits_p = _pad_rows(bits, tile, -1)
            arrays_p = [_pad_rows(a, tile, 0) for a in arrays]
        npad = bits_p.shape[1]
        idx_dt = _index_dtype(R * npad)
        Tr = npad // tile
        bits_p = bits_p.view(-1)
        arrays_p = [a.view(R * npad, *a.shape[2:]) for a in arrays_p]
        keep = carried(arrays_p, R * npad)
        rest = [k for k in range(len(arrays_p)) if k not in keep]
        plan = common.digit_plan(start_bit, end_bit, radix_bits)
        for i, (shift, width) in enumerate(plan):
            at = {"pass": i, "shift": shift}  # the pass's span attributes
            # stage 1: per-tile counts, and each run's column sums where a
            # row holds several runs (each row is whole tiles: no tail pad);
            # a row of one run is summed in stage 2's one kernel, cheaper
            # than run sums as large as its counts
            with tracing.span("counting.histogram", **at):
                if Tr > histogram.run_tiles(Tr, tile):
                    counts, run_sums = histogram.digit_histogram_runs(
                        bits_p, shift, width, tile, Tr)
                else:
                    counts = histogram.digit_histogram(bits_p, shift, width,
                                                       tile)
                    run_sums = None
            bits_p, src, moved = _pass(
                bits_p, shift, width, counts.view(R, Tr, 1 << width), tile,
                idx_dt, [arrays_p[k] for k in keep], bool(rest), run_sums,
                at)
            with tracing.span("counting.gathers", **at):
                for k, a in zip(keep, moved):
                    arrays_p[k] = a
                for k in rest:
                    arrays_p[k] = common.take(arrays_p[k], src)
                    GATHERED += common.on_cuda(src)
        out = [a.view(R, npad, *a.shape[1:])[:, :n].contiguous()
               for a in arrays_p]
    if not batched:
        out = [a[0] for a in out]
    return out
