"""Per-tile digit histograms, the reference ``blockCount`` (PyTorch port of
``tinyhipradixsort_tpu/ops/histogram.py``).

Reference: kernel.cu:73-103, one thread block per tile builds a 256-bin
shared-memory histogram with atomics. CUDA tensors go through the
hand-written kernel ``csrc/digit_histogram.cu``, which does just that;
CPU tensors through :func:`digit_histogram_reference`, its plain PyTorch
version. The counting engine (:mod:`.counting_engine`) takes its stage-1
counts from here, with each run's column sums (:func:`digit_histogram_runs`,
a second kernel of the same source), and its stage-2 offsets from
:func:`bucket_offsets` (the reference's ``prefixSumExclusiveInplace``,
kernel.cu:136-204): on CUDA tensors the hand-written kernel
``csrc/bucket_scan.cu``, which with the run sums reads the counts once, on
CPU tensors :func:`bucket_offsets_reference`.

Outputs match the reference's layout transposed: ``(num_tiles, 2**width)``
(the reference stores bucket-major, kernel.cu:97; ``counts.T.reshape(-1)``
reproduces its counter array).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import common, cuda_lib

DEFAULT_TILE = 1 << 13
MIN_TILE = 1024
MAX_TILE = 1 << 22

#: launches of the CUDA histogram kernels in this process (counted only
#: where a kernel is launched; :func:`digit_histogram_runs` counts here too)
KERNEL_LAUNCHES = 0
#: launches of the run-sum histogram kernel (:func:`digit_histogram_runs`)
RUN_LAUNCHES = 0
#: launches of the CUDA bucket-scan kernel (stage 2) in this process
#: (counted only where the kernel is launched)
SCAN_LAUNCHES = 0
#: of those, the calls that launched the summing walk (no run sums given,
#: and more than one run a row), which reads the counts a second time
SCAN_SUM_WALKS = 0
#: widest digit :func:`bucket_offsets` and :func:`digit_histogram_runs`
#: take (the reference's 8 bits)
SCAN_MAX_WIDTH = 8
#: most tiles in a run: stage 1 writes one column sum a run, and stage 2's
#: walk takes one run a thread
RUN_TILES = 128
#: most elements in a run of tiles larger than ``RUN_ELEMENTS // RUN_TILES``
RUN_ELEMENTS = 1 << 18


def round_tile(tile: int) -> int:
    """The tile the histogram really uses: a multiple of 128 in
    ``[1024, 2**22]`` (the tile is a throughput knob, not a semantic
    contract; counts are per returned tile)."""
    return max(MIN_TILE, min(-(-tile // 128) * 128, MAX_TILE))


def run_tiles(tiles: int, tile: int) -> int:
    """Tiles in each run of a row of ``tiles`` tiles of ``tile`` elements
    (the row's last run may be shorter): ``RUN_TILES``, fewer for tiles
    above 2048 elements, and at most the row."""
    return max(1, min(RUN_TILES, RUN_ELEMENTS // tile, tiles))


def _check(bits: torch.Tensor, shift: int, width: int) -> torch.Tensor:
    """``bits`` as a 1-D int32/int64 tensor (unsigned ones by their signed
    view), after checking the digit window."""
    if bits.dtype in (torch.uint32, torch.uint64):
        bits = bits.view(torch.int32 if bits.dtype == torch.uint32
                         else torch.int64)
    if bits.dtype not in (torch.int32, torch.int64) or bits.ndim != 1:
        raise TypeError("digit_histogram takes 1-D 32- or 64-bit key bits, "
                        f"got {bits.dtype} of shape {tuple(bits.shape)}")
    nbits = bits.dtype.itemsize * 8
    # 64-bit bits are first shifted into a 32-bit word, so the window of
    # the word is [0, width)
    word_end = width if nbits == 64 else shift + width
    if not (0 <= shift < nbits and width >= 1 and word_end <= 32):
        raise ValueError(f"digit window shift={shift} width={width} does not "
                         f"fit {nbits}-bit bits (shift + width <= 32 after a "
                         "64-bit shift)")
    return bits


def _stream(device: torch.device) -> int:
    """The handle of the current CUDA stream on ``device``, as
    ``torch.cuda.current_stream(device).cuda_stream`` gives it but without
    making a ``Stream`` (a stage-2 call's host time shows in its time)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _num_tiles(n: int, tile: int) -> int:
    return -(-max(n, 1) // tile)


def digit_histogram_reference(bits: torch.Tensor, shift: int = 0,
                              width: int = 8,
                              tile: int = DEFAULT_TILE) -> torch.Tensor:
    """Plain PyTorch version of the kernel: one ``bincount`` over
    ``(tile_id << width) | digit``, with the all-ones tail pad counted into
    the last tile's top bucket."""
    bits = _check(bits, shift, width)
    tile = round_tile(tile)
    n = bits.shape[0]
    T = _num_tiles(n, tile)
    nb = 1 << width
    digit = common.extract_digit(bits, shift, width).to(torch.int64)
    tile_id = torch.arange(n, dtype=torch.int64, device=bits.device) // tile
    counts = torch.bincount((tile_id << width) | digit, minlength=T * nb)
    counts = counts.view(T, nb)
    counts[-1, -1] += T * tile - n
    return counts.to(torch.int32)


@functools.cache
def _hist_fn():
    fn = cuda_lib.load("digit_histogram").thrs_digit_histogram
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_histogram(bits: torch.Tensor, shift: int, width: int,
                      tile: int) -> torch.Tensor:
    global KERNEL_LAUNCHES
    bits = _check(bits, shift, width).contiguous()
    tile = round_tile(tile)
    n = bits.shape[0]
    T = _num_tiles(n, tile)
    out = torch.empty((T, 1 << width), dtype=torch.int32, device=bits.device)
    fn = _hist_fn()
    with torch.cuda.device(bits.device):
        stream = torch.cuda.current_stream(bits.device).cuda_stream
        rc = fn(bits.data_ptr(), bits.dtype.itemsize, n, shift, width, tile,
                T, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"digit histogram kernel launch failed: CUDA error "
                           f"{rc} (n={n} shift={shift} width={width} "
                           f"tile={tile})")
    KERNEL_LAUNCHES += 1
    return out


def digit_histogram(bits: torch.Tensor, shift: int = 0, width: int = 8,
                    tile: int = DEFAULT_TILE) -> torch.Tensor:
    """Histogram of the digit ``bits[shift : shift + width]`` per tile.

    bits: 1-D key bits (int32/int64 holding the unsigned pattern, or
    uint32/uint64). Returns ``(num_tiles, 2**width)`` int32. The tile is
    rounded by :func:`round_tile`; the tail is counted as if padded with
    all-ones bits, whose digit is ``2**width - 1`` for every window, so the
    pad inflates the last tile's top bucket. Callers that need exact counts
    subtract ``num_tiles * tile - n`` from ``counts[-1, -1]``. 64-bit bits
    are first shifted into a 32-bit word; then ``shift + width <= 32``.

    CUDA tensors go through the kernel (built at first use), CPU tensors
    through :func:`digit_histogram_reference`; any other device raises.
    """
    if common.on_cuda(bits):
        return _launch_histogram(bits, shift, width, tile)
    if bits.device.type != "cpu":
        raise ValueError(f"no histogram implementation for {bits.device}")
    return digit_histogram_reference(bits, shift, width, tile)


def _check_rows(T: int, tiles_per_row: int, width: int) -> None:
    if width > SCAN_MAX_WIDTH:
        raise ValueError(f"digit_histogram_runs takes digits of at most "
                         f"{SCAN_MAX_WIDTH} bits, got {width}")
    if tiles_per_row < 1 or T % tiles_per_row:
        raise ValueError(f"{T} tiles are not rows of {tiles_per_row} tiles")


def run_sums_reference(counts: torch.Tensor, tile: int) -> torch.Tensor:
    """Each run's column sums of ``counts`` (``(rows, tiles, 2**width)``
    int32, runs of :func:`run_tiles` tiles of ``tile``, the last run of a
    row short): ``(rows, runs, 2**width)`` int64."""
    R, Tr, nb = counts.shape
    run = run_tiles(Tr, tile)
    runs = -(-Tr // run)
    padded = counts.new_zeros((R, runs * run, nb), dtype=torch.int64)
    padded[:, :Tr] = counts
    return padded.view(R, runs, run, nb).sum(2)


def digit_histogram_runs_reference(bits: torch.Tensor, shift: int,
                                   width: int, tile: int,
                                   tiles_per_row: int):
    """Plain PyTorch version of the run-sum kernel:
    :func:`digit_histogram_reference`'s counts, and
    :func:`run_sums_reference` of them."""
    counts = digit_histogram_reference(bits, shift, width, tile)
    T, nb = counts.shape
    _check_rows(T, tiles_per_row, width)
    return counts, run_sums_reference(
        counts.view(T // tiles_per_row, tiles_per_row, nb), round_tile(tile))


@functools.cache
def _runs_fn():
    fn = cuda_lib.load("digit_histogram").thrs_digit_histogram_runs
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_histogram_runs(bits: torch.Tensor, shift: int, width: int,
                           tile: int, tiles_per_row: int):
    global KERNEL_LAUNCHES, RUN_LAUNCHES
    bits = _check(bits, shift, width).contiguous()
    tile = round_tile(tile)
    n = bits.shape[0]
    T = _num_tiles(n, tile)
    _check_rows(T, tiles_per_row, width)
    run = run_tiles(tiles_per_row, tile)
    nb = 1 << width
    counts = torch.empty((T, nb), dtype=torch.int32, device=bits.device)
    sums = torch.empty((T // tiles_per_row, -(-tiles_per_row // run), nb),
                       dtype=torch.int64, device=bits.device)
    fn = _runs_fn()
    with torch.cuda.device(bits.device):
        stream = _stream(bits.device)
        rc = fn(bits.data_ptr(), bits.dtype.itemsize, n, shift, width, tile,
                T, tiles_per_row, run, counts.data_ptr(), sums.data_ptr(),
                stream)
    if rc != 0:
        raise RuntimeError(f"run-sum histogram kernel launch failed: CUDA "
                           f"error {rc} (n={n} shift={shift} width={width} "
                           f"tile={tile} tiles_per_row={tiles_per_row})")
    KERNEL_LAUNCHES += 1
    RUN_LAUNCHES += 1
    return counts, sums


def digit_histogram_runs(bits: torch.Tensor, shift: int, width: int,
                         tile: int, tiles_per_row: int):
    """:func:`digit_histogram`'s counts, and each run's column sums for
    :func:`bucket_offsets`: ``(counts, run_sums)``.

    The counts' ``num_tiles`` tiles are rows of ``tiles_per_row`` tiles;
    each row's tiles are cut into runs of :func:`run_tiles` tiles (the last
    run of a row may be shorter). ``run_sums`` is ``(rows, runs, 2**width)``
    int64: the sum of each bucket's counts over each run (the tail's pad
    included). Digits of at most :data:`SCAN_MAX_WIDTH` bits.

    CUDA tensors go through the kernel (built at first use), CPU tensors
    through :func:`digit_histogram_runs_reference`; any other device raises.
    """
    if common.on_cuda(bits):
        return _launch_histogram_runs(bits, shift, width, tile,
                                      tiles_per_row)
    if bits.device.type != "cpu":
        raise ValueError(f"no histogram implementation for {bits.device}")
    return digit_histogram_runs_reference(bits, shift, width, tile,
                                          tiles_per_row)


def exclusive_scan_bucket_major(counts: torch.Tensor) -> torch.Tensor:
    """Reference counter scan: flat exclusive prefix sum over the
    bucket-major (bucket, tile) counter array (kernel.cu:136-204), in the
    counts' own dtype. ``counts`` is ``(T, B)``, or ``(R, T, B)`` for R
    independent rows (each row scanned on its own)."""
    flat = counts.transpose(-1, -2).reshape(*counts.shape[:-2], -1)
    ex = torch.cumsum(flat, dim=-1, dtype=counts.dtype) - flat
    return ex.view(*counts.shape[:-2], counts.shape[-1],
                   counts.shape[-2]).transpose(-1, -2)


def _check_counts(counts: torch.Tensor, tile: int,
                  idx_dtype: torch.dtype) -> None:
    if counts.dtype != torch.int32 or counts.ndim != 3:
        raise TypeError("bucket_offsets takes (rows, tiles, 2**width) int32 "
                        f"counts, got {counts.dtype} of shape "
                        f"{tuple(counts.shape)}")
    if not counts.is_contiguous():
        raise ValueError("bucket_offsets takes contiguous counts")
    nb = counts.shape[2]
    if nb < 2 or nb & (nb - 1) or nb > 1 << SCAN_MAX_WIDTH:
        raise ValueError(f"bucket_offsets takes 2**width buckets with width "
                         f"1-{SCAN_MAX_WIDTH}, got {nb}")
    if idx_dtype not in (torch.int32, torch.int64):
        raise TypeError(f"bucket_offsets writes int32 or int64, not "
                        f"{idx_dtype}")
    R, Tr = counts.shape[:2]
    if tile < 1 or (idx_dtype == torch.int32 and R * Tr * tile >= 2**31):
        raise ValueError(f"{R} rows of {Tr} tiles of {tile} do not take "
                         f"{idx_dtype} offsets")


def _check_run_sums(counts: torch.Tensor, tile: int,
                    run_sums: torch.Tensor) -> None:
    R, Tr, nb = counts.shape
    want = (R, -(-Tr // run_tiles(Tr, tile)), nb)
    if (run_sums.dtype != torch.int64 or tuple(run_sums.shape) != want
            or not run_sums.is_contiguous()
            or run_sums.device != counts.device):
        raise ValueError(f"run_sums must be contiguous {want} int64 on "
                         f"{counts.device}, got {tuple(run_sums.shape)} "
                         f"{run_sums.dtype} on {run_sums.device}")


def bucket_offsets_reference(counts: torch.Tensor, tile: int,
                             idx_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of the kernel: each row's
    :func:`exclusive_scan_bucket_major` in ``idx_dtype``, plus the row's
    start, made contiguous."""
    _check_counts(counts, tile, idx_dtype)
    R, Tr, _ = counts.shape
    base = exclusive_scan_bucket_major(counts.to(idx_dtype))
    row0 = torch.arange(R, dtype=idx_dtype, device=counts.device) * (Tr * tile)
    return (base + row0.view(R, 1, 1)).contiguous()


@functools.cache
def _scan_fns():
    lib = cuda_lib.load("bucket_scan")
    scratch = lib.thrs_bucket_scan_scratch
    scratch.argtypes = [ctypes.c_longlong, ctypes.c_longlong,
                        ctypes.c_longlong, ctypes.c_int]
    scratch.restype = ctypes.c_longlong
    fn = lib.thrs_bucket_scan
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, scratch


def _launch_bucket_scan(counts: torch.Tensor, tile: int,
                        idx_dtype: torch.dtype, run_sums) -> torch.Tensor:
    global SCAN_LAUNCHES, SCAN_SUM_WALKS
    _check_counts(counts, tile, idx_dtype)
    R, Tr, nb = counts.shape
    out = torch.empty((R, Tr, nb), dtype=idx_dtype, device=counts.device)
    if out.numel() == 0:
        return out
    width = nb.bit_length() - 1
    run = run_tiles(Tr, tile)
    fn, scratch_words = _scan_fns()
    if run_sums is None:
        words = scratch_words(R, Tr, run, width)
        sums = (torch.empty(words, dtype=torch.int64, device=counts.device)
                if words else None)
    else:
        _check_run_sums(counts, tile, run_sums)
        sums = run_sums
    with torch.cuda.device(counts.device):
        stream = _stream(counts.device)
        rc = fn(counts.data_ptr(), R, Tr, width, tile, run, out.data_ptr(),
                idx_dtype.itemsize,
                sums.data_ptr() if sums is not None else None,
                run_sums is not None, stream)
    if rc != 0:
        raise RuntimeError(f"bucket scan kernel launch failed: CUDA error "
                           f"{rc} (rows={R} tiles={Tr} width={width} "
                           f"tile={tile})")
    SCAN_LAUNCHES += 1
    SCAN_SUM_WALKS += run_sums is None and run < Tr
    return out


def bucket_offsets(counts: torch.Tensor, tile: int, idx_dtype: torch.dtype,
                   run_sums: torch.Tensor | None = None) -> torch.Tensor:
    """Stage 2 of the counting engine's pass: the global start of each
    (tile, bucket) of ``counts`` in the pass's output.

    counts: stage 1's ``(rows, tiles per row, 2**width)`` int32, contiguous,
    with ``width <= SCAN_MAX_WIDTH``; tile: the elements a tile. Returns a
    fresh contiguous ``(rows, tiles per row, 2**width)`` tensor in
    ``idx_dtype`` (int32, where ``rows * tiles * tile < 2**31``, or int64):
    ``out[r, t, b] = r * tiles * tile + counts[r, :, :b].sum() +
    counts[r, :t, b].sum()``, each row's bucket-major exclusive scan plus
    the row's start, in the layout :func:`.counting_engine.rank_scatter`
    reads.

    run_sums: the counts' run sums from :func:`digit_histogram_runs` (or
    :func:`run_sums_reference`), with which the kernel reads the counts
    once. It scans them in place: afterwards they hold each run's inclusive
    prefix over its row, so they serve one call. Without them the kernel
    sums the counts itself first (:data:`SCAN_SUM_WALKS`), or, for rows of
    one run, each thread sums its column before it walks it (one kernel).

    CUDA tensors go through the kernel (built at first use), CPU tensors
    through :func:`bucket_offsets_reference`, which needs no run sums (it
    checks them and leaves them as they are); any other device raises.
    """
    if common.on_cuda(counts):
        return _launch_bucket_scan(counts, tile, idx_dtype, run_sums)
    if counts.device.type != "cpu":
        raise ValueError(f"no bucket_offsets implementation for "
                         f"{counts.device}")
    if run_sums is not None:
        _check_counts(counts, tile, idx_dtype)
        _check_run_sums(counts, tile, run_sums)
    return bucket_offsets_reference(counts, tile, idx_dtype)
