"""Tiled counting-sort engine (PyTorch port of
``tinyhipradixsort_tpu/ops/counting_engine.py``).

The reference's three-stage pass, in the same functional form as the JAX
package (reference: tinyhipradixsort.hpp:867-933,
kernel.cu:73-103/136-204/206-429):

1. per-tile histogram of the current digit (<- blockCount): on CUDA tensors
   the hand-written kernel of :mod:`.histogram`, on CPU tensors its plain
   version;
2. bucket-major exclusive scan of the ``[B, T]`` counters
   (<- prefixSumExclusiveInplace; the layout ``bucket * numTiles + tile`` is
   the reference's, kernel.cu:97, so a flat exclusive scan gives each
   (bucket, tile) its global base offset);
3. stable rank within the tile + scatter (<- reorderKey/reorderKeyPair):
   the rank is a one-hot cumulative sum, taken a chunk of tiles at a time
   (the JAX package's ``lax.map``) so that the transient stays near 1 GB;
   the scatter builds the inverse permutation, which is applied as gathers.
   Stage 3 is plain PyTorch, as it is jnp in the JAX package.

Padding sorts to the tail: all-ones bits take the top digit in every pass,
and stability keeps them after every real element. Batched ``(B, n)`` rows
are padded row by row, so each row owns a range of whole tiles and one pass
sorts every row at once (the JAX package vmaps the row sort).
"""

from __future__ import annotations

import torch

from . import common, histogram

DEFAULT_TILE = 2048  # reference RADIX_SORT_BLOCK_SIZE (hpp:19)
# one-hot rank transient: elements x buckets per chunk of tiles (1 byte of
# compare and 4 bytes of cumulative sum each: ~1.3 GB)
RANK_CHUNK = 1 << 28


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


def _pass_inverse_perm(digits, counts, num_buckets: int, idx_dt, mark):
    """One pass's permutation: digits ``(R, Tr, tile)`` of R rows of Tr
    tiles and their per-tile counts ``(R, Tr, B)`` -> ``src`` of
    ``R * Tr * tile`` indices (into the flat rows) with ``out = x[src]``."""
    R, Tr, tile = digits.shape
    # stage 2: each row's bucket-major exclusive scan, offset to its range
    base = histogram.exclusive_scan_bucket_major(counts.to(idx_dt))
    row0 = torch.arange(R, dtype=idx_dt, device=digits.device) * (Tr * tile)
    base = (base + row0.view(R, 1, 1)).reshape(R * Tr, num_buckets)
    mark("scan")
    flat_digits = digits.view(R * Tr, tile)
    rank = _tile_ranks(flat_digits, num_buckets)
    mark("rank")
    dest = base.gather(1, flat_digits.long()) + rank
    n = R * Tr * tile
    src = torch.empty(n, dtype=idx_dt, device=digits.device)
    src[dest.view(-1).long()] = torch.arange(n, dtype=idx_dt,
                                             device=digits.device)
    mark("scatter")
    return src


def sort_arrays_counting(bits, arrays, start_bit: int, end_bit: int,
                         radix_bits: int = common.RADIX_BITS,
                         tile: int = DEFAULT_TILE, mark=None):
    """Stable sort of ``arrays`` by the window ``[start_bit, end_bit)`` of
    ``bits`` (``(n,)``, or ``(B, n)`` rows sorted each on its own).

    ``tile`` must be a histogram tile (:func:`histogram.round_tile` leaves it
    as it is). ``mark(stage)``, when given, is called after the padding
    (``"pad"``) and after each stage of each pass (``"histogram"``,
    ``"scan"``, ``"rank"``, ``"scatter"`` and ``"gathers"``), for timing.
    """
    if tile != histogram.round_tile(tile):
        raise ValueError(f"tile {tile} is not a histogram tile (a multiple "
                         "of 128 in [1024, 2**22])")
    mark = mark or (lambda stage: None)
    batched = bits.ndim == 2
    if not batched:
        bits = bits.unsqueeze(0)
        arrays = [a.unsqueeze(0) for a in arrays]
    R, n = bits.shape
    if n <= 1 or R == 0:
        out = [a.clone() for a in arrays]
    else:
        bits_p = _pad_rows(bits, tile, -1)
        arrays_p = [_pad_rows(a, tile, 0) for a in arrays]
        npad = bits_p.shape[1]
        idx_dt = _index_dtype(R * npad)
        Tr = npad // tile
        bits_p = bits_p.view(-1)
        arrays_p = [a.view(R * npad, *a.shape[2:]) for a in arrays_p]
        mark("pad")
        for shift, width in common.digit_plan(start_bit, end_bit, radix_bits):
            # stage 1: per-tile counts (each row is whole tiles: no tail pad)
            counts = histogram.digit_histogram(bits_p, shift, width, tile)
            mark("histogram")
            digits = common.extract_digit(bits_p, shift, width)
            src = _pass_inverse_perm(digits.view(R, Tr, tile),
                                     counts.view(R, Tr, 1 << width),
                                     1 << width, idx_dt, mark)
            bits_p = common.take(bits_p, src)
            arrays_p = [common.take(a, src) for a in arrays_p]
            mark("gathers")
        out = [a.view(R, npad, *a.shape[1:])[:, :n].contiguous()
               for a in arrays_p]
    if not batched:
        out = [a[0] for a in out]
    return out
