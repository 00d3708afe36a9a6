"""MSB-partition front-end for the bitonic engine (PyTorch port of
``tinyhipradixsort_tpu/ops/partition_engine.py``).

The reference's histogram -> scan -> scatter pass structure
(kernel.cu:73-103, 136-204, 206-429), applied once at the most significant
``partition_bits`` of the compare tuple: split the array into
``R = 2**partition_bits`` nearly equal buckets, then finish each bucket with
the row network, whose cost per element is ``f(f+1)/2`` substages for rows
of ``2**f`` instead of the full network's ``L(L+1)/2``. For 2**28 u32
pairs the JAX docstring counts about 1218 word-substages per element direct
and about 800 partitioned; the permutation passes come on top.

Steps (every one on the words of the request, padded with all-ones compare
words and zero carry words to a multiple of ``M = 2**max(f+1, g)``):

1. *Rank sort*: per tile of ``2**g`` elements, a row sort of the one packed
   word ``(digit << g) | index``, whatever the request's width. The digit is
   the top ``partition_bits`` of the first compare word, shifted logically
   (words are int32 bit patterns, and ``>>`` on int32 is arithmetic).
2. *Counts and scan*: per-tile digit boundaries from one batched
   ``torch.searchsorted`` of the sorted digits, and a bucket-major exclusive
   scan of the ``(T, R)`` counts (two ``cumsum``).
3. *Scatter*: the inverse permutation ``src`` by one ``index_copy_``, then
   one gather per word (:func:`.common.take`): every element lands at its
   final bucket-partitioned position, stably, with no capacity slack.
4. *Bucket sorts*: rows of ``F = 2**f`` by the whole compare tuple, odd rows
   on complemented compare words (so they sort descending).
5. *Two neighbour-merge rounds*: row pairs (0,1), (2,3), ..., then the
   shifted pairs (1,2), (3,4), ... with each window's second row reversed.

The partition is exact, so each bucket's elements already sit in their
final range; if no bucket holds more than ``F`` real elements, a range
spans at most two adjacent rows, and the two merge rounds finish it. The
gate checks that bound (the pads, all-equal maxima at the tail, are left
out of the top bucket's count); a skewed input (a zipf head, all-equal
keys) takes the fallback, the direct network, and the rank sort was wasted
work. The gate is one host sync (``.item()``), and only the branch taken
runs. Output and stability follow from the :func:`~.bitonic_engine.sort_words`
word contract, which this function keeps.

Off by default, as in the JAX package: ``EngineTuning(partition_bits=8)``
or ``THRS_PARTITION_BITS=8``. :data:`~.bitonic_engine.MARK` sees the route
("partition" or "partition-fallback", decided after steps 1-2) and the
steps as parts.
"""

from __future__ import annotations

import dataclasses

import torch

from . import bitonic_engine as be
from . import common


def _padded(w: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """``w`` padded with ``fill`` to ``size``; ``w`` itself at that size
    (the steps only read the padded words)."""
    if w.shape[0] == size:
        return w
    return common.pad_to_multiple(w, size, fill)


def sort_words_partition(cmp_words: list, carry_words: list, *,
                         tuning: be.EngineTuning | None = None):
    """Partition-then-sort with the :func:`~.bitonic_engine.sort_words`
    contract (stable by compare-tuple order; the same word contract).
    Returns ``(cmp_words, carry_words)``; the inputs are not modified."""
    tuning = be._tuning_or_env(tuning)
    inner = dataclasses.replace(tuning, partition_bits=0)
    n = cmp_words[0].shape[0]
    ncmp = len(cmp_words)
    rb = tuning.partition_bits
    if not 1 <= rb <= 16:
        raise ValueError(f"partition_bits must be in [1, 16], got {rb}")
    if n >= 1 << 31:
        raise ValueError("partition path supports n < 2**31")
    if n <= 1:
        return list(cmp_words), list(carry_words)
    L = be._ceil_log2(n)
    g = min(tuning.partition_tile_bits or 18, L, 32 - rb)
    f = min(max(tuning.partition_row_bits or (L - rb + 1), 10), L)
    F, G, R = 1 << f, 1 << g, 1 << rb
    M = 1 << max(f + 1, g)
    n_pad = -(-n // M) * M
    T, rows = n_pad // G, n_pad // F
    words = [_padded(w, n_pad, be._fill(i, ncmp))
             for i, w in enumerate(list(cmp_words) + list(carry_words))]
    dev = words[0].device

    # 1. per-tile stable rank sort of the one packed (digit, index) word
    with be._part("rank sort", words):
        digit = (words[0] >> (32 - rb)) & (R - 1)
        packed = ((digit.view(T, G) << g)
                  | torch.arange(G, dtype=torch.int32, device=dev))
        (sp,), _ = be.sort_words_rows([packed.view(-1)], [], (T, G),
                                      tuning=inner, in_place=True)
        sp = sp.view(T, G)
        spd = ((sp >> g) & (R - 1)).long()  # sorted digit per slot
        sidx = (sp & (G - 1)).long()  # its index in the tile
        del digit, packed, sp

    # 2. per-tile digit boundaries from the sorted digits; the skew gate
    # leaves the pads (n_pad - n all-ones tuples, top bucket) out
    with be._part("counts", words):
        bounds = torch.arange(R + 1, dtype=torch.int64, device=dev)
        cum = torch.searchsorted(spd, bounds.expand(T, R + 1).contiguous(),
                                 side="left")  # (T, R+1) local bases
        counts = cum[:, 1:] - cum[:, :-1]  # (T, R)
        total = counts.sum(dim=0)  # (R,)
        real_top = total[R - 1] - (n_pad - n)
        ok = bool(torch.maximum(total[:R - 1].max(), real_top) <= F)

    if not ok:
        be._mark_route("partition-fallback", words)
        with be._part("fallback", words):
            out_c, out_k = be.sort_words(list(cmp_words), list(carry_words),
                                         tuning=inner)
        return list(out_c), list(out_k)
    be._mark_route("partition", words)

    # 3. inverse permutation by one scatter, then one gather per word
    with be._part("scatter", words):
        # slot p of tile t holds digit d: it goes to the bucket's start,
        # plus the tile's exclusive count of d, plus p - cum[t, d]
        bucket_excl = torch.cumsum(total, 0) - total
        tile_base = bucket_excl[None, :] + (torch.cumsum(counts, 0) - counts)
        p = torch.arange(G, dtype=torch.int64, device=dev)
        dest = torch.gather(tile_base - cum[:, :-1], 1, spd) + p
        orig = (torch.arange(T, dtype=torch.int64, device=dev)[:, None] * G
                + sidx)
        src = torch.empty(n_pad, dtype=torch.int64, device=dev)
        src.index_copy_(0, dest.view(-1), orig.view(-1))
        del spd, sidx, cum, counts, tile_base, dest, orig
        ws = [common.take(w, src) for w in words]
        del words, src

    # 4. bucket-row sorts, odd rows on complemented compare words (the
    # gathered words are this function's own: complemented and swept in
    # place)
    with be._part("bucket sorts", ws):
        par = -(torch.arange(rows, dtype=torch.int32, device=dev) & 1)[:, None]
        for w in ws[:ncmp]:
            w.view(rows, F).bitwise_xor_(par)
        cs, ks = be.sort_words_rows(ws[:ncmp], ws[ncmp:], (rows, F),
                                    tuning=inner, in_place=True)
        ws = list(cs) + list(ks)
        for w in ws[:ncmp]:
            w.view(rows, F).bitwise_xor_(par)

    with be._part("merges", ws):
        # 5a. aligned row pairs: each [ascending | descending] is bitonic
        mc, mk = be.merge_words_rows(ws[:ncmp], ws[ncmp:], (rows // 2, 2 * F),
                                     tuning=inner)
        ws = list(mc) + list(mk)
        if rows > 2:
            # 5b. shifted pairs: reverse each window's second row, merge,
            # splice back between the first and the last row
            def rev_second(w):
                x = w[F:n_pad - F].view(-1, 2, F)
                return torch.cat([x[:, :1], torch.flip(x[:, 1:], (2,))],
                                 dim=1).view(-1)

            mid = [rev_second(w) for w in ws]
            mc, mk = be.merge_words_rows(mid[:ncmp], mid[ncmp:],
                                         ((rows - 2) // 2, 2 * F),
                                         tuning=inner)
            ws = [torch.cat([w[:F], m, w[n_pad - F:]])
                  for w, m in zip(ws, list(mc) + list(mk))]
    out = [w[:n] for w in ws]
    return out[:ncmp], out[ncmp:]
