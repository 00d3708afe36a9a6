"""Engine front-end: semantics-aware word packing for the bitonic network
(PyTorch port of ``tinyhipradixsort_tpu/ops/pallas_engine.py``).

This layer decides the minimal set of 32-bit words the network must move for
a request (the analogue of the reference's compile-time specialization per
key type, value type and order, tinyhipradixsort.hpp:751-804):

* integer keys, full window, keys-only: sort the transformed bits alone
  (no stability index — equal bits imply identical keys) and rebuild the
  keys by inverting the transform.
* float keys, full window: keys are rebuilt from the sorted bits too, and
  the stability index word is *tagged* — ``(index << 1) | is_neg_zero`` — so
  tie order is kept and the ``-0.0`` slots come back bit-exactly.
* pairs / indices / bit windows: window bits + stability index as compare
  words; payload leaves (and the keys, when the window hides key bits) ride
  as carry words. A narrow window and the index share one word when they fit.

Words are int32 tensors holding u32 patterns (see
:mod:`tinyhipradixsort_torch.ops.bitonic_engine`).
"""

from __future__ import annotations

import torch

from .. import keybits
from . import bitonic_engine
from .bitonic_engine import as_word, unsigned


def sort_arrays(bits, arrays, start_bit, end_bit, *, tuning=None):
    """Generic engine interface: stable sort of ``arrays`` by the window
    ``[start_bit, end_bit)`` of ``bits``."""
    return bitonic_engine.sort_arrays_bitonic(
        bits, arrays, start_bit, end_bit, tuning=tuning)


def sort_semantics(keys, values, *, descending, start_bit, end_bit, want,
                   zeros_exact=True, seg_bits=None, tuning=None, stable=True,
                   in_place=False):
    """Full-semantics sort of ``keys``; returns a tuple of the outputs named
    in ``want`` (a subset of ``("keys", "values", "indices")``, in that
    order). ``values`` is a flat list of tensor leaves whose leading axes
    are the keys' shape.

    2-D ``(B, n)`` keys are a batch: each row sorts on its own
    (:func:`bitonic_engine.sort_words_rows`), with a within-row index word.

    ``seg_bits`` (keys-shaped key bits of the segment ids): elements order
    by ``(segment, key)``; the segment words lead the compare tuple.

    ``zeros_exact=False`` (float keys-only fast path) sorts the transformed
    bits alone, and every ``-0.0`` key comes back as ``+0.0``.

    ``stable=False`` drops the stability index word where the engine adds
    no sentinel padding (a power-of-two row length; a flat ``n`` also
    ``>= 2**MIN_L``): tied keys then carry their payloads in some order.
    Elsewhere the sort stays stable.

    ``in_place=True`` hands the keys and value leaves over to the sort (the
    API's ``donate=``): words that are views of them (u32 key bits, 32-bit
    payloads) are swept where they lie when the route needs no padding, so
    the tensors' content afterwards is unspecified. ``seg_bits`` must not
    share memory with anything the caller keeps.
    """
    batched = keys.ndim == 2
    rows = keys.shape[0] if batched else 1
    n = keys.shape[-1]
    dev = keys.device
    if n <= 1:
        trivial = {"keys": keys.clone(), "values": list(values),
                   "indices": torch.zeros(keys.shape, dtype=torch.int32,
                                          device=dev)}
        return tuple(trivial[w] for w in want)
    dtype = keys.dtype
    width = dtype.itemsize * 8
    full = start_bit == 0 and end_bit == width
    bits = keybits.key_bits(keys, descending=descending)
    cmp_words = [w.reshape(-1) for w in
                 bitonic_engine.bits_to_cmp_words(bits, start_bit, end_bit)]
    nk = len(cmp_words)  # key-bit words (before the stability index word)
    nseg = 0
    if seg_bits is not None:
        seg_words = [w.reshape(-1) for w in bitonic_engine.bits_to_cmp_words(
            seg_bits, 0, seg_bits.dtype.itemsize * 8)]
        nseg = len(seg_words)
        cmp_words = seg_words + cmp_words

    def reshape_out(a):
        return a.reshape((rows, n) + a.shape[1:]) if batched else a

    kind = keybits.dtype_kind(dtype)
    tag_zero = (full and kind == "f" and zeros_exact
                and "keys" in want and n < (1 << 31))
    keys_from_bits = full and (kind in "iu" or tag_zero
                               or (kind == "f" and not zeros_exact))
    need_keys_carry = ("keys" in want) and not keys_from_bits
    need_vals = "values" in want
    # stable=False drops the index word (u32+u32 pairs: 3 words -> 2) only
    # where no sentinel pads the sort: an all-ones real tuple would tie
    # the pads and could be truncated in their place
    pad_free = (n & (n - 1)) == 0 and (batched
                                       or n >= (1 << bitonic_engine.MIN_L))
    stable_needed = ("indices" in want or tag_zero
                     or ((need_vals or need_keys_carry)
                         and (stable or not pad_free)))
    allow_ties = not stable_needed and (need_vals or need_keys_carry)
    pack_bits = 0
    if stable_needed:
        if n >= (1 << 32):
            raise ValueError("the bitonic engine supports n < 2**32")
        # within-row index: rows never interact, so tuples need only be
        # distinct within a row
        idx = bitonic_engine.iota_word(n, dev)
        if batched:
            idx = idx.repeat(rows)
        if tag_zero:
            # n < 2**31: the tagged index still fits 32 bits
            flag = keybits.neg_zero_flag(keys).reshape(-1).to(torch.int64)
            idx = as_word((unsigned(idx) << 1) | flag)
        cmp_words.append(idx)
        # Single-word packing: the window's bits and the index in ONE
        # compare word, (window << ib) | idx. With a power-of-two n the
        # largest index is all-ones in ib bits, so an exactly-32-bit
        # packing could tie the all-ones pad sentinel: require a spare
        # bit then.
        ww = end_bit - start_bit
        ib = bitonic_engine._ceil_log2(n) + (1 if tag_zero else 0)
        if (nseg == 0 and nk == 1 and ww < 32
                and ww + ib + (0 if n & (n - 1) else 1) <= 32):
            cmp_words = [as_word((unsigned(cmp_words[0]) << ib)
                                 | unsigned(cmp_words[1]))]
            pack_bits = ib

    leaves = ([keys] if need_keys_carry else []) + (
        list(values) if need_vals else [])
    carry_words, recipes = bitonic_engine.pack_carries(
        [_flat_leading(leaf, batched) for leaf in leaves])
    if batched:
        cmp_out, carry_out = bitonic_engine.sort_words_rows(
            cmp_words, carry_words, (rows, n), tuning=tuning,
            allow_tied_carries=allow_ties, in_place=in_place)
    else:
        cmp_out, carry_out = bitonic_engine.sort_words(
            cmp_words, carry_words, tuning=tuning,
            allow_tied_carries=allow_ties, in_place=in_place)
    # decoded carry leaves, in the order they were packed
    carried = [reshape_out(a) for a in
               bitonic_engine.unpack_carries(carry_out, recipes)]

    result = []
    if "keys" in want:
        if keys_from_bits:
            kw = cmp_out[nseg:nseg + nk]
            if pack_bits:
                kw = [(kw[0] >> pack_bits) & ((1 << (32 - pack_bits)) - 1)]
            sorted_bits = _join_cmp(kw, bits.dtype)
            raw = keybits.key_bits_inverse_raw(
                sorted_bits, dtype, descending=descending)
            if tag_zero:
                # restore -0.0 signs in the raw integer domain
                zero_bits = keybits.key_bits(
                    torch.zeros(1, dtype=dtype), descending=descending).item()
                was_neg = (cmp_out[-1] & 1) == 1
                sign = 0x8000 if width == 16 else -(1 << (width - 1))
                raw = torch.where((sorted_bits == zero_bits) & was_neg,
                                  raw | sign, raw)
            result.append(reshape_out(keybits.raw_to_keys(raw, dtype)))
        else:
            result.append(carried.pop(0))
    if "values" in want:
        result.append(carried)
    if "indices" in want:
        idx_word = cmp_out[-1]
        if pack_bits:
            idx_word = idx_word & ((1 << pack_bits) - 1)
        if tag_zero:
            idx_word = (idx_word >> 1) & 0x7FFFFFFF
        idx_dt = torch.int32 if n < (1 << 31) else torch.int64
        result.append(reshape_out(unsigned(idx_word).to(idx_dt)))
    return tuple(result)


def _flat_leading(a, batched):
    """Collapse the ``(B, n)`` leading axes of a batched leaf to one axis."""
    if not batched:
        return a
    return a.reshape((a.shape[0] * a.shape[1],) + tuple(a.shape[2:]))


def _join_cmp(cmp_words, bits_dtype):
    """Full-width transformed bits from the sorted compare words (hi/lo
    words of 64-bit bits, or the single word of 32-bit bits)."""
    if bits_dtype == torch.int32:
        return cmp_words[0]
    return bitonic_engine.join_u64(cmp_words[0], cmp_words[1])
