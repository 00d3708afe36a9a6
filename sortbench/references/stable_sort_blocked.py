"""Plain reference of a stable radix-semantics sort, in blocks: the same
answer as ``stable_sort.py`` in far less memory beside it, for inputs whose
unblocked sort does not fit on the card next to the answers it checks.
Plain PyTorch, and nothing of the program under test.

``stable_sort.expected`` builds an int64 sort key a key and sorts them all
at once: at 2**31 keys that is 17.2 GB a copy, and ``torch.sort`` holds
several. Here each key gets a block id from the top bits of its sort key
(``stable_sort.sort_keys_int64``), computed a slice of the input at a time
into one byte a key, so that no full-length int64 array exists. The blocks
split the sort's order into consecutive ranges; walked in that order, each
block's keys (and values) are taken in input order, sorted stably by
``stable_sort.expected`` and written at the running offset. Every key of a
block orders after every key of the blocks before it, and the keys of a
block keep their input order among equals, so the result is the stable
sort, bit for bit. A key mix whose block is large still answers correctly,
with that block's memory.
"""

from __future__ import annotations

import torch

from sortbench.references import stable_sort

#: keys a block holds, at most, on keys spread evenly over the window
BLOCK_KEYS = 1 << 27
#: keys whose block ids are computed at once
SLICE_KEYS = 1 << 26
#: the most blocks (a block id is one byte)
MAX_BLOCK_BITS = 8


def block_bits(n: int, window_bits: int) -> int:
    """Top bits of the window that name a block: the fewest that give
    blocks of at most :data:`BLOCK_KEYS` evenly spread keys, within the
    window and :data:`MAX_BLOCK_BITS`."""
    bits = 0
    while n > BLOCK_KEYS << bits and bits < min(window_bits, MAX_BLOCK_BITS):
        bits += 1
    return bits


def block_ids(keys: torch.Tensor, start_bit: int, end_bit: int,
              descending: bool, bits: int) -> torch.Tensor:
    """uint8 ``(n,)``: each 1-D key's block, the top ``bits`` bits of its
    sort key, so that block ``b`` precedes block ``b + 1`` in the sort's
    order."""
    width = end_bit - start_bit
    ids = torch.empty(keys.shape[0], dtype=torch.uint8, device=keys.device)
    for lo in range(0, keys.shape[0], SLICE_KEYS):
        sk = stable_sort.sort_keys_int64(keys[lo:lo + SLICE_KEYS], start_bit,
                                         end_bit, descending)
        # the 64-bit window's sort keys are signed: lift them to unsigned
        top = sk >> (width - bits)
        if width == 64:
            top += 1 << (bits - 1)
        ids[lo:lo + SLICE_KEYS] = top.to(torch.uint8)
        del sk, top
    return ids


def _signed(t: torch.Tensor) -> torch.Tensor:
    return t.view(stable_sort._SIGNED[t.dtype.itemsize])


def expected(keys: torch.Tensor, values, config: dict) -> list:
    """``[sorted keys]`` or ``[sorted keys, values in that order]`` of
    1-D ``keys``, equal to ``stable_sort.expected``."""
    if keys.dim() != 1:
        raise ValueError(f"the blocked reference sorts 1-D keys, not "
                         f"{tuple(keys.shape)}")
    end_bit = config["end_bit"]
    if end_bit is None:
        end_bit = 8 * keys.dtype.itemsize
    bits = block_bits(keys.shape[0], end_bit - config["start_bit"])
    if bits == 0:
        return stable_sort.expected(keys, values, config)
    ids = block_ids(keys, config["start_bit"], end_bit,
                    config["order"] == "descending", bits)
    arrays = [keys] if values is None else [keys, values]
    out = [torch.empty_like(a) for a in arrays]
    at = 0
    for b in range(1 << bits):
        where = (ids == b).nonzero().squeeze(1)  # the block, in input order
        m = where.numel()
        if m == 0:
            continue
        part = [_signed(a)[where].view(a.dtype) for a in arrays]
        del where
        part = stable_sort.expected(part[0], part[1] if values is not None
                                    else None, config)
        for o, p in zip(out, part):
            _signed(o)[at:at + m] = _signed(p)
        del part
        at += m
    return out
