"""Plain reference of a stable radix-semantics sort: plain PyTorch, and
nothing of the program under test.

A key orders by its bits as the reference's radix sort reads them:
unsigned integers as they are, signed integers with the sign bit flipped,
floats with every bit flipped when the sign is set and the sign bit
flipped otherwise (so ``-NaN < -inf < -0.0 < +0.0 < +inf < NaN``). The
sort reads bits ``[start_bit, end_bit)`` of that, ascending or (inverted)
descending, and keeps equal keys in their input order. 2-D keys sort each
row. The expected outputs are the keys, and each value, taken at that
stable permutation (``torch.sort(stable=True)`` on int64 sort keys).
"""

from __future__ import annotations

import torch

_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def order_bits(keys: torch.Tensor) -> torch.Tensor:
    """Each key's ordered bits as int64: in ``[0, 2**w)`` for keys of
    ``w <= 32`` bits; for 64-bit keys the 64 ordered bits as int64."""
    w = 8 * keys.dtype.itemsize
    bits = keys.view(_SIGNED[keys.dtype.itemsize]).to(torch.int64)
    top = 1 << (w - 1) if w < 64 else -(1 << 63)
    if keys.dtype.is_floating_point:
        bits = torch.where(bits < 0, ~bits, bits ^ top)
    elif keys.dtype.is_signed:
        bits = bits ^ top
    return bits & ((1 << w) - 1) if w < 64 else bits


def sort_keys_int64(keys: torch.Tensor, start_bit: int, end_bit: int,
                    descending: bool) -> torch.Tensor:
    """int64 keys whose ascending signed order is the sort's order."""
    u = order_bits(keys)
    width = end_bit - start_bit
    if width == 64:  # all 64 bits: unsigned order is the flipped sign's
        field = u ^ -(1 << 63)
        return ~field if descending else field
    mask = (1 << width) - 1
    field = (u >> start_bit) & mask  # the mask drops an arithmetic shift's sign
    return mask - field if descending else field


def expected(keys: torch.Tensor, values, config: dict) -> list:
    """``[sorted keys]`` or ``[sorted keys, values in that order]``."""
    end_bit = config["end_bit"]
    if end_bit is None:
        end_bit = 8 * keys.dtype.itemsize
    sk = sort_keys_int64(keys, config["start_bit"], end_bit,
                         config["order"] == "descending")
    perm = torch.sort(sk, dim=-1, stable=True).indices
    del sk
    out = [_take(keys, perm)]
    if values is not None:
        out.append(_take(values, perm))
    return out


def _take(t: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``t`` at ``perm`` along the key axis, bit for bit (through the
    signed view, which every device gathers)."""
    s = t.view(_SIGNED[t.dtype.itemsize])
    if perm.dim() == 1:
        return s[perm].view(t.dtype)
    idx = perm.view(*perm.shape, *([1] * (s.dim() - perm.dim())))
    return torch.take_along_dim(s, idx, dim=1).view(t.dtype)
