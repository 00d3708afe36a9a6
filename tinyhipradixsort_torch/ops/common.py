"""Shared engine plumbing: digit plans, padding, window math (PyTorch port of
``tinyhipradixsort_tpu/ops/common.py``).

Engines sort by an integer *bits* tensor (from
:func:`tinyhipradixsort_torch.keybits.key_bits`: int32 for <=32-bit keys,
int64 for 64-bit keys, holding the unsigned pattern) over a bit window
``[start_bit, end_bit)``. The window may be any width (the reference requires
multiples of 8, tinyhipradixsort.hpp:856).
"""

from __future__ import annotations

import torch

RADIX_BITS = 8


def digit_plan(start_bit: int, end_bit: int, radix_bits: int = RADIX_BITS) -> list[tuple[int, int]]:
    """Return [(shift, bits), ...] LSD-first digit passes covering the window."""
    if not 0 <= start_bit < end_bit <= 64:
        raise ValueError(f"invalid bit window [{start_bit}, {end_bit})")
    plan = []
    shift = start_bit
    while shift < end_bit:
        width = min(radix_bits, end_bit - shift)
        plan.append((shift, width))
        shift += width
    return plan


def resolve_window(key_dtype: torch.dtype, start_bit, end_bit) -> tuple[int, int]:
    width = key_dtype.itemsize * 8
    if end_bit is None:
        end_bit = width
    start_bit = int(start_bit)
    end_bit = int(end_bit)
    if not 0 <= start_bit < end_bit <= width:
        raise ValueError(
            f"bit window [{start_bit}, {end_bit}) out of range for {width}-bit keys"
        )
    return start_bit, end_bit


def window_values(bits: torch.Tensor, start_bit: int, end_bit: int) -> torch.Tensor:
    """The window's bits as a value in ``[0, 2**(end_bit - start_bit))``.

    ``>>`` is arithmetic on int32/int64; the mask drops the copied sign bits
    (a window narrower than the dtype always has a mask below the sign bit).
    """
    nbits = bits.dtype.itemsize * 8
    if start_bit == 0 and end_bit == nbits:
        return bits
    return (bits >> start_bit) & ((1 << (end_bit - start_bit)) - 1)


def extract_digit(bits: torch.Tensor, shift: int, width: int) -> torch.Tensor:
    """The digit ``bits[shift : shift + width]`` as int32 in ``[0, 2**width)``.

    ``>>`` is arithmetic on the int32/int64 bits, so the mask comes after
    the shift and drops the copied sign bits.
    """
    mask = (1 << width) - 1 if width < bits.dtype.itemsize * 8 else -1
    return ((bits >> shift) & mask).to(torch.int32)


_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_UNSIGNED = (torch.uint16, torch.uint32, torch.uint64)


def take(a: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``a`` permuted along its element axis by ``src``: axis 0 for a 1-D
    ``src``, axis 1 of each row for a 2-D ``(B, n)`` ``src``. Bits are
    copied as they are; unsigned tensors (which torch cannot index on every
    device) and floats (``take_along_dim`` sets a 16-bit signalling NaN's
    quiet bit on the CPU) move through their signed view."""
    dtype = a.dtype
    if dtype in _UNSIGNED or dtype.is_floating_point:
        a = a.view(_SIGNED[dtype.itemsize])
    if src.ndim == 1:
        out = a.index_select(0, src)
    else:
        idx = src.long().reshape(src.shape + (1,) * (a.ndim - 2))
        out = torch.take_along_dim(a, idx, dim=1)
    return out.view(dtype)


def pad_to_multiple(x: torch.Tensor, multiple: int, fill: int) -> torch.Tensor:
    """Copy 1-D ``x`` into a fresh contiguous buffer whose length is a
    multiple of ``multiple``, filling the tail with ``fill``.

    Unlike the JAX function, the result never aliases ``x``, even when no
    padding is needed: the sort network runs in place on it.
    """
    n = x.shape[0]
    npad = -(-max(n, 1) // multiple) * multiple
    out = torch.empty(npad, dtype=x.dtype, device=x.device)
    out[:n] = x
    out[n:] = fill
    return out


def on_cuda(x: torch.Tensor) -> bool:
    """True when work on ``x`` goes to the CUDA kernels (the port's analogue
    of the JAX package's ``interpret_default``: the device is taken from the
    input tensor)."""
    return x.is_cuda
