"""Stable sort engines built on the library sort (PyTorch port of
``tinyhipradixsort_tpu/ops/argsort_engine.py``).

Two engines, on ``torch.sort(..., stable=True)`` where the JAX package uses
XLA's sort (not a Pallas kernel):

* ``argsort``: one stable argsort of the bit window, then one gather of
  every carried array. The semantic ground truth: any digit decomposition
  must match it exactly.
* ``lsd_argsort``: an LSD pass loop, one stable argsort per 8-bit digit,
  mirroring the reference's per-digit passes
  (reference: tinyhipradixsort.hpp:867-933).

``bits`` is ``(n,)`` or, for batched rows, ``(B, n)`` (each row sorts on its
own); the arrays share those leading axes.
"""

from __future__ import annotations

import torch

from . import common


def _unsigned_order(window: torch.Tensor, start_bit: int,
                    end_bit: int) -> torch.Tensor:
    """A tensor whose signed order is the window's unsigned order.

    A full-width window is the raw signed pattern, so its sign bit is
    flipped; a narrower window is a non-negative value already.
    """
    nbits = window.dtype.itemsize * 8
    if end_bit - start_bit < nbits:
        return window
    return window ^ -(1 << (nbits - 1))


def _argsort(key: torch.Tensor) -> torch.Tensor:
    return torch.sort(key, dim=-1, stable=True).indices


def sort_arrays_argsort(bits, arrays, start_bit, end_bit):
    window = common.window_values(bits, start_bit, end_bit)
    src = _argsort(_unsigned_order(window, start_bit, end_bit))
    return [common.take(a, src) for a in arrays]


def sort_arrays_lsd_argsort(bits, arrays, start_bit, end_bit,
                            radix_bits=common.RADIX_BITS):
    # digits of radix_bits <= 31 bits are non-negative int32: signed order
    # is their unsigned order
    for shift, width in common.digit_plan(start_bit, end_bit, radix_bits):
        src = _argsort(common.extract_digit(bits, shift, width))
        bits = common.take(bits, src)
        arrays = [common.take(a, src) for a in arrays]
    return arrays
