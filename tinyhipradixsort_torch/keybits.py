"""Order-preserving key-bit transforms (PyTorch port of
``tinyhipradixsort_tpu/keybits.py``).

Maps sort keys to integer bits whose *unsigned* ascending order equals the
desired key order (reference: kernel.cu:46-69, fpKey.hpp:15-38):

* unsigned keys: identity (XOR all-ones for descending);
* signed keys: XOR the sign bit;
* float keys: IEEE-754 total-order flip. ``-0.0`` is first normalized to
  ``+0.0``; NaNs order by their raw bit pattern (positive-sign NaN above
  ``+inf``, negative-sign NaN below ``-inf``).

Representation: torch on the CPU has no ``<``, shifts or ``minimum`` for
``torch.uint32``/``torch.uint64``, so the bits live in signed tensors that
hold the same bit pattern as the JAX package's unsigned bits: ``torch.int32``
for 16- and 32-bit keys (16-bit keys zero-extended, as the JAX package
carries them in a u32 word) and ``torch.int64`` for 64-bit keys. Every
transform works in the integer domain: keys enter and leave through
``.view`` of the same width, never through a value cast, so NaN payloads
and ``-0.0`` survive. ``>>`` on these dtypes is an arithmetic shift; where
the code relies on that (to broadcast a sign bit) it says so, and elsewhere
it masks after shifting.

``np_key_bits``/``np_key_bits_inverse`` are pure-numpy copies of the JAX
package's host mirrors: the tests' oracle.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "key_bits",
    "key_bits_inverse",
    "key_bits_inverse_raw",
    "raw_to_keys",
    "neg_zero_flag",
    "bit_width",
    "dtype_kind",
    "supported_key_dtypes",
    "np_key_bits",
    "np_key_bits_inverse",
]


def dtype_kind(dtype: torch.dtype) -> str:
    """numpy-style kind of a torch dtype: ``'f'``, ``'i'`` or ``'u'``."""
    if dtype.is_floating_point:
        return "f"
    return "i" if dtype.is_signed else "u"


def supported_key_dtypes() -> tuple[torch.dtype, ...]:
    return (
        torch.uint32,
        torch.uint64,
        torch.int32,
        torch.int64,
        torch.float32,
        torch.float64,
        # 16-bit extension; bits ride in a 32-bit word
        torch.uint16,
        torch.int16,
        torch.float16,
        torch.bfloat16,
    )


def bit_width(dtype: torch.dtype) -> int:
    """Number of key bits for a supported key dtype (16, 32 or 64)."""
    if dtype not in supported_key_dtypes():
        raise TypeError(f"unsupported key dtype: {dtype}")
    return dtype.itemsize * 8


def _consts(nbits: int) -> tuple[int, int]:
    """(all-ones, sign bit) of the key width, as values of the bits dtype."""
    if nbits == 16:
        return 0xFFFF, 0x8000
    return -1, -(1 << (nbits - 1))


def _flip_mask(neg_source, nbits: int, sign: int):
    """Per element: all-ones where the sign bit of ``neg_source`` is set,
    else the sign bit alone (the float total-order flip mask)."""
    if nbits == 16:
        neg = (neg_source >> 15) & 1  # bits are zero-extended: mask is exact
        return ((-neg) & 0xFFFF) | 0x8000
    # arithmetic shift on purpose: broadcasts the sign bit to all-ones or 0
    return (neg_source >> (nbits - 1)) | sign


def _as_bits(keys: torch.Tensor, nbits: int) -> torch.Tensor:
    """Raw key bit pattern in the bits dtype (view, or zero-extended 16-bit)."""
    if nbits == 16:
        return keys.view(torch.int16).to(torch.int32) & 0xFFFF
    return keys.view(torch.int64 if nbits == 64 else torch.int32)


def key_bits(keys: torch.Tensor, *, descending: bool = False) -> torch.Tensor:
    """Transform keys to order-preserving bits (see module docstring)."""
    nbits = bit_width(keys.dtype)
    ones, sign = _consts(nbits)
    kind = dtype_kind(keys.dtype)
    u = _as_bits(keys, nbits)
    if kind == "u":
        bits = u
    elif kind == "i":
        bits = u ^ sign
    else:
        # normalize -0.0 -> +0.0 in the integer domain: magnitude bits zero
        u = torch.where((u & (ones ^ sign)) == 0, torch.zeros_like(u), u)
        bits = u ^ _flip_mask(u, nbits, sign)
    if descending:
        bits = bits ^ ones
    return bits


def key_bits_inverse_raw(bits: torch.Tensor, dtype: torch.dtype, *,
                         descending: bool = False) -> torch.Tensor:
    """Invert :func:`key_bits` down to the key's raw bit pattern (int32 for
    <=32-bit keys, int64 for 64-bit). Pure integer ops, so a caller can patch
    bits (e.g. restore ``-0.0`` signs) before :func:`raw_to_keys`."""
    nbits = bit_width(dtype)
    ones, sign = _consts(nbits)
    kind = dtype_kind(dtype)
    if descending:
        bits = bits ^ ones
    if kind == "u":
        return bits
    if kind == "i":
        return bits ^ sign
    # sign bit clear in the transformed bits <=> the key was negative
    return bits ^ _flip_mask(bits ^ ones, nbits, sign)


def raw_to_keys(raw: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Reinterpret a raw bit pattern (from :func:`key_bits_inverse_raw`) as
    keys of ``dtype`` — a ``.view``, never a value cast."""
    if bit_width(dtype) == 16:
        # [0, 2**16) -> the int16 with the same 16-bit pattern (exact cast)
        raw = torch.where(raw >= 0x8000, raw - 0x10000, raw).to(torch.int16)
    return raw.view(dtype)


def key_bits_inverse(bits: torch.Tensor, dtype: torch.dtype, *,
                     descending: bool = False) -> torch.Tensor:
    """Invert :func:`key_bits`. Exact for integer dtypes; a float ``-0.0``
    comes back as ``+0.0`` (the forward transform normalizes zeros)."""
    return raw_to_keys(
        key_bits_inverse_raw(bits, dtype, descending=descending), dtype)


def neg_zero_flag(keys: torch.Tensor,
                  dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """1 (``True``) in ``dtype`` where the float key is bitwise ``-0.0``,
    else 0."""
    nbits = keys.dtype.itemsize * 8
    wdt = {16: torch.int16, 32: torch.int32, 64: torch.int64}[nbits]
    return (keys.view(wdt) == -(1 << (nbits - 1))).to(dtype)


# ---------------------------------------------------------------------------
# numpy mirrors (host oracle)
# ---------------------------------------------------------------------------


def _np_kind(dtype: np.dtype) -> str:
    # ml_dtypes' bfloat16 reports kind 'V'
    return "f" if dtype.name == "bfloat16" else dtype.kind


def _np_bit_width(dtype: np.dtype) -> int:
    if _np_kind(dtype) not in "uif" or dtype.itemsize not in (2, 4, 8):
        raise TypeError(f"unsupported key dtype: {dtype}")
    return dtype.itemsize * 8


def np_key_bits_inverse(bits: np.ndarray, dtype, *,
                        descending: bool = False) -> np.ndarray:
    """Invert :func:`np_key_bits`: recover keys from transformed bits
    (lossless except ``-0.0``, which the forward transform normalizes)."""
    dtype = np.dtype(dtype)
    nbits = _np_bit_width(dtype)
    udt = np.uint64 if nbits == 64 else np.uint32
    narrow = np.uint16 if nbits == 16 else udt
    ones = udt((1 << nbits) - 1)
    kind = _np_kind(dtype)
    bits = bits.astype(udt, copy=False)
    if descending:
        bits = bits ^ ones
    if kind == "u":
        return bits.astype(dtype, copy=False)
    if kind == "i":
        return (bits ^ udt(1 << (nbits - 1))).astype(narrow).view(dtype)
    sign_bit = udt(1 << (nbits - 1))
    was_negative = (bits & sign_bit) == 0
    u = np.where(was_negative, bits ^ ones, bits ^ sign_bit)
    return u.astype(narrow).view(dtype)


def np_key_bits(keys: np.ndarray, *, descending: bool = False) -> np.ndarray:
    """Pure-numpy key-bit transform (unsigned numpy bits; the CPU oracle)."""
    dtype = np.dtype(keys.dtype)
    nbits = _np_bit_width(dtype)
    udt = np.uint64 if nbits == 64 else np.uint32
    narrow = np.uint16 if nbits == 16 else udt
    ones = udt((1 << nbits) - 1)
    kind = _np_kind(dtype)
    if kind == "u":
        bits = keys.astype(udt)
    elif kind == "i":
        bits = keys.view(narrow).astype(udt) ^ udt(1 << (nbits - 1))
    else:
        u = keys.view(narrow).astype(udt)
        u = np.where(((u << udt(1)) & ones) == udt(0), udt(0), u)
        negative = (u >> udt(nbits - 1)) != 0
        bits = u ^ np.where(negative, ones, udt(1 << (nbits - 1)))
    if descending:
        bits = bits ^ ones
    return bits
