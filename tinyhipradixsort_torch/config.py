"""Sort configuration types (PyTorch port of ``tinyhipradixsort_tpu/config.py``).

Analogue of the reference's ``thrs::RadixSort::Config`` type system
(reference: tinyhipradixsort.hpp:638-749). The functional API
(:func:`tinyhipradixsort_torch.sort_keys` etc.) infers everything from tensor
dtypes; ``Config``/``RadixSort`` exist for explicit configuration and
reference-API parity. Key types are torch dtypes.
"""

from __future__ import annotations

import dataclasses
import enum

import torch

__all__ = ["KeyType", "ValueType", "SortOrder", "Config", "temporary_buffer_bytes"]


class KeyType(enum.Enum):
    """Key dtypes (reference: hpp:638-644; I32/I64 and the 16-bit entries
    are extensions)."""

    U32 = torch.uint32
    U64 = torch.uint64
    F32 = torch.float32
    F64 = torch.float64
    I32 = torch.int32
    I64 = torch.int64
    U16 = torch.uint16
    I16 = torch.int16
    F16 = torch.float16
    BF16 = torch.bfloat16

    @classmethod
    def from_dtype(cls, dtype: torch.dtype) -> "KeyType":
        for kt in cls:
            if kt.value == dtype:
                return kt
        raise TypeError(f"unsupported key dtype: {dtype}")

    @property
    def dtype(self) -> torch.dtype:
        return self.value

    @property
    def bits(self) -> int:
        return self.value.itemsize * 8


class ValueType(enum.Enum):
    """Payload width classes (reference: hpp:645-650).

    Any tensor whose leading axis matches the keys can ride along as the
    payload; these members only classify byte width for reference parity and
    scratch estimates. U128 is a ``(n, 4)`` 32-bit tensor (the reference
    lowers u128 to ``uint4``, hpp:779).
    """

    U32 = 4
    U64 = 8
    U128 = 16

    @property
    def bytes(self) -> int:
        return self.value


class SortOrder(enum.Enum):
    """Ascending/descending (reference: hpp:679-683)."""

    ASCENDING = "ascending"
    DESCENDING = "descending"

    @classmethod
    def parse(cls, order) -> "SortOrder":
        if isinstance(order, SortOrder):
            return order
        if isinstance(order, str):
            low = order.lower()
            for member in cls:
                if member.value == low:
                    return member
        raise ValueError(f"unknown sort order: {order!r} (use 'ascending' or 'descending')")

    @property
    def descending(self) -> bool:
        return self is SortOrder.DESCENDING


@dataclasses.dataclass(frozen=True)
class Config:
    """Sort configuration (reference: hpp:697-749 ``RadixSort::Config``).

    ``key_is_16byte_aligned`` was a vectorized-load hint in the reference
    (hpp:700); it is accepted for parity and has no effect here.
    """

    key_type: KeyType = KeyType.U32
    value_type: ValueType | None = None
    order: SortOrder = SortOrder.ASCENDING
    key_is_16byte_aligned: bool = True

    @classmethod
    def for_keys(cls, key_dtype, order=SortOrder.ASCENDING) -> "Config":
        """Analogue of ``configureWithKey<K>()`` (hpp:707-725)."""
        return cls(key_type=KeyType.from_dtype(key_dtype), order=SortOrder.parse(order))

    @classmethod
    def for_key_pairs(cls, key_dtype, value_bytes: int, order=SortOrder.ASCENDING) -> "Config":
        """Analogue of ``configureWithKeyPair<K, V>()`` (hpp:727-748)."""
        return cls(
            key_type=KeyType.from_dtype(key_dtype),
            value_type=ValueType(value_bytes),
            order=SortOrder.parse(order),
        )


# Tile of the reference-parity scratch estimate below: elements per
# histogram tile of one digit pass (the reference's RADIX_SORT_BLOCK_SIZE
# analogue, hpp:19).
DEFAULT_TILE = 32768
RADIX_BITS = 8
NUM_BUCKETS = 1 << RADIX_BITS


def temporary_buffer_bytes(n: int, config: Config | None = None, tile: int = DEFAULT_TILE) -> int:
    """Scratch estimate for an ``n``-element sort (parity with
    ``getTemporaryBufferBytes``, reference: hpp:806-843): the ping-pong key
    (and value) buffer plus the ``[256, num_tiles]`` count matrix of one
    digit pass. Nothing needs to be pre-allocated by the caller."""
    config = config or Config()
    num_tiles = -(-max(n, 1) // tile)
    psum = 4 * NUM_BUCKETS * num_tiles
    key_out = config.key_type.dtype.itemsize * n
    value_out = (config.value_type.bytes if config.value_type else 0) * n

    def align16(x: int) -> int:
        return (x + 15) // 16 * 16

    return align16(psum) + align16(key_out) + align16(value_out)
