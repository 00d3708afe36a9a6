"""tinyhipradixsort_torch — the sort engine of ``tinyhipradixsort_tpu``
ported to PyTorch, with its bitonic sweep kernel written by hand in CUDA for
NVIDIA Hopper (H100, ``sm_90a``).

Stable radix-semantics sort of 32/64-bit integer and float keys over any bit
window, ascending or descending, keys-only, key-value (payload tensors or
dicts/lists of them) and argsort outputs. The package imports ``torch``
only; the CUDA kernel is built from ``csrc/`` at the first sort of a CUDA
tensor, never at import. CPU tensors run the kernel's plain PyTorch version.
"""

from .config import Config, KeyType, SortOrder, ValueType, temporary_buffer_bytes
from .keybits import key_bits, key_bits_inverse, np_key_bits, np_key_bits_inverse
from .sort import RadixSort, sort_indices, sort_keys, sort_pairs

__version__ = "0.1.0"

__all__ = [
    "Config",
    "KeyType",
    "RadixSort",
    "SortOrder",
    "ValueType",
    "key_bits",
    "key_bits_inverse",
    "np_key_bits",
    "np_key_bits_inverse",
    "sort_indices",
    "sort_keys",
    "sort_pairs",
    "temporary_buffer_bytes",
    "__version__",
]
