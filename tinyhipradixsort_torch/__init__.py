"""tinyhipradixsort_torch — the sort engine of ``tinyhipradixsort_tpu``
ported to PyTorch, with its kernels written by hand in CUDA for NVIDIA
Hopper (H100, ``sm_90a``): the bitonic sweep and the digit histogram.

Stable radix-semantics sort of 16/32/64-bit integer and float keys over any
bit window, ascending or descending, keys-only, key-value (payload tensors
or dicts/lists of them) and argsort outputs, on the bitonic engine or the
portable engines (counting, argsort, LSD argsort), which also take batched
2-D keys and ``segment_ids=``; and the distributed sample sort
(``psort_keys``, ``psort_pairs``, ``psort_indices``) over
``torch.distributed``, with its dry run (``parallel.dryrun``); ``utils``
holds the timing helpers, the test PRNG and the native host oracle. The
package imports ``torch`` and numpy only; each CUDA
kernel is built from ``csrc/`` at its first use on a CUDA tensor, never at
import. CPU tensors run the kernels' plain PyTorch versions.
"""

from . import utils
from .config import Config, KeyType, SortOrder, ValueType, temporary_buffer_bytes
from .keybits import key_bits, key_bits_inverse, np_key_bits, np_key_bits_inverse
from .parallel import psort_indices, psort_keys, psort_pairs
from .sort import (RadixSort, segment_ids_from_offsets, sort_indices,
                   sort_keys, sort_pairs)

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
    "psort_indices",
    "psort_keys",
    "psort_pairs",
    "segment_ids_from_offsets",
    "sort_indices",
    "sort_keys",
    "sort_pairs",
    "temporary_buffer_bytes",
    "__version__",
]
