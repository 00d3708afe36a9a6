"""Distributed sort over ``torch.distributed`` (PyTorch port of
``tinyhipradixsort_tpu/parallel``)."""

from .psort import psort_indices, psort_keys, psort_pairs

__all__ = ["psort_indices", "psort_keys", "psort_pairs"]
