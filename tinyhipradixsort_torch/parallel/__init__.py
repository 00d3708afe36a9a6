"""Distributed sort over ``torch.distributed`` (PyTorch port of
``tinyhipradixsort_tpu/parallel``), and its dry run."""

from .dryrun import dryrun_multichip
from .psort import psort_indices, psort_keys, psort_pairs

__all__ = ["dryrun_multichip", "psort_indices", "psort_keys", "psort_pairs"]
