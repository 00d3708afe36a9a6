"""Utilities (PyTorch port of ``tinyhipradixsort_tpu/utils``): the
deterministic numpy PRNG of the tests and benchmarks (:mod:`.prng`), the
native host oracle (:mod:`.native_oracle`), and timing helpers."""

from .profiling import Stopwatch, time_fn, trace

__all__ = ["Stopwatch", "time_fn", "trace"]
