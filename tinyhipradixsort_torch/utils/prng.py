"""Deterministic PRNG + workload generators for tests and benchmarks.

Mirrors the reference test harness's seeding strategy: a splitmix64 stream
(reference: unittest.cpp:24-35, main.cpp:29-40) and float generation that masks
exponent bits so random floats exclude Inf/NaN (reference: unittest.cpp:101-115).
Pure numpy — used host-side to build inputs for both device code and oracles.
"""

from __future__ import annotations

import numpy as np


def splitmix64(seed: int, n: int) -> np.ndarray:
    """n uint64 values from the splitmix64 stream starting at ``seed``."""
    x = (np.uint64(seed) + np.uint64(0x9E3779B97F4A7C15) * np.arange(1, n + 1, dtype=np.uint64))
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def random_keys(dtype, n: int, seed: int = 0) -> np.ndarray:
    """Random keys of a supported dtype; floats have exponents masked so the
    stream contains no Inf/NaN (matching the reference's generators)."""
    dtype = np.dtype(dtype)
    raw = splitmix64(seed, n)
    if dtype == np.uint32:
        return raw.astype(np.uint32)
    if dtype == np.int32:
        return raw.astype(np.uint32).view(np.int32)
    if dtype == np.uint64:
        return raw
    if dtype == np.int64:
        return raw.view(np.int64)
    if dtype == np.float32:
        u = raw.astype(np.uint32) & np.uint32(0xFF7FFFFF)  # clear one exponent bit
        return u.view(np.float32)
    if dtype == np.float64:
        u = raw & np.uint64(0xFFEFFFFFFFFFFFFF)
        return u.view(np.float64)
    raise TypeError(f"unsupported key dtype: {dtype}")


def zipf_keys(n: int, s: float = 1.1, universe: int = 2**32, seed: int = 0) -> np.ndarray:
    """Skewed (zipf-like) u32 keys for distributed-skew benchmarks."""
    rng = np.random.default_rng(seed)
    z = rng.zipf(s, size=n).astype(np.uint64)
    return ((z * np.uint64(0x9E3779B97F4A7C15)) % np.uint64(universe)).astype(np.uint32)
