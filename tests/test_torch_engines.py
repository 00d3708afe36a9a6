"""The port's portable engines against the JAX package with the same method:
``sort_keys``, ``sort_pairs`` and ``sort_indices`` with
``method="counting" | "argsort" | "lsd_argsort"``, over every key dtype of
``supported_key_dtypes()`` (16-bit included), both orders and sizes around
the counting engine's 2048-element tile, bit-exact on unsigned views.

One JAX ``sort_pairs`` call per input returns the keys, the payload and
the permutation together (the permutation rides as a second payload), so
each size costs one JAX compile. Bit windows, ``(n, 4)`` payloads, 2-D rows
and ``segment_ids=`` are in ``tests/test_torch_engines_api.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinyhipradixsort_torch as tthrs
import tinyhipradixsort_tpu as jthrs
from tests.torch_helpers import BF16, assert_bits_equal, rand_keys, to_torch

METHODS = ("counting", "argsort", "lsd_argsort")
DTYPES = (np.uint32, np.int32, np.float32, np.uint64, np.int64, np.float64,
          np.uint16, np.int16, np.float16, BF16)
SIZES = (0, 1, 2, 129, 2047, 2048, 2049, 4097)


def jax_outputs(x, vals, method, **kw):
    """(sorted keys, sorted payload, permutation) from the JAX package."""
    n = x.shape[-1]
    iota = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32), x.shape)
    jk, (jv, ji) = jthrs.sort_pairs(jnp.asarray(x), (jnp.asarray(vals), iota),
                                    method=method, **kw)
    return np.asarray(jk), np.asarray(jv), np.asarray(ji)


def check_port(x, vals, method, msg="", **kw):
    """The port's three entry points against the JAX package's outputs."""
    jk, jv, ji = jax_outputs(x, vals, method, **kw)
    xt = to_torch(x)
    kw_t = {k: to_torch(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}
    assert_bits_equal(tthrs.sort_keys(xt, method=method, **kw_t), jk, msg)
    k, v = tthrs.sort_pairs(xt, to_torch(vals), method=method, **kw_t)
    assert_bits_equal(k, jk, msg)
    assert_bits_equal(v, jv, msg)
    idx = tthrs.sort_indices(xt, method=method, **kw_t)
    assert idx.dtype == torch.int32, msg
    np.testing.assert_array_equal(idx.numpy(), ji, err_msg=msg)
    assert_bits_equal(xt, x, "inputs are never modified")


@pytest.mark.parametrize("order", ["ascending", "descending"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("method", METHODS)
def test_engine_parity(method, dtype, order):
    rng = np.random.default_rng(sum(map(ord, np.dtype(dtype).name + order)))
    for n in SIZES:
        x = rand_keys(rng, dtype, n)
        if n > 2:
            x[::5] = x[1]  # ties: stability decides
        vals = rng.integers(0, 2**32, size=n, dtype=np.uint32)
        check_port(x, vals, method, f"{method} {np.dtype(dtype).name} "
                   f"{order} n={n}", order=order)


def _leaves(rng, n, kinds):
    """Value leaves of the given kinds: a dtype, or ``(dtype, cols)``."""
    out = []
    for kind in kinds:
        dt, cols = kind if isinstance(kind, tuple) else (kind, None)
        shape = (n,) if cols is None else (n, cols)
        out.append(rng.integers(0, 2**16, size=shape).astype(dt))
    return out


@pytest.mark.parametrize("kinds", [
    # more arrays than the kernel carries: the keys and three leaves ride
    # as payloads, the last two leaves are gathered
    (np.uint32, np.float64, np.int16, np.uint8, np.float32),
    # rows the kernel does not take (12 bytes) beside ones it does
    ((np.float32, 3), np.uint32, (np.float32, 3), (np.uint32, 4)),
], ids=["six-arrays", "12-byte-rows"])
@pytest.mark.parametrize("n", [2049, 5000])
def test_counting_engine_carries_and_gathers_like_the_jax_engine(kinds, n):
    from tinyhipradixsort_torch.ops import counting_engine as tce

    rng = np.random.default_rng([n, len(kinds)])
    x = rand_keys(rng, np.uint32, n)
    x[::3] = x[1]  # ties: stability decides
    vals = _leaves(rng, n, kinds)
    jk, jv = jthrs.sort_pairs(jnp.asarray(x),
                              tuple(jnp.asarray(v) for v in vals),
                              method="counting")
    before = tce.GATHERED
    k, v = tthrs.sort_pairs(to_torch(x), tuple(to_torch(a) for a in vals),
                            method="counting")
    assert tce.GATHERED == before  # CPU tensors: nothing counted
    assert_bits_equal(k, jk)
    assert len(v) == len(vals)
    for got, want in zip(v, jv):
        assert_bits_equal(got, np.asarray(want))
