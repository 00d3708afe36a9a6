"""The port's MSB-partition front-end (``ops/partition_engine.py``) against
the JAX package's, bit for bit, on the cases of ``tests/test_partition.py``
with the same small tiles and rows (the JAX Pallas engine interpreted on
the CPU, the port's plain twin of the sweep kernel). Both branches of the
skew gate are checked at the engine's ``MARK`` hook, and at one size the
inverse permutation of the scatter step against the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinyhipradixsort_torch as tthrs
import tinyhipradixsort_tpu as jthrs
from tests.torch_helpers import assert_bits_equal
from tinyhipradixsort_torch.ops import bitonic_engine as tbe
from tinyhipradixsort_torch.ops import partition_engine as tpe
from tinyhipradixsort_tpu.ops import bitonic_engine as jbe
from tinyhipradixsort_tpu.ops import partition_engine as jpe

RNG = np.random.default_rng(0x9A88)
_KNOBS = dict(partition_bits=4, partition_min_n=0, partition_tile_bits=8,
              partition_row_bits=10)
JAX_TUNE = jbe.EngineTuning(**_KNOBS)
TUNE = tbe.EngineTuning(**_KNOBS)


def _torch_words(arrays):
    return [torch.from_numpy(a.astype(np.uint32).view(np.int32).copy())
            for a in arrays]


def _routes(monkeypatch):
    routes = []
    monkeypatch.setattr(tbe, "MARK", lambda event, name, words: routes.append(
        name) if event == "route" else None)
    return routes


def _check(cmp_np, carry_np, monkeypatch, route="partition"):
    """Both front-ends on the same words: bit-equal outputs, and the port's
    route at the gate."""
    jc, jk = jpe.sort_words_partition(
        [jnp.asarray(w) for w in cmp_np], [jnp.asarray(w) for w in carry_np],
        interpret=True, tuning=JAX_TUNE)
    routes = _routes(monkeypatch)
    tc, tk = tpe.sort_words_partition(_torch_words(cmp_np),
                                      _torch_words(carry_np), tuning=TUNE)
    assert route in routes, routes
    assert len(tc) == len(jc) and len(tk) == len(jk)
    for g, w in zip(tc + tk, list(jc) + list(jk)):
        assert_bits_equal(g, np.asarray(w))
    return [np.asarray(w) for w in jc]


@pytest.mark.parametrize("n", [700, 4096, 6000, 10000])
def test_partition_keys_only_uniform(n, monkeypatch):
    x = RNG.integers(0, 2**32, size=n, dtype=np.uint32)
    (got,) = _check([x], [], monkeypatch)
    np.testing.assert_array_equal(got, np.sort(x))


def test_partition_multiword_stable_pairs(monkeypatch):
    n = 5000
    hi = RNG.integers(0, 2**32, size=n, dtype=np.uint32)
    lo = RNG.integers(0, 4, size=n, dtype=np.uint32)
    idx = np.arange(n, dtype=np.uint32)
    payload = RNG.integers(0, 2**32, size=n, dtype=np.uint32)
    _check([hi, lo, idx], [payload], monkeypatch)


def test_partition_skew_falls_back(monkeypatch):
    n = 4096
    x = (RNG.integers(0, 2**20, size=n, dtype=np.uint32)
         | np.uint32(0x30000000))
    idx = np.arange(n, dtype=np.uint32)
    carry = RNG.integers(0, 2**32, size=n, dtype=np.uint32)
    _check([x, idx], [carry], monkeypatch, route="partition-fallback")


def test_partition_all_equal_keys(monkeypatch):
    n = 3000
    x = np.full(n, 0xDEADBEEF, np.uint32)
    idx = np.arange(n, dtype=np.uint32)
    _check([x, idx], [], monkeypatch, route="partition-fallback")


def test_partition_boundary_straddling_buckets(monkeypatch):
    sizes = [700, 900, 1100 - 76, 1000, 1024, 300]
    digits = np.concatenate([np.full(s, d, np.uint32)
                             for d, s in enumerate(sizes)])
    low = RNG.integers(0, 2**28, size=digits.shape[0], dtype=np.uint32)
    x = RNG.permutation((digits << np.uint32(28)) | low)
    _check([x], [], monkeypatch)


def test_sort_words_routes_to_partition(monkeypatch):
    n = 5000
    x = RNG.integers(0, 2**32, size=n, dtype=np.uint32)
    routes = _routes(monkeypatch)
    (got,), _ = tbe.sort_words(_torch_words([x]), [], tuning=TUNE)
    assert routes[:2] == ["rows", "partition"], routes
    (want,), _ = jbe.sort_words([jnp.asarray(x)], [], interpret=True,
                                tuning=JAX_TUNE)
    assert_bits_equal(got, np.asarray(want))
    # the default tuning keeps the front-end off
    assert tbe.EngineTuning().partition_bits == 0
    routes.clear()
    tbe.sort_words(_torch_words([x]), [], tuning=tbe.EngineTuning())
    assert routes and not any(r.startswith("partition") for r in routes)


def test_public_api_partition_env(monkeypatch):
    for knob, value in (("BITS", "4"), ("MIN_N", "0"), ("TILE_BITS", "8"),
                        ("ROW_BITS", "10")):
        monkeypatch.setenv(f"THRS_PARTITION_{knob}", value)
    routes = _routes(monkeypatch)
    x = RNG.integers(0, 2**32, size=4000, dtype=np.uint32)
    f = RNG.standard_normal(4000).astype(np.float32)
    for keys in (x, f):
        got = tthrs.sort_keys(torch.from_numpy(keys.copy()), method="bitonic")
        want = jthrs.sort_keys(jnp.asarray(keys), method="pallas")
        assert_bits_equal(got, np.asarray(want))
    # normal floats share a few top digits (sign and exponent): skewed
    assert [r for r in routes if r.startswith("partition")] == [
        "partition", "partition-fallback"], routes


def test_partition_inverse_permutation_matches_jax(monkeypatch):
    """The scatter step's gather of an index carry (the inverse permutation
    ``src`` read through the padded index word) is the JAX package's,
    captured where each front-end hands it to its bucket-row sort."""
    n = 6000
    x = RNG.integers(0, 2**32, size=n, dtype=np.uint32)
    iota = np.arange(n, dtype=np.uint32)
    jax_src = []
    real_rows = jbe.sort_words_rows

    def spy(cmp_words, carry_words, shape, **kw):
        if carry_words:
            jax.debug.callback(lambda c: jax_src.append(np.asarray(c)),
                               carry_words[0])
        return real_rows(cmp_words, carry_words, shape, **kw)

    monkeypatch.setattr(jbe, "sort_words_rows", spy)
    jpe.sort_words_partition([jnp.asarray(x)], [jnp.asarray(iota)],
                             interpret=True, tuning=JAX_TUNE)
    got = []
    monkeypatch.setattr(tbe, "MARK", lambda event, name, words: got.append(
        words[1].clone()) if (event, name) == ("begin", "bucket sorts")
        else None)
    tpe.sort_words_partition(_torch_words([x]), _torch_words([iota]),
                             tuning=TUNE)
    assert len(jax_src) == 1 and len(got) == 1
    assert got[0].shape[0] == 6144  # padded to a multiple of 2**11
    assert_bits_equal(got[0], jax_src[0])
    # a stable bucket partition: the real indices in order of their digit,
    # the pads (all-ones keys, top bucket) after them
    np.testing.assert_array_equal(
        got[0].numpy()[:n].view(np.uint32),
        np.argsort(x >> np.uint32(28), kind="stable").astype(np.uint32)[:n])
