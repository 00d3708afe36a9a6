"""The port's utils against the JAX package's: the numpy PRNG, the native
host oracle (the cases of ``tests/test_native_oracle.py``, on whichever of
the native library and the numpy fallback runs, and on the fallback
forced), and the timing helpers on CPU tensors (``tests/test_utils.py``),
with ``trace`` over ``torch.profiler``."""

import numpy as np
import pytest
import torch

from tinyhipradixsort_torch import keybits as tkeybits
from tinyhipradixsort_torch.utils import native_oracle as tno
from tinyhipradixsort_torch.utils import prng as tprng
from tinyhipradixsort_torch.utils import Stopwatch, time_fn, trace
from tinyhipradixsort_tpu import keybits as jkeybits
from tinyhipradixsort_tpu.utils import native_oracle as jno
from tinyhipradixsort_tpu.utils import prng as jprng

RNG = np.random.default_rng(0xC0DF)


@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.uint64, np.int64,
                                   np.float32, np.float64])
def test_prng_matches_jax(dtype):
    for seed in (0, 7, 2**40 + 3):
        got = tprng.random_keys(dtype, 10007, seed=seed)
        want = jprng.random_keys(dtype, 10007, seed=seed)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
        if np.dtype(dtype).kind == "f":
            assert np.isfinite(got).all()
    np.testing.assert_array_equal(tprng.splitmix64(3, 1000),
                                  jprng.splitmix64(3, 1000))
    np.testing.assert_array_equal(tprng.zipf_keys(5000, s=1.3, seed=2),
                                  jprng.zipf_keys(5000, s=1.3, seed=2))
    with pytest.raises(TypeError):
        tprng.random_keys(np.int8, 4)


def _specials(dt, n):
    if dt.kind == "f":
        x = RNG.standard_normal(n).astype(dt)
        x[::7] = -0.0
        x[::11] = 0.0
        x[::13] = np.inf
        x[::17] = -np.inf
        x[::19] = np.nan
        x[5::19] = -np.nan
        x[::23] = np.finfo(dt).tiny / 2  # denormal
        return x
    info = np.iinfo(dt)
    return RNG.integers(info.min, info.max, size=n, dtype=dt, endpoint=True)


@pytest.fixture(params=["as built", "numpy fallback"])
def oracle(request, monkeypatch):
    """The port's oracle as it runs here, and with the native library
    forced off (its numpy fallback)."""
    if request.param == "numpy fallback":
        monkeypatch.setattr(tno, "_tried", True)
        monkeypatch.setattr(tno, "_lib", None)
        assert not tno.available()
    return tno


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32,
                                   np.int64, np.uint32])
def test_native_key_bits_matches_jax(oracle, dtype):
    x = _specials(np.dtype(dtype), 100000)
    got = oracle.native_key_bits(x)
    np.testing.assert_array_equal(got, jno.native_key_bits(x))
    np.testing.assert_array_equal(got, tkeybits.np_key_bits(x))
    np.testing.assert_array_equal(got, jkeybits.np_key_bits(x))


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_native_sort_bits_matches_jax(oracle, dtype):
    x = RNG.integers(0, np.iinfo(dtype).max, size=300000, dtype=dtype,
                     endpoint=True)
    got = oracle.native_sort_bits(x)
    np.testing.assert_array_equal(got, jno.native_sort_bits(x))
    np.testing.assert_array_equal(got, np.sort(x))
    with pytest.raises(TypeError):
        oracle.native_sort_bits(x.astype(np.int32))


def test_native_sort_stable_perm_matches_jax(oracle):
    x = RNG.integers(0, 64, size=200000).astype(np.uint32)
    srt, perm = oracle.native_sort_bits(x, with_perm=True)
    jsrt, jperm = jno.native_sort_bits(x, with_perm=True)
    assert perm.dtype == jperm.dtype == np.uint64
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(srt, jsrt)
    np.testing.assert_array_equal(perm.astype(np.int64),
                                  np.argsort(x, kind="stable"))


def test_oracle_sort_floats_matches_jax(oracle):
    x = RNG.standard_normal(50000).astype(np.float32)
    x[::5] = -0.0
    sk, perm = oracle.oracle_sort(x)
    jsk, jperm = jno.oracle_sort(x)
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(sk.view(np.uint32), jsk.view(np.uint32))
    want = np.argsort(tkeybits.np_key_bits(x), kind="stable")
    np.testing.assert_array_equal(perm, want)


def test_oracle_sort_descending_matches_jax(oracle):
    x = RNG.integers(0, 2**32, size=65537, dtype=np.uint32)
    sk, perm = oracle.oracle_sort(x, descending=True)
    jsk, jperm = jno.oracle_sort(x, descending=True)
    np.testing.assert_array_equal(sk, jsk)
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(sk, np.sort(x)[::-1])


def test_native_library_builds_into_the_ports_build_dir():
    if tno.available():
        so = tno._build()
        assert so.parent.name == "_build"
        assert so.parent.parent.name == "tinyhipradixsort_torch"
        assert so.name.startswith("libthrs_host-") and so.is_file()
    else:
        assert tno.get_lib() is None


def test_stopwatch():
    sw = Stopwatch().start()
    x = torch.arange(1000)
    _ = x * 2
    s = sw.stop(x)
    assert s > 0 and sw.ms == s * 1e3


def test_time_fn_subtracts_floor():
    x = torch.arange(4096, dtype=torch.int32)
    t, floor = time_fn(lambda a: a + 1, x, reps=2)
    assert t >= 0 and floor > 0
    t, floor = time_fn(lambda a: a * 3, x, reps=2, subtract_floor=False)
    assert t > 0 and floor == 0.0


def test_trace_profiles_the_block(tmp_path):
    x = torch.arange(1 << 16, dtype=torch.int64)
    with trace(str(tmp_path)) as prof:
        torch.sort(x.flip(0))
    names = [e.key for e in prof.key_averages()]
    assert any("sort" in name for name in names), names
    assert (tmp_path / "trace.json").is_file()
