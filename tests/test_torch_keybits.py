"""Parity of the PyTorch port's key-bit transforms with the JAX package.

Same numpy inputs through ``tinyhipradixsort_tpu.keybits`` and
``tinyhipradixsort_torch.keybits``; every comparison is bit-exact on unsigned
views (tolerance: none). Float inputs are random bit patterns plus explicit
specials, so NaN payloads of both signs, +-0, +-inf and denormals all occur.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyhipradixsort_torch import keybits as tkb
from tinyhipradixsort_tpu import keybits as jkb
from tests.torch_helpers import BF16, TORCH_DTYPE, assert_bits_equal, to_torch

DTYPES = [np.dtype(d) for d in (np.uint32, np.int32, np.float32, np.uint64,
                                np.int64, np.float64, np.uint16, np.int16,
                                np.float16)] + [BF16]
_UINT = {2: np.uint16, 4: np.uint32, 8: np.uint64}


def _keys(dtype: np.dtype, n: int = 4096) -> np.ndarray:
    """Random bit patterns of the dtype, plus specials for floats."""
    rng = np.random.default_rng(dtype.itemsize * 7919 + len(dtype.name))
    u = _UINT[dtype.itemsize]
    bits = rng.integers(0, np.iinfo(u).max, size=n, dtype=u, endpoint=True)
    x = bits.view(dtype)
    if dtype.kind == "f" or dtype == BF16:
        nbits = dtype.itemsize * 8
        sign = u(1 << (nbits - 1))
        mant = 7 if dtype == BF16 else {16: 10, 32: 23, 64: 52}[nbits]
        inf = u(((1 << (nbits - 1 - mant)) - 1) << mant)
        specials = np.array(
            [0, sign, inf, inf | sign, inf | u(1), inf | u(1) | sign,
             inf | u((1 << mant) - 1), u(1), u(1) | sign,
             u((1 << mant) - 1), u((1 << mant) - 1) | sign], dtype=u)
        bits[: specials.size] = specials
        x = bits.view(dtype)
    return x


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.name)
def test_key_bits_parity(dtype, descending):
    x = _keys(dtype)
    got = tkb.key_bits(to_torch(x), descending=descending)
    want = np.asarray(jkb.key_bits(jnp.asarray(x), descending=descending))
    assert got.dtype == (torch.int64 if dtype.itemsize == 8 else torch.int32)
    assert_bits_equal(got, want)
    # the numpy mirrors agree with the JAX package's too
    assert_bits_equal(tkb.np_key_bits(x, descending=descending),
                      jkb.np_key_bits(x, descending=descending))


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.name)
def test_inverse_parity(dtype, descending):
    bits = np.asarray(jkb.key_bits(jnp.asarray(_keys(dtype)),
                                   descending=descending))
    tbits = to_torch(bits).view(
        torch.int64 if bits.dtype.itemsize == 8 else torch.int32)
    tdt = TORCH_DTYPE[dtype]
    raw = tkb.key_bits_inverse_raw(tbits, tdt, descending=descending)
    jraw = jkb.key_bits_inverse_raw(jnp.asarray(bits), dtype,
                                    descending=descending)
    assert_bits_equal(raw, np.asarray(jraw))
    keys = tkb.raw_to_keys(raw, tdt)
    assert keys.dtype == tdt
    assert_bits_equal(keys, np.asarray(jkb.raw_to_keys(jraw, dtype)))
    assert_bits_equal(tkb.key_bits_inverse(tbits, tdt, descending=descending),
                      keys)
    assert_bits_equal(
        tkb.np_key_bits_inverse(bits, dtype, descending=descending),
        jkb.np_key_bits_inverse(bits, dtype, descending=descending))


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.name)
def test_round_trip_keeps_everything_but_negative_zero(dtype):
    x = _keys(dtype)
    tdt = TORCH_DTYPE[dtype]
    back = tkb.key_bits_inverse(tkb.key_bits(to_torch(x)), tdt)
    want = x.copy()
    if dtype.kind == "f" or dtype == BF16:
        u = want.view(_UINT[dtype.itemsize])
        u[u == _UINT[dtype.itemsize](1 << (dtype.itemsize * 8 - 1))] = 0
    assert_bits_equal(back, want)


@pytest.mark.parametrize("dtype", [d for d in DTYPES
                                   if d.kind == "f" or d == BF16],
                         ids=lambda d: d.name)
def test_neg_zero_flag_parity(dtype):
    x = _keys(dtype)
    got = tkb.neg_zero_flag(to_torch(x))
    assert got.dtype == torch.int32 and int(got.sum()) >= 1
    assert_bits_equal(got, np.asarray(jkb.neg_zero_flag(jnp.asarray(x))))


def test_dtype_tables():
    assert [TORCH_DTYPE[d] for d in jkb.supported_key_dtypes()] == list(
        tkb.supported_key_dtypes())
    for d in jkb.supported_key_dtypes():
        td = TORCH_DTYPE[d]
        assert tkb.bit_width(td) == jkb.bit_width(d)
        assert tkb.dtype_kind(td) == jkb.dtype_kind(d)
    with pytest.raises(TypeError):
        tkb.bit_width(torch.uint8)
