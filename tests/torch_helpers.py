"""Shared helpers for the PyTorch port's parity tests: the same numpy inputs
go to the JAX package and to ``tinyhipradixsort_torch``, and outputs are
compared bit-exactly as unsigned views (NaN payloads and -0.0 count)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

import tinyhipradixsort_torch as tthrs
import tinyhipradixsort_tpu as jthrs

BF16 = np.dtype(jnp.bfloat16)

#: numpy dtype -> torch dtype, for every key dtype of both packages
TORCH_DTYPE = {
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.uint64): torch.uint64,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.float16): torch.float16,
    BF16: torch.bfloat16,
}

_UNSIGNED = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def to_torch(a: np.ndarray) -> torch.Tensor:
    """numpy -> torch with the same bits (bfloat16 through a 16-bit view)."""
    a = np.ascontiguousarray(a)
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def ubits(a) -> np.ndarray:
    """Unsigned numpy view of the bits of a numpy array, jax array or torch
    tensor (what the parity tests compare)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        a = a.view(_SIGNED[a.dtype.itemsize]).numpy()
    a = np.asarray(a)
    return a.view(_UNSIGNED[a.dtype.itemsize])


def assert_bits_equal(got, want, msg: str = "") -> None:
    g, w = ubits(got), ubits(want)
    assert g.shape == w.shape, (msg, g.shape, w.shape)
    np.testing.assert_array_equal(g, w, err_msg=msg)


def rand_keys(rng: np.random.Generator, dtype, n: int) -> np.ndarray:
    """Random keys: floats with ~5% +0.0, ~5% -0.0, NaNs with random payloads
    and a few infinities; integers over the whole range."""
    dtype = np.dtype(dtype)
    if dtype.kind == "f" or dtype == BF16:
        x = rng.standard_normal(n).astype(dtype)
        x[rng.random(n) < 0.05] = 0.0
        x[rng.random(n) < 0.05] = -0.0
        x[rng.random(n) < 0.02] = np.inf
        u = x.view(_UNSIGNED[dtype.itemsize])
        nan = rng.random(n) < 0.03
        # all-ones exponent, random non-zero mantissa, random sign
        nbits = dtype.itemsize * 8
        mant = {16: 10, 32: 23, 64: 52}[nbits] if dtype != BF16 else 7
        exp = ((1 << (nbits - 1 - mant)) - 1) << mant
        payload = rng.integers(1, 1 << mant, size=n, dtype=np.uint64)
        sign = rng.integers(0, 2, size=n, dtype=np.uint64) << np.uint64(nbits - 1)
        u[nan] = (payload[nan] | np.uint64(exp) | sign[nan]).astype(u.dtype)
        return x
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, size=n, dtype=dtype, endpoint=True)


SIZES = (0, 1, 2, 129, 1024, 2000, 4097)


def check_parity(dtype, order, sizes=SIZES, seed=0):
    """sort_keys, sort_pairs and sort_indices of the port's bitonic engine
    (its plain twin on these CPU tensors) against the JAX package's stable
    permutation (``method="pallas"``), for each n."""
    rng = np.random.default_rng(seed)
    for n in sizes:
        x = rand_keys(rng, dtype, n)
        vals = rng.integers(0, 2**32, size=n, dtype=np.uint32)
        perm = np.asarray(jthrs.sort_indices(jnp.asarray(x), order=order,
                                             method="pallas"))
        msg = f"{np.dtype(dtype).name} {order} n={n}"
        xt = to_torch(x)
        assert_bits_equal(tthrs.sort_keys(xt, order=order, method="bitonic"),
                          x[perm], msg)
        k, v = tthrs.sort_pairs(xt, to_torch(vals), order=order,
                                method="bitonic")
        assert_bits_equal(k, x[perm], msg)
        assert_bits_equal(v, vals[perm], msg)
        idx = tthrs.sort_indices(xt, order=order, method="bitonic")
        assert idx.dtype == torch.int32, msg
        np.testing.assert_array_equal(idx.numpy(), perm, err_msg=msg)
        assert_bits_equal(xt, x, "inputs are never modified")
