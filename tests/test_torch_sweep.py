"""Per-sweep parity: hand-built sweeps (storage rotation 0) through the JAX
package's Pallas ``run_sweep`` (interpreted on the CPU) and through the
PyTorch port's plain version ``run_sweep_reference``, bit-exact.

Inputs obey the JAX kernel's word contract (its roll-form compare-exchange
duplicates the low tuple on ties): 1 word with no carries, or 3 compare words
ending in a distinct index word, optionally with 2 carry words.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyhipradixsort_torch.ops import bitonic_engine as tbe
from tinyhipradixsort_tpu.ops import bitonic_engine as jbe
from tests.torch_helpers import assert_bits_equal, to_torch


def _stages(lo, hi):
    return tuple((k, j) for k in range(lo, hi + 1)
                 for j in range(k - 1, -1, -1))


def _stage(k, j_hi, j_lo):
    return tuple((k, j) for j in range(j_hi, j_lo - 1, -1))


# name -> (c, g, j_lo, L, substages, forced_asc); tiles of 2**10..2**12
SWEEPS = {
    # local sweeps (j_lo == c): one contiguous tile
    "local-full-T10": (7, 3, 7, 12, _stages(1, 10), None),
    "local-late-T11": (11, 0, 11, 12, _stage(12, 10, 0), None),
    "local-late-T12": (12, 0, 12, 13, _stage(13, 11, 0), None),
    # cross sweeps: low chunk + a group of higher bits
    "cross-g1": (9, 1, 10, 12, _stage(11, 10, 10), None),
    "cross-g2": (8, 2, 10, 12, _stage(12, 11, 10), None),
    "cross-g3-B8": (7, 3, 10, 13, _stage(13, 12, 10), None),
    # forced ascending on a stage whose direction bit varies
    "local-forced": (10, 0, 10, 12, _stage(11, 9, 0), 11),
    "cross-forced": (8, 2, 10, 13, _stage(12, 11, 10), 12),
}
WORDS = {"1w": (1, 1), "3w-key-hi-lo-index": (3, 3), "5w-with-carries": (5, 3)}


def _words(nwords: int, n: int, seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    # word 0 from a small range so ties fall through to later words
    words = [rng.integers(0, 16, size=n, dtype=np.uint32)]
    if nwords > 1:
        hi = rng.integers(0, 2**32, size=n, dtype=np.uint32)
        hi[rng.random(n) < 0.05] = 0xFFFFFFFF
        words += [hi, rng.permutation(n).astype(np.uint32)]
    while len(words) < nwords:
        words.append(rng.integers(0, 2**32, size=n, dtype=np.uint32))
    return words


@pytest.mark.parametrize("wname", list(WORDS))
@pytest.mark.parametrize("sname", list(SWEEPS))
def test_sweep_parity(sname, wname):
    c, g, j_lo, L, subs, forced = SWEEPS[sname]
    nwords, ncmp = WORDS[wname]
    words = _words(nwords, 1 << L, seed=sum(map(ord, sname + wname)))
    jsweep = jbe.Sweep(c=c, g=g, j_lo=j_lo, L=L, substages=subs,
                       forced_asc=forced)
    want = jbe.run_sweep([jnp.asarray(w) for w in words], jsweep, ncmp,
                         interpret=True)
    tsweep = tbe.Sweep(c=c, g=g, j_lo=j_lo, L=L, substages=subs,
                       forced_asc=forced)
    twords = [to_torch(w).view(torch.int32) for w in words]
    before = tbe.KERNEL_LAUNCHES
    got = tbe.run_sweep_reference(twords, tsweep, ncmp)
    assert got is twords  # in place
    for gw, ww in zip(got, want):
        assert_bits_equal(gw, np.asarray(ww), f"{sname}/{wname}")
    # on CPU tensors run_sweep is the plain version and launches nothing
    again = tbe.run_sweep([to_torch(w).view(torch.int32) for w in words],
                          tsweep, ncmp)
    for a, b in zip(again, got):
        assert torch.equal(a, b)
    assert tbe.KERNEL_LAUNCHES == before


def test_whole_network_sorts_lexicographically():
    # 5 words in a 2**10 tile: local and cross sweeps
    words = _words(5, 1 << 12, seed=5)
    twords = [to_torch(w).view(torch.int32) for w in words]
    tbe._run_network(twords, 3, 12, tbe.EngineTuning(smem_tile_bytes=20 << 10))
    got = [w.numpy().view(np.uint32) for w in twords]
    order = np.lexsort(tuple(reversed(words[:3])))
    for g, w in zip(got, words):
        np.testing.assert_array_equal(g, w[order])


def test_run_sweep_refuses_devices_without_a_kernel():
    sweep = tbe.Sweep(c=10, g=0, j_lo=10, L=10, substages=_stage(1, 0, 0))
    with pytest.raises(ValueError):
        tbe.run_sweep([torch.empty(1024, dtype=torch.int32, device="meta")],
                      sweep, 1)


def test_sweep_refuses_lengths_off_the_block_span():
    sweep = tbe.Sweep(c=8, g=2, j_lo=10, L=12, substages=_stage(12, 11, 10))
    with pytest.raises(ValueError):
        tbe.run_sweep_reference([torch.zeros(3 << 10, dtype=torch.int32)],
                                sweep, 1)
