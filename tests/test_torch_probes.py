"""The plain versions of the two probes (``tinyhipradixsort_torch/tools``)
against the numpy checks that the JAX package's tools assert.

The JAX probes' Pallas kernels are written for the TPU's SMEM and DMA
engines and are not run here; these tests copy the tools' own numpy checks
instead: ``tools/gather_floor.py:89-93`` (the checksum loop over rounds)
and ``tools/partition_dma_floor.py:100-105`` (the run-by-run copy). On CPU
tensors the probes' entry points run the plain versions and launch nothing.
"""

import numpy as np
import pytest
import torch

from tinyhipradixsort_torch.tools import gather_floor as tgf
from tinyhipradixsort_torch.tools import partition_dma_floor as tpd


def _numpy_checksum(idx_np, src_np, m, rounds):
    # tools/gather_floor.py:89-93
    j = idx_np[0]
    acc = np.uint32(0)
    with np.errstate(over="ignore"):  # the sum is mod 2**32 on purpose
        for o in range(rounds):
            acc = (acc + src_np[0][(j + np.uint32(o)) & np.uint32(m - 1)]
                   .sum(dtype=np.uint64).astype(np.uint32))
    return acc


@pytest.mark.parametrize("m,rounds", [(1, 3), (64, 5), (1024, 300),
                                      (4096, 7), (16384, 2), (8, 33),
                                      (16384, 40)])
def test_gather_checksum_matches_the_tools_numpy_check(m, rounds):
    idx, src = tgf.make_tables(m, seed=m, device="cpu")
    before = tgf.KERNEL_LAUNCHES
    got = tgf.gather_checksum(idx, src, rounds)
    assert tgf.KERNEL_LAUNCHES == before
    assert got.shape == (1, 1) and got.dtype == torch.int32
    want = _numpy_checksum(idx.numpy(), src.numpy().view(np.uint32), m, rounds)
    assert got.numpy().view(np.uint32)[0, 0] == want


def test_gather_tables_are_the_tools_tables():
    # same seed, same numpy calls as tools/gather_floor.py:75-77
    idx, src = tgf.make_tables(4096, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        idx.numpy(), rng.permutation(4096).astype(np.int32).reshape(1, 4096))
    np.testing.assert_array_equal(
        src.numpy().view(np.uint32),
        rng.integers(0, 2**32, size=(1, 4096), dtype=np.uint32))
    with pytest.raises(ValueError):
        tgf.make_tables(100, device="cpu")


def test_gather_checksum_on_a_non_permutation():
    # the checksum is defined for any idx, not only for permutations
    idx = torch.tensor([[3, 3, 0, 1, 7, 7, 7, 2]], dtype=torch.int32)
    src = torch.arange(8, dtype=torch.int32).view(1, 8) * 1_000_000_007
    got = tgf.gather_checksum(idx, src, 11)
    want = _numpy_checksum(idx.numpy(), src.numpy().view(np.uint32), 8, 11)
    assert got.numpy().view(np.uint32)[0, 0] == want


def _numpy_scatter(offs, src, t, r):
    # tools/partition_dma_floor.py:100-105
    n = t * tpd.B * r
    want = np.empty(n, np.uint32)
    for ti in range(t):
        for b in range(tpd.B):
            o = offs[ti, b] * r
            want[o:o + r] = src[(ti * tpd.B + b) * r:(ti * tpd.B + b + 1) * r]
    return want


@pytest.mark.parametrize("r,t", [(1024, 1), (4, 3), (1000, 2), (7, 2),
                                 (1, 1)])
def test_partition_scatter_matches_the_tools_numpy_check(r, t):
    offs, src = tpd.make_inputs(t, r, seed=r + t, device="cpu")
    assert sorted(offs.reshape(-1).tolist()) == list(range(t * tpd.B))
    before = tpd.KERNEL_LAUNCHES
    got = tpd.partition_scatter(offs, src, r)
    assert tpd.KERNEL_LAUNCHES == before
    np.testing.assert_array_equal(
        got.numpy().view(np.uint32),
        _numpy_scatter(offs.numpy(), src.numpy().view(np.uint32), t, r))


def test_probes_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (tgf.main, tpd.main):
        with pytest.raises(SystemExit, match="is_available"):
            main([])
