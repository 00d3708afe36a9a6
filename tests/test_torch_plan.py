"""The PyTorch port's sweep planner: parity with the JAX planner at storage
rotation 0, coverage of the network, the Hopper tile choice, and the shared
window/padding helpers of ``ops/common.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from tinyhipradixsort_torch.ops import bitonic_engine as tbe
from tinyhipradixsort_torch.ops import common as tc
from tinyhipradixsort_tpu.ops import bitonic_engine as jbe
from tinyhipradixsort_tpu.ops import common as jc

# (tile_bits, chunk_bits, g_max_cross): the port's own plans (chunk = tile,
# cross groups up to 8 bits) and the JAX package's default 2**18/2**13 form.
# Cross-group caps stay <= tile_bits - 7, where the two packages' low-chunk
# clamps (TPU lanes: 7 bits, Hopper: MIN_CHUNK_BITS) agree.
CONFIGS = [(15, 15, 8), (14, 14, 7), (13, 13, 6), (15, 13, None),
           (18, 13, None)]


def _fields(sweeps):
    return [(s.c, s.g, s.j_lo, s.L, s.substages, s.forced_asc)
            for s in sweeps]


@pytest.mark.parametrize("L", range(10, 27))
def test_plan_matches_jax(L):
    for tile, chunk, gmax in CONFIGS:
        got = tbe.plan_sweeps(L, tile, chunk, g_max_cross=gmax)
        want = jbe.plan_sweeps(L, tile, chunk, rot=0, g_max_cross=gmax)
        assert _fields(got) == _fields(want), (L, tile, chunk, gmax)


@pytest.mark.parametrize("r", [10, 12, 17])
def test_plan_matches_jax_stage_subset_and_forced(r):
    L = r + 3
    got = tbe.plan_sweeps(L, 14, 14, stages=range(1, r + 1), forced_asc=r,
                          g_max_cross=7)
    want = jbe.plan_sweeps(L, 14, 14, rot=0, stages=range(1, r + 1),
                           forced_asc=r, g_max_cross=7)
    assert _fields(got) == _fields(want)
    assert all(s.forced_asc == r for s in got)


@pytest.mark.parametrize("L", [10, 14, 19, 26, 28])
def test_plan_covers_network(L):
    for nwords in (1, 3, 5):
        T = tbe._tile_bits_for(nwords, L, tbe.EngineTuning())
        sweeps = tbe.plan_sweeps(L, T, T, g_max_cross=8)
        subs = [s for sw in sweeps for s in sw.substages]
        assert subs == [(k, j) for k in range(1, L + 1)
                        for j in range(k - 1, -1, -1)]
        for sw in sweeps:
            A, B = sw.grid()
            assert A * B * sw.tile_elems == 1 << L
            assert sw.c >= tbe.MIN_CHUNK_BITS and sw.c + sw.g == T
            assert len(sw.substages) <= tbe.MAX_SUBSTAGES
            for _, j in sw.substages:
                assert 0 <= sw.tile_bit(j) < sw.c + sw.g


@pytest.mark.parametrize("nwords", range(1, 9))
def test_tile_bits_fit_shared_memory(nwords):
    tuning = tbe.EngineTuning()
    T = tbe._tile_bits_for(nwords, 40, tuning)
    tile_bytes = nwords * 4 * (1 << T)
    assert tbe.MIN_L <= T
    assert tile_bytes <= tuning.smem_tile_bytes <= tbe.SMEM_MAX_BYTES
    assert 2 * tile_bytes > tuning.smem_tile_bytes  # the largest that fits
    assert tbe._tile_bits_for(nwords, 12, tuning) == min(T, 12)
    assert {1: 15, 3: 14, 5: 13}.get(nwords, T) == T


@pytest.mark.parametrize("nwords", range(1, 9))
def test_tile_bits_stay_within_the_register_body(nwords):
    # the largest budget reaches the register body's largest tile; only 7
    # words would outgrow it (a 2**13 tile of 28 B tuples fits 227 KB)
    tuning = tbe.EngineTuning(smem_tile_bytes=tbe.SMEM_MAX_BYTES)
    T = tbe._tile_bits_for(nwords, 40, tuning)
    assert T == tbe.REGISTER_TILE_BITS[nwords]
    fits = (tbe.SMEM_MAX_BYTES // (4 * nwords)).bit_length() - 1
    assert (fits > T) == (nwords == 7)


def test_tile_bits_refuse_tuples_too_wide_for_a_block():
    with pytest.raises(ValueError):
        tbe._tile_bits_for(tbe.MAX_WORDS + 1, 20, tbe.EngineTuning())


def test_tuning_from_env_reads_every_field(monkeypatch):
    assert tbe.EngineTuning.from_env() == tbe.EngineTuning()
    monkeypatch.setenv("THRS_CROSS_G_MAX", "5")
    monkeypatch.setenv("THRS_SMEM_TILE_BYTES", "65536")
    monkeypatch.setenv("THRS_SEG_PAD_WASTE", "0.5")
    monkeypatch.setenv("THRS_ROW_SEG_WASTE", "0.3")
    monkeypatch.setenv("THRS_ROW_SEG_MIN_NR", "64")
    got = tbe.EngineTuning.from_env()
    assert got == tbe.EngineTuning(smem_tile_bytes=65536, cross_g_max=5,
                                   seg_pad_waste=0.5, row_seg_waste=0.3,
                                   row_seg_min_nr=64)
    routing = ("seg_pad_waste", "row_seg_waste", "row_seg_min_nr")
    assert {f.name for f in dataclasses.fields(got)} == {
        "smem_tile_bytes", "cross_g_max", *routing}
    assert tbe._tile_bits_for(1, 30, got) == 14
    # the routing knobs keep the JAX package's names and defaults
    jt, tt = jbe.EngineTuning(), tbe.EngineTuning()
    assert [getattr(tt, k) for k in routing] == [getattr(jt, k)
                                                 for k in routing]


def test_common_helpers_match_jax():
    for start, end in ((0, 32), (0, 8), (5, 17), (30, 64), (0, 64)):
        assert tc.digit_plan(start, end) == jc.digit_plan(start, end)
    for tdt, ndt in ((torch.uint32, np.uint32), (torch.float64, np.float64)):
        width = np.dtype(ndt).itemsize * 8
        for window in ((0, None), (3, 11), (1, width)):
            assert tc.resolve_window(tdt, *window) == jc.resolve_window(
                ndt, *window)
        with pytest.raises(ValueError):
            tc.resolve_window(tdt, 4, width + 1)
    rng = np.random.default_rng(9)
    for udt, sdt, windows in ((np.uint32, np.int32, ((0, 32), (3, 11), (8, 32))),
                              (np.uint64, np.int64, ((0, 64), (5, 40), (33, 64)))):
        bits = rng.integers(0, np.iinfo(udt).max, size=256, dtype=udt,
                            endpoint=True)
        for start, end in windows:
            got = tc.window_values(torch.from_numpy(bits.view(sdt)), start, end)
            want = np.asarray(jc.window_values(bits, start, end))
            np.testing.assert_array_equal(got.numpy().view(udt), want)
    padded = tc.pad_to_multiple(torch.arange(5, dtype=torch.int32), 4, -1)
    assert padded.tolist() == [0, 1, 2, 3, 4, -1, -1, -1]
    x = torch.arange(8, dtype=torch.int32)
    assert tc.pad_to_multiple(x, 8, -1).data_ptr() != x.data_ptr()
    assert not tc.on_cuda(x)
