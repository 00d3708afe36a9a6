"""The port's digit histogram and bucket-major scan against the JAX
package's (``tinyhipradixsort_tpu/ops/histogram.py``, the Pallas kernel run
with ``interpret=True``), on the cases of ``tests/test_histogram.py`` at
sizes up to 2**14, bit-exact. On the CPU the port runs the kernel's plain
version, ``digit_histogram_reference``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import to_torch
from tinyhipradixsort_torch.ops import common as tcommon
from tinyhipradixsort_torch.ops import histogram as th
from tinyhipradixsort_tpu.ops import common as jcommon
from tinyhipradixsort_tpu.ops import histogram as jh

RNG_SEED = 0x415


def _jax_hist(x, shift, width, tile):
    return np.asarray(jh.digit_histogram(jnp.asarray(x), shift, width,
                                         tile=tile, interpret=True))


def _port_hist(x, shift, width, tile):
    before = th.KERNEL_LAUNCHES
    out = th.digit_histogram(to_torch(x), shift, width, tile)
    assert th.KERNEL_LAUNCHES == before  # CPU tensors: the plain version
    assert out.dtype == torch.int32
    return out.numpy()


@pytest.mark.parametrize("n", [1024, 8192, 10000, 16384])
@pytest.mark.parametrize("shift,width", [(0, 8), (8, 8), (24, 8), (4, 5)])
def test_digit_histogram_parity_u32(n, shift, width):
    x = np.random.default_rng(RNG_SEED + n).integers(
        0, 2**32, size=n, dtype=np.uint32)
    np.testing.assert_array_equal(_port_hist(x, shift, width, 8192),
                                  _jax_hist(x, shift, width, 8192))


@pytest.mark.parametrize("n,shift,width,tile", [
    (16384, 40, 8, 8192),   # u64: shifted into a 32-bit word first
    (10000, 56, 8, 4096),   # top byte; the pad still lands in bucket 255
    (5000, 60, 4, 3000),    # shift + width at the word's end
])
def test_digit_histogram_parity_u64(n, shift, width, tile):
    x = np.random.default_rng(RNG_SEED).integers(0, 2**64, size=n,
                                                 dtype=np.uint64)
    got = _port_hist(x, shift, width, tile)
    np.testing.assert_array_equal(got, _jax_hist(x, shift, width, tile))
    assert got.sum() == got.shape[0] * th.round_tile(tile)


@pytest.mark.parametrize("n,shift,width,tile", [
    (5000, 0, 2, 3000),     # width below the JAX kernel's bucket chunk; odd tile
    (5000, 30, 1, 8192),    # width 1 at the word's top
    (5000, 31, 1, 100),     # tile rounded up to the 1024 minimum
    (3000, 27, 5, 3000),
    (0, 0, 8, 1024),        # empty: one tile of pad
    (1, 3, 8, 1024),
])
def test_digit_histogram_parity_small_widths_and_odd_tiles(n, shift, width,
                                                           tile):
    x = np.random.default_rng(RNG_SEED + 1).integers(0, 2**32, size=n,
                                                     dtype=np.uint32)
    got = _port_hist(x, shift, width, tile)
    assert got.shape[1] == 1 << width
    np.testing.assert_array_equal(got, _jax_hist(x, shift, width, tile))


def test_digit_histogram_wide_digit_against_bincount():
    # width 12 (bins the kernel keeps in device memory on the card); the
    # JAX kernel takes minutes interpreted at this width, so the oracle is
    # numpy's bincount over the all-ones-padded tiles
    n, shift, width, tile = 9000, 4, 12, 4096
    x = np.random.default_rng(RNG_SEED + 2).integers(0, 2**32, size=n,
                                                     dtype=np.uint32)
    npad = -(-n // tile) * tile
    xp = np.concatenate([x, np.full(npad - n, 0xFFFFFFFF, np.uint32)])
    digit = (xp >> shift) & ((1 << width) - 1)
    want = np.stack([np.bincount(d, minlength=1 << width)
                     for d in digit.reshape(-1, tile)])
    np.testing.assert_array_equal(_port_hist(x, shift, width, tile), want)


@pytest.mark.parametrize("tile", [1, 100, 1024, 1025, 3000, 8192, 1 << 23])
def test_round_tile_matches_the_jax_rule(tile):
    want = max(1024, min(-(-tile // 128) * 128, 1 << 22))
    assert th.round_tile(tile) == want
    if tile <= 8192:
        x = np.arange(5000, dtype=np.uint32)
        assert _port_hist(x, 0, 8, tile).shape == \
            _jax_hist(x, 0, 8, tile).shape


def test_digit_histogram_refuses_bad_windows_and_dtypes():
    x32 = torch.zeros(16, dtype=torch.int32)
    x64 = torch.zeros(16, dtype=torch.int64)
    with pytest.raises(ValueError):
        th.digit_histogram(x32, 28, 8)          # shift + width > 32
    with pytest.raises(ValueError):
        th.digit_histogram(x64, 40, 33)         # width > 32 after the shift
    with pytest.raises(ValueError):
        th.digit_histogram(x32, 32, 1)          # shift past the word
    with pytest.raises(TypeError):
        th.digit_histogram(torch.zeros(16), 0, 8)
    with pytest.raises(TypeError):
        th.digit_histogram(x32.view(4, 4), 0, 8)
    # unsigned views are taken as their bit patterns
    u = to_torch(np.arange(16, dtype=np.uint32))
    assert th.digit_histogram(u, 0, 4).sum() == th.DEFAULT_TILE


@pytest.mark.parametrize("shape", [(7, 16), (1, 256), (33, 2)])
def test_bucket_major_scan_parity(shape):
    counts = np.random.default_rng(RNG_SEED + shape[0]).integers(
        0, 100, size=shape, dtype=np.int32)
    got = th.exclusive_scan_bucket_major(to_torch(counts))
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jh.exclusive_scan_bucket_major(jnp.asarray(counts))))


def test_bucket_major_scan_scans_each_row_of_a_batch():
    counts = np.random.default_rng(RNG_SEED).integers(0, 50, size=(3, 5, 8),
                                                      dtype=np.int64)
    got = th.exclusive_scan_bucket_major(to_torch(counts))
    for r in range(3):
        np.testing.assert_array_equal(
            got[r].numpy(),
            np.asarray(jh.exclusive_scan_bucket_major(jnp.asarray(counts[r]))))


@pytest.mark.parametrize("dtype,shift,width", [
    (np.uint32, 0, 8), (np.uint32, 24, 8), (np.uint32, 29, 3),
    (np.uint64, 56, 8), (np.uint64, 3, 8), (np.uint32, 0, 32)])
def test_extract_digit_parity(dtype, shift, width):
    x = np.random.default_rng(RNG_SEED).integers(0, np.iinfo(dtype).max,
                                                 size=500, dtype=dtype,
                                                 endpoint=True)
    bits = to_torch(x).view(torch.int32 if dtype == np.uint32 else torch.int64)
    got = tcommon.extract_digit(bits, shift, width)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jcommon.extract_digit(jnp.asarray(x), shift, width)))


def _jax_run_sums(counts, R, run):
    """The JAX counts ``(T, B)`` as R rows, summed over runs of ``run``
    tiles (the last run of a row short), in int64."""
    T, nb = counts.shape
    rows = counts.reshape(R, T // R, nb).astype(np.int64)
    return np.stack([np.stack([row[g:g + run].sum(0)
                               for g in range(0, T // R, run)])
                     for row in rows])


def _port_hist_runs(x, shift, width, tile, tiles_per_row):
    before = (th.KERNEL_LAUNCHES, th.RUN_LAUNCHES)
    counts, sums = th.digit_histogram_runs(to_torch(x), shift, width, tile,
                                           tiles_per_row)
    # CPU tensors: the plain version
    assert (th.KERNEL_LAUNCHES, th.RUN_LAUNCHES) == before
    assert counts.dtype == torch.int32 and sums.dtype == torch.int64
    return counts.numpy(), sums.numpy()


@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("width", [1, 3, 8])
@pytest.mark.parametrize("tile,tiles", [(2048, 129), (1 << 17, 3)],
                         ids=["runs-of-128", "tile-above-16384"])
def test_run_sums_match_the_jax_counts(tile, tiles, width, R):
    # rows of 129 tiles of 2048 (runs of 128, the last of 1 tile) and of 3
    # tiles of 2**17 (runs of 2, the last of 1)
    x = np.random.default_rng([RNG_SEED, width, R, tiles]).integers(
        0, 2**32, size=R * tiles * tile, dtype=np.uint32)
    shift = 32 - width
    run = th.run_tiles(tiles, tile)
    assert 1 < run < tiles and tiles % run
    want = _jax_hist(x, shift, width, tile)
    counts, sums = _port_hist_runs(x, shift, width, tile, tiles)
    np.testing.assert_array_equal(counts, want)
    assert sums.shape == (R, -(-tiles // run), 1 << width)
    np.testing.assert_array_equal(sums, _jax_run_sums(want, R, run))


@pytest.mark.parametrize("n,dtype,shift,width", [
    (3 * (1 << 17) - 1000, np.uint32, 8, 8),   # the pad in the last run
    (3 * (1 << 17) - 1, np.uint64, 56, 8),
    (0, np.uint32, 0, 3),                      # one tile of pad
])
def test_run_sums_on_a_ragged_tail(n, dtype, shift, width):
    tile = 1 << 17
    x = np.random.default_rng(RNG_SEED + n).integers(
        0, np.iinfo(dtype).max, size=n, dtype=dtype, endpoint=True)
    want = _jax_hist(x, shift, width, tile)
    T = want.shape[0]
    counts, sums = _port_hist_runs(x, shift, width, tile, T)
    np.testing.assert_array_equal(counts, want)
    np.testing.assert_array_equal(
        sums, _jax_run_sums(want, 1, th.run_tiles(T, tile)))
    assert sums.sum() == T * tile


@pytest.mark.parametrize("tiles,tile,run", [
    (1, 2048, 1), (128, 2048, 128), (1000, 1024, 128), (1000, 8192, 32),
    (7, 1 << 17, 2), (5, 1 << 22, 1), (3, 3000, 3)])
def test_run_tiles(tiles, tile, run):
    # at most 128 tiles and 2**18 elements a run, at most the row
    assert th.run_tiles(tiles, tile) == run


def test_digit_histogram_runs_refuses_what_it_does_not_take():
    x = torch.zeros(4 * 2048, dtype=torch.int32)
    with pytest.raises(ValueError):
        th.digit_histogram_runs(x, 0, 9, 2048, 4)     # width above 8
    with pytest.raises(ValueError):
        th.digit_histogram_runs(x, 0, 8, 2048, 3)     # 4 tiles, rows of 3
    with pytest.raises(ValueError):
        th.digit_histogram_runs(x, 0, 8, 2048, 0)
    with pytest.raises(ValueError):
        th.digit_histogram_runs(x.to("meta"), 0, 8, 2048, 4)
