"""Stage 2 of the counting engine, ``bucket_offsets``: the port's plain
version against the JAX package's ``exclusive_scan_bucket_major``
(``tinyhipradixsort_tpu/ops/histogram.py``) plus each row's start, bit for
bit, on counts made with numpy from a seed; then the counting pass and the
counting sort that take their offsets from it, against the JAX counting
engine. On the CPU the wrapper runs ``bucket_offsets_reference`` and
launches nothing; the kernel (``csrc/bucket_scan.cu``) is held against it
on the card (``tests/test_torch_cuda.py``).

The JAX function scans one row's ``(tiles, buckets)`` counts, so R > 1 rows
are R calls, each offset by its row's start ``r * tiles * tile``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import to_torch
from tinyhipradixsort_torch import tracing
from tinyhipradixsort_torch.ops import counting_engine as tce
from tinyhipradixsort_torch.ops import histogram as th
from tinyhipradixsort_tpu.ops import counting_engine as jce
from tinyhipradixsort_tpu.ops import histogram as jh

RNG_SEED = 0xB5CA
TILE = 1024
TILES = 7


def _jax_offsets(counts, tile, idx_np):
    """Each row's JAX bucket-major scan in ``idx_np``, plus the row's
    start."""
    R, Tr, _ = counts.shape
    return np.stack([
        np.asarray(jh.exclusive_scan_bucket_major(
            jnp.asarray(counts[r].astype(idx_np)))) + r * Tr * tile
        for r in range(R)]).astype(idx_np)


def _port_offsets(counts, tile, idx_np):
    idx_dt = torch.int64 if idx_np == np.int64 else torch.int32
    before = th.SCAN_LAUNCHES
    got = th.bucket_offsets(to_torch(counts), tile, idx_dt)
    assert th.SCAN_LAUNCHES == before  # CPU tensors: the plain version
    assert got.dtype == idx_dt and got.is_contiguous()
    assert tuple(got.shape) == counts.shape
    return got.numpy()


@pytest.mark.parametrize("idx_np", [np.int32, np.int64])
@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("width", [1, 3, 8])
def test_plain_version_matches_the_jax_scan(width, R, idx_np):
    rng = np.random.default_rng([RNG_SEED, width, R])
    counts = rng.integers(0, TILE, size=(R, TILES, 1 << width),
                          dtype=np.int32, endpoint=True)
    np.testing.assert_array_equal(_port_offsets(counts, TILE, idx_np),
                                  _jax_offsets(counts, TILE, idx_np))


@pytest.mark.parametrize("idx_np", [np.int32, np.int64])
@pytest.mark.parametrize("kind", ["one-bucket", "zero-columns"])
def test_plain_version_on_skewed_counts(kind, idx_np):
    rng = np.random.default_rng([RNG_SEED, len(kind)])
    R, nb = 3, 256
    if kind == "one-bucket":
        # every element of every tile has digit 77
        counts = np.zeros((R, TILES, nb), np.int32)
        counts[:, :, 77] = TILE
    else:
        # tiles of real histograms, with every third bucket empty
        digits = rng.integers(0, nb // 3, size=(R, TILES, TILE)) * 3
        counts = np.stack([[np.bincount(t, minlength=nb) for t in row]
                           for row in digits]).astype(np.int32)
    got = _port_offsets(counts, TILE, idx_np)
    np.testing.assert_array_equal(got, _jax_offsets(counts, TILE, idx_np))
    if kind == "one-bucket":
        r, t, b = np.meshgrid(np.arange(R), np.arange(TILES), np.arange(nb),
                              indexing="ij")
        want = (r * TILES * TILE + np.where(b > 77, TILES * TILE, 0)
                + np.where(b == 77, t * TILE, 0))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("idx_np", [np.int32, np.int64])
@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("width", [1, 3, 8])
def test_run_sums_route_matches_the_jax_scan(width, R, idx_np):
    # rows of 7 tiles of 2**17 in runs of 2, the last one short
    tile, Tr = 1 << 17, 7
    rng = np.random.default_rng([RNG_SEED, width, R, 2])
    counts = rng.integers(0, tile, size=(R, Tr, 1 << width), dtype=np.int32,
                          endpoint=True)
    sums = th.run_sums_reference(to_torch(counts), tile)
    assert tuple(sums.shape) == (R, 4, 1 << width)
    kept = sums.clone()
    idx_dt = torch.int64 if idx_np == np.int64 else torch.int32
    before = (th.SCAN_LAUNCHES, th.SCAN_SUM_WALKS)
    got = th.bucket_offsets(to_torch(counts), tile, idx_dt, run_sums=sums)
    assert (th.SCAN_LAUNCHES, th.SCAN_SUM_WALKS) == before  # plain version
    assert torch.equal(sums, kept)  # which needs no run sums
    assert got.dtype == idx_dt and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_offsets(counts, tile, idx_np))


@pytest.mark.parametrize("bad", ["int32", "runs", "strided", "meta"])
def test_bucket_offsets_refuses_run_sums_it_does_not_take(bad):
    tile, Tr = 1 << 17, 7
    counts = torch.zeros((2, Tr, 256), dtype=torch.int32)
    sums = th.run_sums_reference(counts, tile)
    sums = {"int32": sums.to(torch.int32), "runs": sums[:, :3],
            "strided": sums.transpose(0, 1).contiguous().transpose(0, 1),
            "meta": sums.to("meta")}[bad]
    with pytest.raises(ValueError):
        th.bucket_offsets(counts, tile, torch.int32, run_sums=sums)


def _jax_src(digits, R, tile, width):
    """The JAX package's inverse permutation of one pass, row by row,
    offset to each row's range."""
    per_row = digits.shape[1] * tile
    return np.concatenate([
        np.asarray(jce._pass_inverse_perm(
            jnp.asarray(digits[r].astype(np.int32)), 1 << width, jnp.int32))
        + r * per_row for r in range(R)])


@pytest.mark.parametrize("R", [1, 3], ids=["one-row", "batched"])
def test_counting_pass_matches_the_jax_pass(R):
    shift, width, Tr = 8, 8, 3
    rng = np.random.default_rng([RNG_SEED, R])
    x = rng.integers(0, 2**32, size=R * Tr * TILE, dtype=np.uint32)
    x[::5] = x[3]  # ties: stability decides
    bits = torch.from_numpy(x.view(np.int32).copy())
    with tracing.record() as rec:
        bits_out, src, moved = tce._pass(bits, shift, width, R, TILE,
                                         torch.int32, [], True)
    stages = [s.name for s in rec.spans if s.name.startswith("counting.")]
    assert stages == ["counting.histogram", "counting.scan",
                      "counting.rank_scatter"]
    assert moved == []
    digits = ((x >> shift) & 0xFF).reshape(R, Tr, TILE)
    want = _jax_src(digits, R, TILE, width)
    np.testing.assert_array_equal(src.numpy(), want)
    np.testing.assert_array_equal(bits_out.numpy().view(np.uint32), x[want])


@pytest.mark.parametrize("R", [1, 2], ids=["one-row", "batched"])
def test_counting_pass_with_run_sums_matches_the_jax_pass(R, monkeypatch):
    # rows of 130 tiles: runs of 128 and of 2
    shift, width, Tr = 0, 8, 130
    rng = np.random.default_rng([RNG_SEED, R, Tr])
    x = rng.integers(0, 2**32, size=R * Tr * TILE, dtype=np.uint32)
    x[::3] = x[1]  # ties: stability decides
    bits = torch.from_numpy(x.view(np.int32).copy())
    calls = []
    real = th.digit_histogram_runs

    def counted(*args):
        calls.append(args[1:])
        return real(*args)

    monkeypatch.setattr(th, "digit_histogram_runs", counted)
    bits_out, src, _ = tce._pass(bits, shift, width, R, TILE, torch.int32,
                                 [], True)
    assert calls == [(shift, width, TILE, Tr)]
    want = _jax_src(((x >> shift) & 0xFF).reshape(R, Tr, TILE), R, TILE,
                    width)
    np.testing.assert_array_equal(src.numpy(), want)
    np.testing.assert_array_equal(bits_out.numpy().view(np.uint32), x[want])


@pytest.mark.parametrize("shape", [(5000,), (3, 3000)],
                         ids=["one-row", "batched"])
def test_counting_sort_matches_the_jax_engine(shape):
    rng = np.random.default_rng([RNG_SEED, len(shape)])
    x = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    x.reshape(-1)[::7] = x.reshape(-1)[1]  # ties: stability decides
    v = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    bits = torch.from_numpy(x.view(np.int32).copy())
    keys, vals = tce.sort_arrays_counting(
        bits, [to_torch(x), to_torch(v)], 0, 32)
    rows = x.reshape(-1, shape[-1])
    vrows = v.reshape(-1, shape[-1])
    want = [jce.sort_arrays_counting(jnp.asarray(r), [jnp.asarray(r),
                                                      jnp.asarray(w)], 0, 32)
            for r, w in zip(rows, vrows)]
    np.testing.assert_array_equal(
        keys.numpy().reshape(rows.shape),
        np.stack([np.asarray(k) for k, _ in want]))
    np.testing.assert_array_equal(
        vals.numpy().reshape(rows.shape),
        np.stack([np.asarray(w) for _, w in want]))


@pytest.mark.parametrize("counts,tile,idx_dt,error", [
    (torch.zeros((1, 2, 256), dtype=torch.int32, device="meta"), TILE,
     torch.int32, ValueError),                       # neither CPU nor CUDA
    (torch.zeros((1, 2, 512), dtype=torch.int32), TILE, torch.int32,
     ValueError),                                    # width 9
    (torch.zeros((1, 2, 12), dtype=torch.int32), TILE, torch.int32,
     ValueError),                                    # not 2**width buckets
    (torch.zeros((1, 2, 256), dtype=torch.int64), TILE, torch.int32,
     TypeError),                                     # int64 counts
    (torch.zeros((1, 256, 2), dtype=torch.int32).transpose(1, 2), TILE,
     torch.int32, ValueError),                       # not contiguous
    (torch.zeros((2, 256), dtype=torch.int32), TILE, torch.int32,
     TypeError),                                     # no row axis
    (torch.zeros((1, 2, 256), dtype=torch.int32), TILE, torch.float32,
     TypeError),                                     # offsets not int
    (torch.zeros((1, 2, 256), dtype=torch.int32), 2**30, torch.int32,
     ValueError),                                    # 2**31 elements
], ids=["meta-device", "width-9", "12-buckets", "int64-counts",
        "strided", "2-d", "float-offsets", "int32-overflow"])
def test_bucket_offsets_refuses_what_it_does_not_take(counts, tile, idx_dt,
                                                      error):
    before = th.SCAN_LAUNCHES
    with pytest.raises(error):
        th.bucket_offsets(counts, tile, idx_dt)
    assert th.SCAN_LAUNCHES == before


@pytest.mark.parametrize("shape,runs", [((280_000,), 4), ((2, 270_000), 4),
                                        ((3, 3000), 0)],
                         ids=["one-row", "batched", "rows-of-one-run"])
def test_counting_sort_takes_the_run_sums_where_rows_hold_several_runs(
        shape, runs, monkeypatch):
    # rows of 137 and 132 tiles of 2048 hold two runs each: all four passes
    # take stage 1's run sums; rows of one tile take none
    rng = np.random.default_rng([RNG_SEED, len(shape), 9])
    x = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    x.reshape(-1)[::11] = x.reshape(-1)[2]  # ties: stability decides
    calls = []
    real = th.digit_histogram_runs

    def counted(*args):
        calls.append(args[1:])
        return real(*args)

    monkeypatch.setattr(th, "digit_histogram_runs", counted)
    bits = torch.from_numpy(x.view(np.int32).copy())
    (keys,) = tce.sort_arrays_counting(bits, [to_torch(x)], 0, 32)
    assert len(calls) == runs
    rows = x.reshape(-1, shape[-1])
    want = [np.asarray(jce.sort_arrays_counting(jnp.asarray(r),
                                                [jnp.asarray(r)], 0, 32)[0])
            for r in rows]
    np.testing.assert_array_equal(keys.numpy().reshape(rows.shape),
                                  np.stack(want))
