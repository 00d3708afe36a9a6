"""Stage 3 of the counting engine, ``rank_scatter``: the port's plain
version against the JAX package's ``_pass_inverse_perm``
(``tinyhipradixsort_tpu/ops/counting_engine.py``), bit for bit, on the same
digits made with numpy from a seed. On the CPU the port's wrapper runs
``rank_scatter_reference`` and launches nothing; the kernel itself is held
against it on the card (``tests/test_torch_cuda.py``).

``base`` is stage 2's output, computed here with numpy: each row's
bucket-major exclusive scan of its per-tile digit counts, plus the row's
offset. The JAX function scans one row's counts itself, so R > 1 rows are
R calls, each offset by its row's start.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinyhipradixsort_torch as tthrs
from tinyhipradixsort_torch.ops import counting_engine as tce
from tinyhipradixsort_tpu.ops import counting_engine as jce

RNG_SEED = 0x5CA7
TILES_PER_ROW = 2

#: (64-bit bits, shift, width): the u32 and u64 digits of a window, and a
#: 3-bit last digit
WINDOWS = [(False, 0, 8), (False, 24, 8), (False, 29, 3),
           (True, 0, 8), (True, 24, 8), (True, 56, 8), (True, 61, 3)]


def _make_bits(kind, wide, R, tile, rng):
    """R rows of TILES_PER_ROW tiles of u32 or u64 patterns, flat."""
    n = R * TILES_PER_ROW * tile
    udt = np.uint64 if wide else np.uint32
    top = np.iinfo(udt).max
    if kind == "random":
        return rng.integers(0, top, size=n, dtype=udt, endpoint=True)
    if kind == "one":
        return np.full(n, rng.integers(0, top, dtype=udt, endpoint=True),
                       dtype=udt)
    if kind == "two":
        pair = rng.integers(0, top, size=2, dtype=udt, endpoint=True)
        pair[1] = ~pair[0]  # every digit window differs
        return pair[rng.integers(0, 2, size=n)]
    # "padded": each row's tail of all-ones bits, as the engine pads it
    x = rng.integers(0, top, size=n, dtype=udt, endpoint=True).reshape(R, -1)
    x[:, -(tile // 2 + 17):] = top
    return x.reshape(-1)


def _digits(x, shift, width):
    return ((x >> x.dtype.type(shift)) & x.dtype.type((1 << width) - 1)
            ).astype(np.int64)


def _base(digits, R, tile, width):
    """Stage 2 in numpy: ``(R * Tr, 2**width)`` global offsets."""
    nb = 1 << width
    d = digits.reshape(R, TILES_PER_ROW, tile)
    rows = []
    for r in range(R):
        counts = np.stack([np.bincount(t, minlength=nb) for t in d[r]])
        flat = counts.T.reshape(-1)
        ex = np.cumsum(flat) - flat
        rows.append(ex.reshape(nb, TILES_PER_ROW).T + r * TILES_PER_ROW * tile)
    return np.concatenate(rows)


def _jax_src(digits, R, tile, width, idx_np):
    """The JAX package's inverse permutation, row by row, offset."""
    d = digits.reshape(R, TILES_PER_ROW, tile).astype(np.int32)
    idx_dt = jnp.int64 if idx_np == np.int64 else jnp.int32
    per_row = TILES_PER_ROW * tile
    return np.concatenate([
        np.asarray(jce._pass_inverse_perm(jnp.asarray(d[r]), 1 << width,
                                          idx_dt)).astype(idx_np)
        + r * per_row for r in range(R)])


def _check(x, shift, width, R, tile, idx_np):
    digits = _digits(x, shift, width)
    want_src = _jax_src(digits, R, tile, width, idx_np)
    idx_dt = torch.int64 if idx_np == np.int64 else torch.int32
    sdt = np.int64 if x.dtype == np.uint64 else np.int32
    bits = torch.from_numpy(x.view(sdt).copy())
    base = torch.from_numpy(_base(digits, R, tile, width).astype(idx_np))
    before = tce.KERNEL_LAUNCHES
    bits_out, src = tce.rank_scatter(bits, shift, width, base, tile, idx_dt)
    assert tce.KERNEL_LAUNCHES == before  # CPU tensors: the plain version
    assert src.dtype == idx_dt and bits_out.dtype == bits.dtype
    np.testing.assert_array_equal(src.numpy(), want_src)
    np.testing.assert_array_equal(bits_out.numpy().view(x.dtype),
                                  x[want_src])


@pytest.mark.parametrize("idx_np", [np.int32, np.int64])
@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("tile", [1024, 2048, 3072])
@pytest.mark.parametrize("wide,shift,width", WINDOWS)
def test_plain_version_matches_the_jax_pass(wide, shift, width, tile, R,
                                            idx_np):
    rng = np.random.default_rng([RNG_SEED, tile, R, shift, width, wide])
    _check(_make_bits("random", wide, R, tile, rng), shift, width, R, tile,
           idx_np)


@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("kind", ["one", "two", "padded"])
def test_plain_version_matches_the_jax_pass_on_skewed_digits(kind, wide, R):
    rng = np.random.default_rng([RNG_SEED, R, wide, len(kind)])
    x = _make_bits(kind, wide, R, 2048, rng)
    shift = 56 if wide else 24
    _check(x, shift, 8, R, 2048, np.int32)


def test_engine_marks_its_stages_and_launches_nothing_on_the_cpu():
    x = np.random.default_rng(RNG_SEED).integers(0, 2**32, size=5000,
                                                 dtype=np.uint32)
    stages = []
    before = tce.KERNEL_LAUNCHES
    out = tce.sort_arrays_counting(torch.from_numpy(x.view(np.int32)),
                                   [torch.from_numpy(x)], 0, 32,
                                   mark=stages.append)
    np.testing.assert_array_equal(out[0].numpy(), np.sort(x))
    assert stages == ["pad"] + 4 * ["histogram", "scan", "rank_scatter",
                                    "gathers"]
    np.testing.assert_array_equal(
        tthrs.sort_keys(torch.from_numpy(x), method="counting").numpy(),
        np.sort(x))
    assert tce.KERNEL_LAUNCHES == before


def test_rank_scatter_refuses_what_it_does_not_take():
    bits = torch.zeros(2048, dtype=torch.int32)
    base = torch.zeros((1, 256), dtype=torch.int32)
    with pytest.raises(ValueError, match="no rank_scatter implementation"):
        tce.rank_scatter(bits.to("meta"), 0, 8, base.to("meta"), 2048,
                         torch.int32)
    with pytest.raises(TypeError):
        tce.rank_scatter(bits.float(), 0, 8, base, 2048, torch.int32)
    with pytest.raises(TypeError):
        tce.rank_scatter(bits, 0, 8, base, 2048, torch.int16)
    with pytest.raises(ValueError):  # not whole tiles
        tce.rank_scatter(bits, 0, 8, base, 1000, torch.int32)
    with pytest.raises(ValueError):  # base of the wrong shape
        tce.rank_scatter(bits, 0, 8, base[:, :128], 2048, torch.int32)
    with pytest.raises(ValueError):  # base of the wrong dtype
        tce.rank_scatter(bits, 0, 8, base.long(), 2048, torch.int32)
    with pytest.raises(ValueError):  # the window past the word
        tce.rank_scatter(bits, 28, 8, base, 2048, torch.int32)
