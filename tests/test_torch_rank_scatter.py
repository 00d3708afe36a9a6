"""Stage 3 of the counting engine, ``rank_scatter``: the port's plain
version against the JAX package's ``_pass_inverse_perm``
(``tinyhipradixsort_tpu/ops/counting_engine.py``), bit for bit, on the same
digits made with numpy from a seed. On the CPU the port's wrapper runs
``rank_scatter_reference`` and launches nothing; the kernel itself is held
against it on the card (``tests/test_torch_cuda.py``).

``base`` is stage 2's output, computed here with numpy: each row's
bucket-major exclusive scan of its per-tile digit counts, plus the row's
offset, as ``(rows, tiles per row, 2**width)``. The JAX function scans one
row's counts itself, so R > 1 rows are R calls, each offset by its row's
start. Payloads (rows of 1, 2, 4, 8 or 16 bytes) are held against
``payload[src]`` of the JAX inverse permutation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinyhipradixsort_torch as tthrs
from tinyhipradixsort_torch import tracing
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
    return np.stack(rows)


def _jax_src(digits, R, tile, width, idx_np):
    """The JAX package's inverse permutation, row by row, offset."""
    d = digits.reshape(R, TILES_PER_ROW, tile).astype(np.int32)
    idx_dt = jnp.int64 if idx_np == np.int64 else jnp.int32
    per_row = TILES_PER_ROW * tile
    return np.concatenate([
        np.asarray(jce._pass_inverse_perm(jnp.asarray(d[r]), 1 << width,
                                          idx_dt)).astype(idx_np)
        + r * per_row for r in range(R)])


def _payload(rng, n, row_bytes, k):
    """A payload of ``n`` rows of ``row_bytes`` bytes, as the engine hands
    them: 1-byte rows as bool or uint8, wider ones as 1-D or ``(n, 4)``."""
    if row_bytes == 16:
        return rng.integers(0, 2**32, size=(n, 4), dtype=np.uint32)
    if row_bytes == 1 and k % 2:
        return rng.random(n) < 0.5
    dt = {1: np.uint8, 2: np.int16, 4: np.float32, 8: np.uint64}[row_bytes]
    raw = rng.integers(0, 2**(8 * row_bytes), size=n,
                       dtype={1: np.uint8, 2: np.uint16, 4: np.uint32,
                              8: np.uint64}[row_bytes])
    return raw.view(dt)


def _torch_payload(a):
    t = torch.from_numpy(a.view(np.int64) if a.dtype == np.uint64 else a)
    return t.view(torch.uint64) if a.dtype == np.uint64 else t


def _check(x, shift, width, R, tile, idx_np, payloads=(), want_src=True):
    digits = _digits(x, shift, width)
    want_src_np = _jax_src(digits, R, tile, width, idx_np)
    idx_dt = torch.int64 if idx_np == np.int64 else torch.int32
    sdt = np.int64 if x.dtype == np.uint64 else np.int32
    bits = torch.from_numpy(x.view(sdt).copy())
    base = torch.from_numpy(_base(digits, R, tile, width).astype(idx_np))
    before = tce.KERNEL_LAUNCHES
    bits_out, src, moved = tce.rank_scatter(
        bits, shift, width, base, tile, idx_dt,
        payloads=[_torch_payload(p) for p in payloads], want_src=want_src)
    assert tce.KERNEL_LAUNCHES == before  # CPU tensors: the plain version
    assert bits_out.dtype == bits.dtype
    if want_src:
        assert src.dtype == idx_dt
        np.testing.assert_array_equal(src.numpy(), want_src_np)
    else:
        assert src is None
    np.testing.assert_array_equal(bits_out.numpy().view(x.dtype),
                                  x[want_src_np])
    assert len(moved) == len(payloads)
    for p, m in zip(payloads, moved):
        got = (m.view(torch.int64).numpy().view(np.uint64)
               if m.dtype == torch.uint64 else m.numpy())
        assert got.dtype == p.dtype and got.shape == p.shape
        np.testing.assert_array_equal(got.view(np.uint8),
                                      p[want_src_np].view(np.uint8))


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


@pytest.mark.parametrize("want_src", [True, False])
@pytest.mark.parametrize("row_bytes", tce.ROW_BYTES)
def test_plain_version_carries_each_row_size(row_bytes, want_src):
    rng = np.random.default_rng([RNG_SEED, row_bytes, want_src])
    R, tile = 2, 1024
    x = _make_bits("random", False, R, tile, rng)
    n = x.shape[0]
    payloads = [_payload(rng, n, row_bytes, k) for k in range(2)]
    _check(x, 8, 8, R, tile, np.int32, payloads, want_src)


@pytest.mark.parametrize("want_src", [True, False])
@pytest.mark.parametrize("count", range(tce.MAX_PAYLOADS + 1))
def test_plain_version_carries_up_to_max_payloads(count, want_src):
    rng = np.random.default_rng([RNG_SEED, count, want_src, 1])
    R, tile = 3, 1024
    x = _make_bits("padded", True, R, tile, rng)
    n = x.shape[0]
    payloads = [_payload(rng, n, tce.ROW_BYTES[(count + k) % 5], k)
                for k in range(count)]
    _check(x, 56, 8, R, tile, np.int64, payloads, want_src)


def test_engine_marks_its_stages_and_launches_nothing_on_the_cpu():
    x = np.random.default_rng(RNG_SEED).integers(0, 2**32, size=5000,
                                                 dtype=np.uint32)
    before = tce.KERNEL_LAUNCHES
    with tracing.record() as rec:
        out = tce.sort_arrays_counting(torch.from_numpy(x.view(np.int32)),
                                       [torch.from_numpy(x)], 0, 32)
    np.testing.assert_array_equal(out[0].numpy(), np.sort(x))
    stages = [s.name.split(".", 1)[1] for s in rec.spans
              if s.name.startswith("counting.") and s.name != "counting.sort"]
    assert stages == ["pad"] + 4 * ["histogram", "scan", "rank_scatter",
                                    "gathers"]
    assert not any(s.name.startswith("launch.") for s in rec.spans)
    np.testing.assert_array_equal(
        tthrs.sort_keys(torch.from_numpy(x), method="counting").numpy(),
        np.sort(x))
    assert tce.KERNEL_LAUNCHES == before


def test_engine_carries_what_the_kernel_takes_and_gathers_the_rest():
    n = 100
    arrays = [torch.zeros(n, dtype=dt) for dt in
              (torch.int32, torch.uint8, torch.float64, torch.int16)]
    arrays += [torch.zeros((n, 3), dtype=torch.float32),  # 12-byte rows
               torch.zeros((n, 4), dtype=torch.uint32),
               torch.zeros(n, dtype=torch.bool)]
    assert tce.carried(arrays, n) == [0, 1, 2, 3]
    assert tce.carried(arrays[4:], n) == [1, 2]
    assert tce.carried([arrays[4]], n) == []


def test_rank_scatter_refuses_what_it_does_not_take():
    bits = torch.zeros(2048, dtype=torch.int32)
    base = torch.zeros((1, 1, 256), dtype=torch.int32)
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
        tce.rank_scatter(bits, 0, 8, base[:, :, :128], 2048, torch.int32)
    with pytest.raises(ValueError):  # base without its rows axis
        tce.rank_scatter(bits, 0, 8, base[0], 2048, torch.int32)
    with pytest.raises(ValueError):  # base of the wrong dtype
        tce.rank_scatter(bits, 0, 8, base.long(), 2048, torch.int32)
    with pytest.raises(ValueError):  # the window past the word
        tce.rank_scatter(bits, 28, 8, base, 2048, torch.int32)
    ok = torch.zeros(2048, dtype=torch.int32)
    for bad, what in [([ok] * 5, "at most 4"),
                      ([torch.zeros((2048, 3))], "12 bytes"),
                      ([torch.zeros(2047, dtype=torch.int32)], "2048 rows"),
                      ([torch.zeros((4, 2048)).t()], "contiguous"),
                      ([torch.zeros((2048, 8), dtype=torch.int32)],
                       "32 bytes")]:
        with pytest.raises(ValueError, match=what):
            tce.rank_scatter(bits, 0, 8, base, 2048, torch.int32,
                             payloads=bad)
