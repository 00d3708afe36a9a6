"""The hand-written CUDA kernels on the card (the bitonic sweep, the digit
histogram with and without run sums, the counting engine's bucket scan on
both its routes and rank-and-scatter with its payloads, and the two
probes):
against their plain PyTorch versions,
through the public entry points (the bitonic and the portable engines,
the engine ``"auto"`` picks on each side of ``sort.AUTO_COUNTING_MIN_N``
and what it records, a donated sort, the partition front-end, the distributed sort on a one-rank
NCCL group with both index widths and donated, ``utils.time_fn``), their
input checks, and the recorder's launch spans against the kernels' own
counters. Marked ``cuda``; each test skips where
``torch.cuda.is_available()`` is false.

On a machine with an NVIDIA Hopper GPU:
``python -m pytest tests/test_torch_cuda.py -m cuda -q``

The file imports nothing from ``tests``, so it also runs where another
package named ``tests`` is installed.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import tinyhipradixsort_torch as tthrs
from tinyhipradixsort_torch import sort as tsort
from tinyhipradixsort_torch import tracing
from tinyhipradixsort_torch.ops import bitonic_engine as tbe
from tinyhipradixsort_torch.ops import counting_engine as tce
from tinyhipradixsort_torch.ops import histogram as th
from tinyhipradixsort_torch.parallel import multihost
from tinyhipradixsort_torch.tools import gather_floor as tgf
from tinyhipradixsort_torch.tools import partition_dma_floor as tpd

pytestmark = pytest.mark.cuda


def _oracle_perm(x, descending):
    return np.argsort(tthrs.np_key_bits(x, descending=descending),
                      kind="stable")


def _bits(a):
    if isinstance(a, torch.Tensor):
        a = a.cpu()
        a = a.view({4: torch.int32, 8: torch.int64}[a.dtype.itemsize]).numpy()
    return a.view({4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


def _rand_keys(rng, dtype, n):
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        x = rng.standard_normal(n).astype(dtype)
        x[rng.random(n) < 0.05] = -0.0
        x[rng.random(n) < 0.05] = np.nan
        return x
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, size=n, dtype=dtype,
                        endpoint=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check_every_sweep(cuda, L, nwords, ncmp, forced,
                       tuning=tbe.EngineTuning()):
    """Every sweep of the main path's plan for 2**L tuples, plus
    ``forced(plan, T)`` forced-ascending ones, through the kernel and through
    the plain version. Word 0 takes 16 values, so tuples tie on it (and,
    with ncmp=1, tie in full while their carries differ)."""
    rng = np.random.default_rng(nwords * 100 + ncmp)
    words = [rng.integers(0, 16, size=1 << L, dtype=np.uint32)]
    words += [rng.integers(0, 2**32, size=1 << L, dtype=np.uint32)
              for _ in range(nwords - 1)]
    T = tbe._tile_bits_for(nwords, L, tuning)
    sweeps = tbe.plan_sweeps(L, T, T, g_max_cross=tuning.cross_g_max)
    sweeps += forced(sweeps, T)
    for sweep in sweeps:
        dev = [torch.from_numpy(w).view(torch.int32).to(cuda) for w in words]
        before = tbe.KERNEL_LAUNCHES
        got = tbe.run_sweep([w.clone() for w in dev], sweep, ncmp)
        assert tbe.KERNEL_LAUNCHES == before + 1
        want = tbe.run_sweep_reference(dev, sweep, ncmp)
        for g, w in zip(got, want):
            assert torch.equal(g, w), sweep


# 1-8 words take the register body (one instantiation per word count), 9 and
# more the shared-memory body
@pytest.mark.parametrize("nwords,ncmp", [(1, 1), (2, 2), (3, 1), (3, 3),
                                         (4, 2), (5, 3), (8, 3), (9, 3)])
def test_kernel_matches_plain_version_on_every_sweep(cuda, nwords, ncmp):
    _check_every_sweep(
        cuda, 18, nwords, ncmp,
        lambda sweeps, T: [dataclasses.replace(sweeps[1], forced_asc=T + 1)])


@pytest.mark.parametrize("nwords,ncmp", [(1, 1), (5, 3), (8, 3)])
def test_kernel_matches_plain_version_at_the_smallest_tile(cuda, nwords,
                                                            ncmp):
    # L = 10: one local sweep of a 2**10 tile, the fewest threads a block has
    _check_every_sweep(
        cuda, 10, nwords, ncmp,
        lambda sweeps, T: [dataclasses.replace(sweeps[0], forced_asc=4)])


def test_register_body_takes_seven_words_at_the_largest_budget(cuda):
    # the largest budget gives 7-word tuples the register body's largest
    # tile (2**12); a 2**13 tile would need 1024 threads, and the kernel
    # refuses it rather than send 7 words to the shared-memory body
    tuning = tbe.EngineTuning(smem_tile_bytes=tbe.SMEM_MAX_BYTES)
    _check_every_sweep(
        cuda, 16, 7, 3,
        lambda sweeps, T: [dataclasses.replace(sweeps[1], forced_asc=T + 1)],
        tuning)
    sweep = tbe.plan_sweeps(13, 13, 13)[0]
    words = [torch.zeros(1 << 13, dtype=torch.int32, device=cuda)
             for _ in range(7)]
    with pytest.raises(RuntimeError):
        tbe.run_sweep(words, sweep, 1)


def test_wide_tuples_run_and_too_wide_ones_are_refused(cuda):
    rng = np.random.default_rng(20)
    n = 5000
    cmp = [torch.from_numpy(rng.integers(0, 8, size=n, dtype=np.int32)),
           torch.arange(n, dtype=torch.int32)]
    carry = [torch.from_numpy(rng.integers(-2**31, 2**31, size=n,
                                           dtype=np.int32)) for _ in range(18)]
    want = tbe.sort_words(cmp, carry)
    before = tbe.KERNEL_LAUNCHES
    got = tbe.sort_words([w.to(cuda) for w in cmp], [w.to(cuda) for w in carry])
    assert tbe.KERNEL_LAUNCHES > before
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(g.cpu(), w)
    sweep = tbe.plan_sweeps(10, 10, 10)[0]
    words = [torch.zeros(1024, dtype=torch.int32, device=cuda)
             for _ in range(tbe.MAX_WORDS + 1)]
    with pytest.raises(ValueError):
        tbe.run_sweep(words, sweep, 1)


@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32,
                                   np.uint64, np.int64, np.float64],
                         ids=lambda d: np.dtype(d).name)
def test_sorts_on_the_card_match_the_oracle(cuda, dtype):
    rng = np.random.default_rng(11)
    for n in (1000, 1 << 17):
        x = _rand_keys(rng, dtype, n)
        vals = rng.integers(0, 2**32, size=n, dtype=np.uint32)
        xd = torch.from_numpy(x).to(cuda)
        before = tbe.KERNEL_LAUNCHES
        for desc in (False, True):
            order = "descending" if desc else "ascending"
            perm = _oracle_perm(x, desc)
            k, v = tthrs.sort_pairs(xd, torch.from_numpy(vals).to(cuda),
                                    order=order)
            assert k.is_cuda and v.is_cuda
            np.testing.assert_array_equal(_bits(k), _bits(x[perm]))
            np.testing.assert_array_equal(v.cpu().numpy(), vals[perm])
            np.testing.assert_array_equal(
                tthrs.sort_indices(xd, order=order).cpu().numpy(), perm)
        assert tbe.KERNEL_LAUNCHES > before
        np.testing.assert_array_equal(_bits(xd), _bits(x))


@pytest.mark.parametrize("nwords,ncmp,B,r", [
    (1, 1, 3, 10), (3, 2, 20, 7), (5, 3, 6, 14), (2, 2, 70, 5)])
def test_kernel_matches_plain_version_on_row_networks(cuda, nwords, ncmp, B,
                                                      r):
    # the row paths' shapes: stages 1..r (a row sort) and stage r alone (a
    # row merge), stage r forced ascending, on b_pad * 2**r words, which is
    # no power of two; the block count comes from the word length
    rng = np.random.default_rng(B * 100 + r)
    tuning = tbe.EngineTuning()
    T, b_pad = tbe._row_plan(B, r, nwords, tuning)
    n = b_pad << r
    assert n & (n - 1)
    words = [rng.integers(0, 16, size=n, dtype=np.uint32)]
    words += [rng.integers(0, 2**32, size=n, dtype=np.uint32)
              for _ in range(nwords - 1)]
    dev = [torch.from_numpy(w).view(torch.int32).to(cuda) for w in words]
    for stages in (range(1, r + 1), [r]):
        before = tbe.KERNEL_LAUNCHES
        got = tbe._run_network([w.clone() for w in dev], ncmp, max(T, r),
                               tuning, stages=stages, forced_asc=r,
                               tile_bits=T)
        assert tbe.KERNEL_LAUNCHES > before
        want = [w.clone() for w in dev]
        for sweep in tbe.plan_sweeps(max(T, r), T, T, stages, r,
                                     g_max_cross=tuning.cross_g_max):
            want = tbe.run_sweep_reference(want, sweep, ncmp)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (stages, T, b_pad)


BITONIC = "bitonic"  # named: "auto" is argsort on CPU tensors


def test_new_bitonic_paths_on_the_card(cuda, monkeypatch):
    # the paths of the segmented route, the rows, segment_ids=, 16-bit keys
    # and stable=False, each against the same call on CPU tensors (the
    # plain version) and each launching the kernel
    rng = np.random.default_rng(21)
    x = rng.integers(0, 2**32, size=150_001, dtype=np.uint32)
    rows = rng.integers(0, 2**32, size=(64, 1040), dtype=np.uint32)
    raw = rng.integers(0, 2**16, size=70_000, dtype=np.uint16)
    seg = np.sort(rng.integers(0, 100, size=150_001)).astype(np.int32)
    pay = rng.integers(0, 2**32, size=150_001, dtype=np.uint32)
    calls = [
        ("segmented keys", lambda d: tthrs.sort_keys(d(x), method=BITONIC)),
        ("segmented pairs", lambda d: tthrs.sort_pairs(d(x), d(pay),
                                                       method=BITONIC)),
        ("rows 64x1040", lambda d: tthrs.sort_pairs(d(rows), d(rows),
                                                    method=BITONIC)),
        ("rows 64x1024", lambda d: tthrs.sort_keys(d(rows[:, :1024]),
                                                   method=BITONIC)),
        ("segment_ids", lambda d: tthrs.sort_indices(
            d(x), segment_ids=d(seg), method=BITONIC)),
        ("f16", lambda d: tthrs.sort_keys(d(raw.view(np.int16))
                                          .view(torch.float16),
                                          method=BITONIC)),
        ("bf16 pairs", lambda d: tthrs.sort_pairs(
            d(raw.view(np.int16)).view(torch.bfloat16), d(raw),
            method=BITONIC)),
    ]
    for label, fn in calls:
        before = tbe.KERNEL_LAUNCHES
        got = fn(lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda))
        assert tbe.KERNEL_LAUNCHES > before, label
        want = fn(lambda a: torch.from_numpy(np.ascontiguousarray(a)))
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert g.is_cuda, label
            signed = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
                g.dtype.itemsize]
            assert torch.equal(g.cpu().view(signed), w.view(signed)), label
    # the row-segmented route, with its batch floor lowered to this batch
    monkeypatch.setattr(tbe, "_ROW_SEG_MIN_PADDED", 0)
    words = torch.from_numpy(rows.view(np.int32)).reshape(-1)
    before = tbe.KERNEL_LAUNCHES
    (got,), _ = tbe.sort_words_rows([words.to(cuda)], [], (64, 1040))
    assert tbe.KERNEL_LAUNCHES > before
    (want,), _ = tbe.sort_words_rows([words], [], (64, 1040))
    assert torch.equal(got.cpu(), want)
    # stable=False at a power of two: keys sorted, values a permutation
    keys = x[:1 << 16] % 97
    k, v = tthrs.sort_pairs(torch.from_numpy(keys).to(cuda),
                            torch.arange(1 << 16, device=cuda), stable=False)
    np.testing.assert_array_equal(_bits(k), np.sort(keys))
    perm = v.cpu().numpy()
    np.testing.assert_array_equal(keys[perm], np.sort(keys))
    np.testing.assert_array_equal(np.sort(perm), np.arange(1 << 16))


def test_kernel_refuses_what_it_does_not_take(cuda):
    sweep = tbe.plan_sweeps(10, 10, 10)[0]
    good = torch.zeros(1024, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        tbe.run_sweep([good.to(torch.int64)], sweep, 1)
    with pytest.raises(ValueError):
        tbe.run_sweep([torch.zeros(2048, dtype=torch.int32,
                                   device=cuda)[::2]], sweep, 1)
    with pytest.raises(ValueError):
        tbe.run_sweep([good, good.cpu()], sweep, 1)
    with pytest.raises(ValueError):
        tbe.run_sweep([good], sweep, 2)


@pytest.mark.parametrize("n,wide,shift,width,tile", [
    (1 << 20, False, 0, 8, 8192), (1 << 20, False, 24, 8, 2048),
    (1 << 20, False, 31, 1, 8192), (1 << 20, False, 30, 2, 3000),
    (1000003, False, 4, 5, 1024), (5 << 20, False, 8, 8, 1 << 22),
    (1 << 20, False, 0, 14, 8192), (1 << 20, True, 40, 8, 8192),
    (0, False, 0, 8, 8192), (777, True, 60, 4, 1024)])
def test_histogram_kernel_matches_plain_version(cuda, n, wide, shift, width,
                                                tile):
    rng = np.random.default_rng(n + shift)
    x = rng.integers(0, 2**64 if wide else 2**32, size=n,
                     dtype=np.uint64 if wide else np.uint32)
    bits = torch.from_numpy(x.view(np.int64 if wide else np.int32)).to(cuda)
    before = th.KERNEL_LAUNCHES
    got = th.digit_histogram(bits, shift, width, tile)
    assert th.KERNEL_LAUNCHES == before + 1 and got.is_cuda
    want = th.digit_histogram_reference(bits, shift, width, tile)
    assert torch.equal(got, want)


def test_histogram_kernel_refuses_what_it_does_not_take(cuda):
    with pytest.raises(TypeError):
        th.digit_histogram(torch.zeros(64, device=cuda), 0, 8)
    with pytest.raises(ValueError):
        th.digit_histogram(torch.zeros(64, dtype=torch.int32, device=cuda),
                           30, 8)


@pytest.mark.parametrize("n,wide,shift,width,tile,R", [
    (1 << 22, False, 0, 8, 2048, 1),            # runs of 128 tiles
    (3 * 300 * 2048, False, 5, 1, 2048, 3),     # short last runs
    (3 * 300 * 2048, False, 5, 2, 2048, 3),
    (3 * 300 * 2048, False, 5, 3, 2048, 3),
    (3 * 300 * 2048, False, 5, 4, 2048, 3),
    (3 * 300 * 2048, False, 5, 5, 2048, 3),
    (3 * 300 * 2048, False, 5, 6, 2048, 3),
    (3 * 300 * 2048, False, 5, 7, 2048, 3),
    (3 * 300 * 2048, True, 40, 8, 2048, 3),     # u64 bits
    (2 * 127 * 2048, False, 8, 8, 2048, 2),     # around the run of 128
    (2 * 128 * 2048, False, 8, 8, 2048, 2),
    (2 * 129 * 2048, False, 8, 8, 2048, 2),
    ((1 << 20) + 777, False, 0, 8, 2048, 1),    # ragged n
    ((1 << 20) + 777, True, 60, 4, 1024, 1),
    (4096 * 4096, False, 0, 8, 2048, 4096),     # rows of one run
    (3000 * 3072, False, 16, 8, 3072, 3),       # parts straddle tiles
    ((1 << 22) + 3, False, 0, 8, 20480, 1),     # tiles split between CTAs
    (1 << 23, False, 24, 8, 65536, 2),
    (1 << 24, True, 3, 8, 1 << 22, 2),
    ((1 << 22) + 5, False, 0, 5, 1 << 22, 1),
    (0, False, 0, 8, 2048, 1)])
def test_histogram_runs_kernel_matches_plain_version(cuda, n, wide, shift,
                                                     width, tile, R):
    rng = np.random.default_rng([n, shift, width, tile])
    x = rng.integers(0, 2**64 if wide else 2**32, size=n,
                     dtype=np.uint64 if wide else np.uint32)
    bits = torch.from_numpy(x.view(np.int64 if wide else np.int32)).to(cuda)
    T = max(-(-n // th.round_tile(tile)), 1)
    before = th.RUN_LAUNCHES
    counts, sums = th.digit_histogram_runs(bits, shift, width, tile, T // R)
    assert th.RUN_LAUNCHES == before + 1 and counts.is_cuda and sums.is_cuda
    want_c, want_s = th.digit_histogram_runs_reference(bits, shift, width,
                                                       tile, T // R)
    assert torch.equal(counts, want_c) and torch.equal(sums, want_s)


def test_histogram_runs_kernel_on_one_bucket(cuda):
    bits = torch.full((300 * 2048,), 0x1234, dtype=torch.int32, device=cuda)
    counts, sums = th.digit_histogram_runs(bits, 4, 8, 2048, 300)
    want_c, want_s = th.digit_histogram_runs_reference(bits, 4, 8, 2048, 300)
    assert torch.equal(counts, want_c) and torch.equal(sums, want_s)
    assert int(sums[0, :, 0x23].sum()) == 300 * 2048


def _tile_counts(rng, R, Tr, width, tile, kind):
    """(R, Tr, 2**width) int32 counts whose tiles each sum to ``tile``:
    random cut points, or every element in one bucket."""
    nb = 1 << width
    if kind == "one":
        counts = np.zeros((R, Tr, nb), np.int32)
        counts[:, :, nb // 3] = tile
        return counts
    cuts = np.sort(rng.integers(0, tile, size=(R, Tr, nb - 1),
                                endpoint=True), axis=-1)
    edges = np.concatenate([np.zeros((R, Tr, 1), np.int64), cuts,
                            np.full((R, Tr, 1), tile)], axis=-1)
    return np.diff(edges, axis=-1).astype(np.int32)


def _check_scan(cuda, R, Tr, width, tile, idx_dt, kind):
    counts = torch.from_numpy(_tile_counts(
        np.random.default_rng([R, Tr, width, tile]), R, Tr, width, tile,
        kind)).to(cuda)
    before = th.SCAN_LAUNCHES
    got = th.bucket_offsets(counts, tile, idx_dt)
    assert th.SCAN_LAUNCHES == before + 1 and got.is_cuda
    want = th.bucket_offsets_reference(counts, tile, idx_dt)
    assert got.dtype == idx_dt and tuple(got.shape) == (R, Tr, 1 << width)
    # contiguous as it is written: rank_scatter's .contiguous() copies nothing
    assert got.is_contiguous() and got.contiguous().data_ptr() == \
        got.data_ptr()
    assert torch.equal(got, want)


@pytest.mark.parametrize("R", [1, 3, 64])
@pytest.mark.parametrize("tile", [1024, 2048, 2176])
@pytest.mark.parametrize("width", range(1, 9))
def test_bucket_scan_kernel_matches_plain_version(cuda, width, tile, R):
    # rows of 1030, 300 and 130 tiles: several chunks of 128 tiles, the
    # last one short
    Tr = {1: 1030, 3: 300, 64: 130}[R]
    _check_scan(cuda, R, Tr, width, tile, torch.int32, "random")


@pytest.mark.parametrize("R,Tr,width,idx_dt,kind", [
    (1, 1030, 8, torch.int64, "random"),
    (2, 127, 8, torch.int32, "random"),  # a row is one chunk (128 tiles)
    (2, 128, 8, torch.int64, "random"),
    (2, 129, 8, torch.int32, "random"),  # just above: a chunk of 1 tile
    (5, 257, 3, torch.int64, "random"),
    (64, 2, 8, torch.int32, "random"),
    (1, 1, 1, torch.int32, "random"),
    (3, 300, 8, torch.int64, "one"),     # one bucket; the others all zero
    (3, 5, 8, torch.int32, "one"),
    (1, 1 << 17, 8, torch.int32, "random"),  # 2**28 keys at tile 2048
])
def test_bucket_scan_kernel_on_chunk_edges_and_skew(cuda, R, Tr, width,
                                                    idx_dt, kind):
    _check_scan(cuda, R, Tr, width, 2048, idx_dt, kind)


@pytest.mark.parametrize("R,Tr,width,tile,idx_dt,kind", [
    (1, 1030, 8, 2048, torch.int32, "random"),
    (1, 1030, 8, 2048, torch.int64, "random"),
    (3, 300, 1, 2048, torch.int32, "random"),
    (3, 300, 3, 1024, torch.int64, "random"),
    (3, 300, 5, 2176, torch.int32, "random"),
    (64, 130, 8, 2048, torch.int32, "random"),
    (2, 127, 8, 2048, torch.int32, "random"),   # a row is one run
    (2, 128, 8, 2048, torch.int64, "random"),
    (2, 129, 8, 2048, torch.int32, "random"),   # a run of 1 tile
    (5, 7, 8, 1 << 17, torch.int64, "random"),  # runs of 2 tiles
    (3, 300, 8, 2048, torch.int64, "one"),
    (1, 1 << 17, 8, 2048, torch.int32, "random"),  # 2**28 keys
])
def test_bucket_scan_kernel_takes_run_sums(cuda, R, Tr, width, tile, idx_dt,
                                           kind):
    counts = torch.from_numpy(_tile_counts(
        np.random.default_rng([R, Tr, width, tile, 5]), R, Tr, width, tile,
        kind)).to(cuda)
    sums = th.run_sums_reference(counts, tile)
    before = (th.SCAN_LAUNCHES, th.SCAN_SUM_WALKS)
    got = th.bucket_offsets(counts, tile, idx_dt, run_sums=sums)
    # the counts read once: no summing walk
    assert (th.SCAN_LAUNCHES, th.SCAN_SUM_WALKS) == (before[0] + 1,
                                                     before[1])
    want = th.bucket_offsets_reference(counts, tile, idx_dt)
    assert got.dtype == idx_dt and got.is_contiguous()
    assert torch.equal(got, want)
    # the summing route, on the same counts
    got = th.bucket_offsets(counts, tile, idx_dt)
    assert th.SCAN_SUM_WALKS == before[1] + (Tr > th.run_tiles(Tr, tile))
    assert torch.equal(got, want)


def test_bucket_scan_kernel_refuses_run_sums_it_does_not_take(cuda):
    counts = torch.zeros((1, 300, 256), dtype=torch.int32, device=cuda)
    sums = th.run_sums_reference(counts, 2048)
    before = th.SCAN_LAUNCHES
    for bad in (sums[:, :2], sums.to(torch.int32), sums.cpu()):
        with pytest.raises(ValueError):
            th.bucket_offsets(counts, 2048, torch.int32, run_sums=bad)
    assert th.SCAN_LAUNCHES == before


def test_bucket_scan_kernel_refuses_what_it_does_not_take(cuda):
    before = th.SCAN_LAUNCHES
    with pytest.raises(ValueError, match="width 1-8"):
        th.bucket_offsets(torch.zeros((1, 2, 512), dtype=torch.int32,
                                      device=cuda), 2048, torch.int32)
    with pytest.raises(TypeError):
        th.bucket_offsets(torch.zeros((1, 2, 256), dtype=torch.int64,
                                      device=cuda), 2048, torch.int32)
    with pytest.raises(ValueError, match="contiguous"):
        th.bucket_offsets(torch.zeros((1, 256, 2), dtype=torch.int32,
                                      device=cuda).transpose(1, 2), 2048,
                          torch.int32)
    assert th.SCAN_LAUNCHES == before


@pytest.mark.parametrize("shape", [(300_000,), (3, 100_000)],
                         ids=["one-row", "batched"])
def test_counting_engine_scans_on_the_card(cuda, shape, monkeypatch):
    # every pass takes its offsets from the kernel; nothing calls cumsum
    def no_cumsum(*args, **kwargs):
        raise AssertionError("torch.cumsum on the counting path")

    rng = np.random.default_rng(len(shape))
    x = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    v = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    xd, vd = torch.from_numpy(x).to(cuda), torch.from_numpy(v).to(cuda)
    monkeypatch.setattr(torch, "cumsum", no_cumsum)
    before = th.SCAN_LAUNCHES
    k, got_v = tthrs.sort_pairs(xd, vd, method="counting")
    assert th.SCAN_LAUNCHES == before + 4  # four 8-bit passes
    perm = np.argsort(x, axis=-1, kind="stable")
    np.testing.assert_array_equal(k.cpu().numpy(),
                                  np.take_along_axis(x, perm, -1))
    np.testing.assert_array_equal(got_v.cpu().numpy(),
                                  np.take_along_axis(v, perm, -1))


@pytest.mark.parametrize("shape,runs", [((300_000,), 4),
                                        ((3, 300_000), 4),
                                        ((3, 100_000), 0)],
                         ids=["one-row", "batched", "rows-of-one-run"])
def test_counting_engine_reads_the_counts_once_on_the_card(cuda, shape,
                                                           runs):
    # rows of 147 tiles hold two runs: every pass launches the run-sum
    # histogram and a scan with no summing walk; rows of 49 tiles (one
    # run) take the plain histogram and the scan's one kernel
    rng = np.random.default_rng([len(shape), 7])
    x = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    before = (th.RUN_LAUNCHES, th.SCAN_LAUNCHES, th.SCAN_SUM_WALKS)
    got = tthrs.sort_keys(torch.from_numpy(x).to(cuda), method="counting")
    assert (th.RUN_LAUNCHES, th.SCAN_LAUNCHES, th.SCAN_SUM_WALKS) == (
        before[0] + runs, before[1] + 4, before[2])
    np.testing.assert_array_equal(got.cpu().numpy(), np.sort(x, axis=-1))


@pytest.mark.parametrize("method", ["counting", "bitonic"])
def test_launch_spans_count_what_the_kernels_count(cuda, method):
    # 2**20 keys through counting: 512 tiles, rows of four runs, so each
    # of the 4 passes launches the run-sum histogram, the scan and
    # rank-and-scatter once
    rng = np.random.default_rng(20)
    x = torch.from_numpy(rng.integers(0, 2**32, size=1 << 20,
                                      dtype=np.uint32)).to(cuda)
    tthrs.sort_keys(x, method=method)  # the kernels' builds
    counters = (lambda: th.RUN_LAUNCHES, lambda: th.SCAN_LAUNCHES,
                lambda: tce.KERNEL_LAUNCHES, lambda: tbe.KERNEL_LAUNCHES,
                lambda: th.KERNEL_LAUNCHES)
    before = [c() for c in counters]
    with tracing.record() as rec:
        got = tthrs.sort_keys(x, method=method)
    deltas = [c() - b for c, b in zip(counters, before)]
    names = [s.name for s in rec.spans]
    launches = [names.count(f"launch.{k}") for k in (
        "digit_histogram_runs", "bucket_scan", "rank_scatter",
        "bitonic_sweep")]
    assert launches == deltas[:4]
    assert names.count("launch.digit_histogram") == deltas[4] - deltas[0]
    if method == "counting":
        assert launches == [4, 4, 4, 0]
    else:
        assert launches[:3] == [0, 0, 0] and launches[3] > 0
    assert rec.counts == {(1, "launches"): sum(launches)}
    assert [s.name for s in rec.spans
            if s.parent is None and s.name != "gc"] == ["sort_keys"]
    assert tracing.split(rec.spans)[1]["kernels"] > 0
    assert set(rec.memory) == set(tracing.MEMORY_STATS)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  np.sort(x.cpu().numpy()))


def _stage2(bits, shift, width, tile, R, idx_dt):
    """The counting engine's stage 2 for R rows of whole tiles by the plain
    versions (histogram and bucket scan)."""
    counts = th.digit_histogram_reference(bits, shift, width, tile)
    return th.bucket_offsets_reference(
        counts.view(R, counts.shape[0] // R, counts.shape[1]), tile, idx_dt)


@pytest.mark.parametrize("n,wide,shift,width,tile,R,idx_dt,kind", [
    (4096, False, 0, 8, 1024, 1, torch.int32, "random"),
    (3 * 4096, False, 24, 8, 2048, 3, torch.int32, "random"),
    (3 * 6144, False, 29, 3, 3072, 3, torch.int32, "random"),
    (4096, True, 0, 8, 2048, 1, torch.int64, "random"),
    (3 * 6144, True, 56, 8, 3072, 3, torch.int64, "random"),
    (3 * 4096, True, 61, 3, 1024, 3, torch.int32, "random"),
    (1 << 20, False, 8, 8, 2048, 1, torch.int64, "random"),
    (8 * 5 << 18, False, 16, 8, 5 << 18, 8, torch.int32, "random"),
    (1 << 24, False, 0, 8, 2048, 1, torch.int32, "random"),
    (1 << 22, True, 40, 8, 2048, 1, torch.int32, "random"),
    (1 << 20, False, 0, 1, 2048, 1, torch.int32, "random"),
    (1 << 20, False, 0, 8, 2048, 1, torch.int32, "one"),
    (4 * 3 * 12288, True, 56, 8, 12288, 4, torch.int32, "two"),
    (1 << 20, False, 24, 8, 2048, 2, torch.int32, "padded")])
def test_rank_scatter_kernel_matches_plain_version(cuda, n, wide, shift,
                                                   width, tile, R, idx_dt,
                                                   kind):
    rng = np.random.default_rng(n + shift + width)
    udt = np.uint64 if wide else np.uint32
    top = np.iinfo(udt).max
    x = rng.integers(0, top, size=n, dtype=udt, endpoint=True)
    if kind == "one":
        x[:] = x[0]
    elif kind == "two":
        x = np.where(rng.random(n) < 0.5, x[0], ~x[0])
    elif kind == "padded":
        x.reshape(R, -1)[:, -(tile // 2 + 17):] = top
    bits = torch.from_numpy(x.view(np.int64 if wide else np.int32)).to(cuda)
    base = _stage2(bits, shift, width, tile, R, idx_dt)
    before = tce.KERNEL_LAUNCHES
    got_bits, got_src, moved = tce.rank_scatter(bits, shift, width, base,
                                                tile, idx_dt)
    assert tce.KERNEL_LAUNCHES == before + 1 and got_src.is_cuda
    want_bits, want_src, _ = tce.rank_scatter_reference(bits, shift, width,
                                                        base, tile, idx_dt)
    assert got_src.dtype == idx_dt and moved == []
    assert torch.equal(got_src, want_src)
    assert torch.equal(got_bits, want_bits)


def _payloads(rng, n, row_bytes, device):
    """One payload per entry of row_bytes, random, on ``device``: 1-byte
    rows as bool, 16-byte rows as an (n, 4) uint32 leaf."""
    out = []
    for rb in row_bytes:
        if rb == 1:
            a = torch.from_numpy(rng.random(n) < 0.5)
        elif rb == 16:
            a = torch.from_numpy(rng.integers(0, 2**32, size=(n, 4),
                                              dtype=np.uint32))
        else:
            raw = rng.integers(0, 2**63, size=n, dtype=np.int64)
            a = torch.from_numpy(raw.astype({2: np.int16, 4: np.float32,
                                             8: np.int64}[rb]))
        out.append(a.to(device))
    return out


def _check_kernel(cuda, x, shift, width, tile, R, idx_dt, row_bytes,
                  want_src, rng):
    """The kernel against its plain version: bits, src (or None) and every
    payload bit-equal."""
    wide = x.dtype == np.uint64
    bits = torch.from_numpy(x.view(np.int64 if wide else np.int32)).to(cuda)
    base = _stage2(bits, shift, width, tile, R, idx_dt)
    payloads = _payloads(rng, x.shape[0], row_bytes, cuda)
    before = tce.KERNEL_LAUNCHES
    got = tce.rank_scatter(bits, shift, width, base, tile, idx_dt,
                           payloads=payloads, want_src=want_src)
    assert tce.KERNEL_LAUNCHES == before + 1
    want = tce.rank_scatter_reference(bits, shift, width, base, tile, idx_dt,
                                      payloads=payloads, want_src=want_src)
    assert torch.equal(got[0], want[0])
    if want_src:
        assert got[1].dtype == idx_dt and torch.equal(got[1], want[1])
    else:
        assert got[1] is None
    assert len(got[2]) == len(payloads)
    for g, w in zip(got[2], want[2]):
        assert g.dtype == w.dtype and g.shape == w.shape and g.is_cuda
        assert torch.equal(g, w)


@pytest.mark.parametrize("want_src", [True, False])
@pytest.mark.parametrize("row_bytes", [1, 2, 4, 8, 16])
def test_rank_scatter_kernel_carries_each_row_size(cuda, row_bytes,
                                                   want_src):
    # 3 rows of 10 tiles of 1024: a chunk holds 8 tiles of one row, so each
    # row ends in a chunk of 2 tiles and no chunk crosses a row
    rng = np.random.default_rng([row_bytes, want_src])
    x = rng.integers(0, 2**32, size=3 * 10 * 1024, dtype=np.uint32)
    _check_kernel(cuda, x, 8, 8, 1024, 3, torch.int32, (row_bytes,) * 2,
                  want_src, rng)


@pytest.mark.parametrize("want_src", [True, False])
@pytest.mark.parametrize("tile", [1024, 2048, 8192, 1 << 22])
def test_rank_scatter_kernel_carries_max_payloads(cuda, tile, want_src):
    rng = np.random.default_rng([tile, want_src])
    R = 2
    n = R * max(3 * tile, 1 << 22)
    x = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    _check_kernel(cuda, x, 16, 8, tile, R, torch.int32, (1, 2, 8, 16),
                  want_src, rng)


@pytest.mark.parametrize("width", range(1, 9))
def test_rank_scatter_kernel_u64_widths_padded_rows(cuda, width):
    # u64 bits take chunks of 4096 words: 4 tiles of 1024, so rows of 5
    # tiles end in a chunk of one tile; each row's tail is all ones, as the
    # engine pads it; int64 src
    rng = np.random.default_rng(width)
    R, tile = 3, 1024
    x = rng.integers(0, 2**64, size=(R, 5 * tile), dtype=np.uint64,
                     endpoint=False)
    x[:, -(tile // 2 + 17):] = np.iinfo(np.uint64).max
    _check_kernel(cuda, x.reshape(-1), 64 - width, width, tile, R,
                  torch.int64, (8, 4), True, rng)


def test_counting_engine_gathers_only_what_it_cannot_carry(cuda):
    rng = np.random.default_rng(21)
    x = rng.integers(0, 2**32, size=300_000, dtype=np.uint32)
    v = rng.integers(0, 2**32, size=300_000, dtype=np.uint32)
    perm = np.argsort(x, kind="stable")
    xd, vd = torch.from_numpy(x).to(cuda), torch.from_numpy(v).to(cuda)
    before = (tce.GATHERED, tce.KERNEL_LAUNCHES)
    k, got_v = tthrs.sort_pairs(xd, vd, method="counting")
    got_k = tthrs.sort_keys(xd, method="counting")
    assert tce.GATHERED == before[0] and tce.KERNEL_LAUNCHES > before[1]
    np.testing.assert_array_equal(k.cpu().numpy(), x[perm])
    np.testing.assert_array_equal(got_k.cpu().numpy(), x[perm])
    np.testing.assert_array_equal(got_v.cpu().numpy(), v[perm])
    # five leaves: the keys come back from the sorted bits, four leaves
    # ride, the fifth is gathered
    leaves = tuple(torch.from_numpy(v + np.uint32(i)).to(cuda)
                   for i in range(5))
    _, out = tthrs.sort_pairs(xd, leaves, method="counting")
    assert tce.GATHERED == before[0] + 4  # one array, four passes
    for i, leaf in enumerate(out):
        np.testing.assert_array_equal(leaf.cpu().numpy(),
                                      (v + np.uint32(i))[perm])


@pytest.mark.parametrize("api,words", [("sort_keys", 0), ("sort_pairs", 1)])
def test_counting_reads_whole_tiles_where_they_lie_on_the_card(cuda, api,
                                                               words):
    # 2**20 keys are whole tiles: the passes read the keys where they lie
    # and carry only the values; slices 4 bytes into their storage are
    # each copied once, to the kernel's 16-byte alignment
    n = 1 << 20
    rng = np.random.default_rng(22)
    x, v = rng.integers(0, 2**32, size=(2, n + 1), dtype=np.uint32)
    xd, vd = torch.from_numpy(x).to(cuda), torch.from_numpy(v).to(cuda)
    for lo in (0, 1):
        args = (xd[lo:lo + n], vd[lo:lo + n])[:1 + words]
        before = [a.view(torch.int32).clone() for a in args]
        with tracing.record() as rec:
            got = getattr(tthrs, api)(*args, method="counting")
        got = got if isinstance(got, tuple) else (got,)
        spans = [s for s in rec.spans if s.name == "launch.rank_scatter"]
        assert [s.attrs["words"] for s in spans] == [words] * 4
        assert rec.counts.get((1, "counting.pad_copies"), 0) == lo * (
            1 + words)
        perm = np.argsort(x[lo:lo + n], kind="stable")
        np.testing.assert_array_equal(got[0].cpu().numpy(), x[lo:lo + n][perm])
        if words:
            np.testing.assert_array_equal(got[1].cpu().numpy(),
                                          v[lo:lo + n][perm])
        for a, b in zip(args, before):
            assert torch.equal(a.view(torch.int32), b)
            for out in got:
                assert (out.untyped_storage().data_ptr()
                        != a.untyped_storage().data_ptr())


def test_rank_scatter_kernel_refuses_what_it_does_not_take(cuda):
    bits = torch.zeros(4096, dtype=torch.int32, device=cuda)
    before = tce.KERNEL_LAUNCHES
    with pytest.raises(ValueError, match="at most 8 bits"):
        tce.rank_scatter(bits, 0, 9, torch.zeros((1, 2, 512),
                                                 dtype=torch.int32,
                                                 device=cuda),
                         2048, torch.int32)
    with pytest.raises(ValueError):
        tce.rank_scatter(bits, 0, 8, torch.zeros((1, 2, 256),
                                                 dtype=torch.int32),
                         2048, torch.int32)
    with pytest.raises(TypeError):
        tce.rank_scatter(bits.float(), 0, 8,
                         torch.zeros((1, 2, 256), dtype=torch.int32,
                                     device=cuda), 2048, torch.int32)
    base = torch.zeros((1, 2, 256), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="12 bytes"):
        tce.rank_scatter(bits, 0, 8, base, 2048, torch.int32,
                         payloads=[torch.zeros((4096, 3), device=cuda)])
    with pytest.raises(ValueError, match="is on cpu"):
        tce.rank_scatter(bits, 0, 8, base, 2048, torch.int32,
                         payloads=[torch.zeros(4096)])
    with pytest.raises(ValueError, match="multiples of 128"):
        tce.rank_scatter(bits[:4000], 0, 8, base[:, :1], 4000, torch.int32)
    assert tce.KERNEL_LAUNCHES == before


@pytest.mark.parametrize("method", ["counting", "argsort", "lsd_argsort"])
def test_portable_engines_on_the_card(cuda, method):
    rng = np.random.default_rng(12)
    for dtype in (np.uint32, np.float32, np.float64, np.int64):
        x = _rand_keys(rng, dtype, 100_003)
        vals = rng.integers(0, 2**32, size=(100_003, 4), dtype=np.uint32)
        before = th.KERNEL_LAUNCHES
        rs_before = tce.KERNEL_LAUNCHES
        for desc in (False, True):
            order = "descending" if desc else "ascending"
            perm = _oracle_perm(x, desc)
            k, v = tthrs.sort_pairs(torch.from_numpy(x).to(cuda),
                                    torch.from_numpy(vals).to(cuda),
                                    order=order, method=method)
            assert k.is_cuda and v.is_cuda
            np.testing.assert_array_equal(_bits(k), _bits(x[perm]))
            np.testing.assert_array_equal(v.cpu().numpy(), vals[perm])
        assert (th.KERNEL_LAUNCHES > before) == (method == "counting")
        assert (tce.KERNEL_LAUNCHES > rs_before) == (method == "counting")
    rows = rng.integers(0, 2**32, size=(64, 3000), dtype=np.uint32)
    got = tthrs.sort_keys(torch.from_numpy(rows).to(cuda), method=method)
    np.testing.assert_array_equal(got.cpu().numpy(), np.sort(rows, axis=1))
    x = rng.integers(0, 2**32, size=50_000, dtype=np.uint32)
    seg = tthrs.segment_ids_from_offsets(
        torch.tensor([0, 7, 7, 1000, 40_000], device=cuda), 50_000)
    perm = tthrs.sort_indices(torch.from_numpy(x).to(cuda), segment_ids=seg,
                              method=method)
    np.testing.assert_array_equal(perm.cpu().numpy(),
                                  np.lexsort((x, seg.cpu().numpy())))


def test_16bit_keys_on_the_card(cuda):
    rng = np.random.default_rng(16)
    raw = rng.integers(0, 2**16, size=70_000, dtype=np.uint16)
    for tdtype in (torch.float16, torch.bfloat16):
        keys = torch.from_numpy(raw.view(np.int16)).to(cuda).view(tdtype)
        want = torch.from_numpy(raw.view(np.int16)).view(tdtype)
        for method in ("counting", "argsort"):
            got = tthrs.sort_keys(keys, method=method)
            cpu = tthrs.sort_keys(want, method=method)
            assert torch.equal(got.cpu().view(torch.int16),
                               cpu.view(torch.int16))


def test_numpy_inputs_go_to_the_card(cuda):
    x = np.arange(5000, dtype=np.uint32)[::-1].copy()
    for method in ("bitonic", "counting"):
        out = tthrs.sort_keys(x, method=method)
        assert out.is_cuda
        np.testing.assert_array_equal(out.cpu().numpy(), np.sort(x))
    k, v = tthrs.sort_pairs(list(x), np.arange(5000), method="argsort")
    assert k.is_cuda and v.is_cuda
    assert tthrs.segment_ids_from_offsets([0, 10], 20).is_cuda


AUTO_CASES = ["u32 keys", "u32+u32 pairs", "f32 specials", "descending",
              "12-bit window", "sort_indices"]


def _auto_call(case, n, cuda):
    """``call(method)``: the case's sort of n seeded keys by ``method``."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n)
    w = torch.randint(-2**31, 2**31, (n,), generator=gen, device=cuda,
                      dtype=torch.int64).to(torch.int32)
    keys = w.view(torch.uint32)
    if case == "f32 specials":
        # random bits hold NaNs of every payload and denormals; then -0.0,
        # +0.0 and both infinities
        for i, bits in enumerate((-2**31, 0, 0x7F800000, 0xFF800000 - 2**32)):
            w[i::97] = bits
        keys = w.view(torch.float32)
    vals = torch.arange(n, dtype=torch.int32, device=cuda)

    def call(method):
        if case == "u32+u32 pairs":
            return tthrs.sort_pairs(keys, vals, method=method)
        if case == "descending":
            return (tthrs.sort_keys(keys, order="descending", method=method),)
        if case == "12-bit window":
            return tthrs.sort_pairs(keys, vals, start_bit=10, end_bit=22,
                                    method=method)
        if case == "sort_indices":
            return (tthrs.sort_indices(keys, method=method),)
        return (tthrs.sort_keys(keys, method=method),)
    return call


def _same(got, want) -> bool:
    ints = {4: torch.int32, 8: torch.int64}
    return all(torch.equal(g.view(ints[g.element_size()]),
                           w.view(ints[w.element_size()]))
               for g, w in zip(got, want, strict=True))


@pytest.mark.parametrize("case", AUTO_CASES)
def test_auto_sorts_on_counting_from_its_min_n_on_the_card(cuda, case,
                                                           monkeypatch):
    # at AUTO_COUNTING_MIN_N "auto" runs the counting engine, bit-equal to
    # it and to argsort; one key fewer, it runs the network
    routes = []
    monkeypatch.setattr(tbe, "MARK", lambda event, name, words: routes.append(
        name) if event == "route" else None)
    for n, engine in ((tsort.AUTO_COUNTING_MIN_N, "counting"),
                      (tsort.AUTO_COUNTING_MIN_N - 1, "bitonic")):
        call = _auto_call(case, n, cuda)
        routes.clear()
        before = tce.KERNEL_LAUNCHES
        got = call("auto")
        assert (tce.KERNEL_LAUNCHES > before) == (engine == "counting")
        assert bool(routes) == (engine == "bitonic"), routes
        for method in (engine, "argsort"):
            assert _same(got, call(method)), (n, method)


@pytest.mark.parametrize("n,counter", [
    (160_000_000, "auto.counting"),
    (tsort.AUTO_COUNTING_MIN_N - 1, "auto.network")])
def test_auto_records_the_engine_it_chose_on_the_card(cuda, n, counter):
    x = torch.randint(-2**31, 2**31, (n,), device=cuda,
                      dtype=torch.int64).to(torch.int32).view(torch.uint32)
    with tracing.record() as rec:
        tthrs.sort_keys(x)
        tthrs.sort_keys(x, method="bitonic")
    (auto,) = [i for i in rec.instants if i.name == "sort.auto"]
    engine = "counting" if counter == "auto.counting" else "bitonic"
    assert auto.call == 1 and auto.attrs == {"engine": engine, "n": n}
    assert {k: v for k, v in rec.counts.items()
            if k[1].startswith("auto.")} == {(1, counter): 1}


@pytest.mark.parametrize("m,rounds", [
    (1, 5), (4096, 2048), (16384, 3),
    (8, 100), (16, 33),        # m < 32: lanes wrap inside the table
    (4096, 1000),              # rounds not a multiple of 32
    (4096, 1),                 # fewer rounds than blocks
    (4096, 0),                 # no rounds: the checksum is 0
    (4096, 1 << 18),           # the rate shape
    (16384, 4096)])
def test_gather_floor_kernel_matches_plain_version(cuda, m, rounds):
    idx, src = tgf.make_tables(m, seed=m)
    before = tgf.KERNEL_LAUNCHES
    got = tgf.gather_checksum(idx, src, rounds)
    # no rounds launch no kernel: the zeroed word is the checksum
    assert tgf.KERNEL_LAUNCHES == before + (rounds > 0)
    assert torch.equal(got, tgf.gather_checksum_reference(idx, src, rounds))


@pytest.mark.parametrize("rounds", [1000, (1 << 18) + 5])
def test_gather_floor_kernel_on_a_non_permutation(cuda, rounds):
    # repeated indices and words above m: for a permutation the checksum
    # would be rounds * sum(src) (rounds is no multiple of m), so a kernel
    # that relied on idx being one gives itself away here
    m = 4096
    rng = np.random.default_rng(rounds)
    idx_np = rng.integers(0, m, size=m).astype(np.uint32)
    idx_np[:64] += np.uint32(3 << 30)
    assert len(np.unique(idx_np & (m - 1))) < m
    src_np = rng.integers(0, 2**32, size=m, dtype=np.uint32)
    idx = torch.from_numpy(idx_np.view(np.int32)).to(cuda).view(1, m)
    src = torch.from_numpy(src_np.view(np.int32)).to(cuda).view(1, m)
    before = tgf.KERNEL_LAUNCHES
    got = tgf.gather_checksum(idx, src, rounds)
    assert tgf.KERNEL_LAUNCHES == before + 1
    assert torch.equal(got, tgf.gather_checksum_reference(idx, src, rounds))
    as_perm = (rounds * int(src_np.sum(dtype=np.uint64))) & 0xFFFFFFFF
    assert int(got.item()) & 0xFFFFFFFF != as_perm


@pytest.mark.parametrize("r,t", [(1024, 8), (1000, 3), (7, 2)])
def test_partition_scatter_kernel_matches_plain_version(cuda, r, t):
    offs, src = tpd.make_inputs(t, r, seed=r)
    before = tpd.KERNEL_LAUNCHES
    got = tpd.partition_scatter(offs, src, r)
    assert tpd.KERNEL_LAUNCHES == before + 1
    assert torch.equal(got, tpd.partition_scatter_reference(offs, src, r))


def test_a_donated_sort_takes_less_memory(cuda):
    # u32 keys-only at a power of two: the one word is a view of the keys,
    # so the donated network sweeps them in place and allocates no copy
    n = 1 << 26
    gen = torch.Generator(device=cuda)
    gen.manual_seed(26)
    src = torch.randint(-2**31, 2**31, (n,), generator=gen, device=cuda,
                        dtype=torch.int64).to(torch.int32).view(torch.uint32)
    want = torch.sort(src.view(torch.int32) ^ -2**31, stable=True)[0]
    peaks = {}
    for donate in (False, True):
        keys = src.clone()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = tthrs.sort_keys(keys, donate=donate)
        torch.cuda.synchronize()
        peaks[donate] = torch.cuda.max_memory_allocated() - base
        assert (out is keys) == donate
        assert torch.equal(out.view(torch.int32) ^ -2**31, want)
        del keys, out
    assert peaks[True] < peaks[False], peaks
    assert peaks[True] < n, peaks  # below a quarter of the keys' bytes


def test_psort_pairs_on_a_one_rank_nccl_group(cuda, tmp_path):
    rng = np.random.default_rng(20)
    n = 1 << 20
    x = np.minimum(rng.zipf(1.3, size=n), 2**31).astype(np.uint32)
    v = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    multihost.initialize(backend="nccl",
                         init_method=f"file://{tmp_path / 'store'}",
                         world_size=1, rank=0)
    try:
        before = tbe.KERNEL_LAUNCHES
        k, vv, overflow = tthrs.psort_pairs(torch.from_numpy(x).to(cuda),
                                            torch.from_numpy(v).to(cuda),
                                            check=True)
        assert tbe.KERNEL_LAUNCHES > before and not overflow
        perm = tthrs.psort_indices(torch.from_numpy(x).to(cuda))
    finally:
        dist.destroy_process_group()
    p = np.argsort(x, kind="stable")
    assert k.is_cuda and vv.is_cuda
    np.testing.assert_array_equal(_bits(k), x[p])
    np.testing.assert_array_equal(_bits(vv), v[p])
    np.testing.assert_array_equal(perm.cpu().numpy(), p)


def test_scaling_on_a_one_rank_nccl_group(cuda, tmp_path):
    # the weak-scaling harness as phase 13 of chip_smoke.py calls it: the
    # device given as "cuda", timed after an NCCL barrier on the rank's card
    from tinyhipradixsort_torch.benchmarks import scaling

    multihost.initialize(backend="nccl",
                         init_method=f"file://{tmp_path / 'store'}",
                         world_size=1, rank=0)
    lines = []
    try:
        rows = scaling.run(1 << 20, plist=[1], reps=2, dev="cuda",
                           out=lines.append)
    finally:
        dist.destroy_process_group()
    assert [r["devices"] for r in rows] == [1] and len(lines) == 1
    assert rows[0]["weak_scaling_efficiency"] == 1.0
    assert rows[0]["wire"] == {"ring": 1} and rows[0]["seconds"] > 0


def test_partition_route_through_sort_pairs(cuda, monkeypatch):
    # the MSB-partition front-end at 2**24 u32+u32 pairs (its default
    # partition_min_n), bit-exact against the direct network and numpy;
    # "auto" would take counting at this n, so both name the network
    n = 1 << 24
    gen = torch.Generator(device=cuda)
    gen.manual_seed(24)
    keys = torch.randint(-2**31, 2**31, (n,), generator=gen, device=cuda,
                         dtype=torch.int64).to(torch.int32).view(torch.uint32)
    vals = torch.arange(n, dtype=torch.int32, device=cuda)
    direct = tthrs.sort_pairs(keys, vals, method="bitonic")
    routes = []
    monkeypatch.setattr(tbe, "MARK", lambda event, name, words: routes.append(
        name) if event == "route" else None)
    monkeypatch.setenv("THRS_PARTITION_BITS", "8")
    before = tbe.KERNEL_LAUNCHES
    k, v = tthrs.sort_pairs(keys, vals, method="bitonic")
    assert "partition" in routes and tbe.KERNEL_LAUNCHES > before, routes
    assert torch.equal(k, direct[0]) and torch.equal(v, direct[1])
    x = _bits(keys)
    p = np.argsort(x, kind="stable")
    np.testing.assert_array_equal(_bits(k), x[p])
    np.testing.assert_array_equal(v.cpu().numpy(), p)


def test_psort_wide_and_donated_on_a_one_rank_nccl_group(cuda, tmp_path):
    rng = np.random.default_rng(21)
    n = 1 << 22
    x = np.minimum(rng.zipf(1.3, size=n), 2**31).astype(np.uint32)
    p = np.argsort(x, kind="stable")
    multihost.initialize(backend="nccl",
                         init_method=f"file://{tmp_path / 'store'}",
                         world_size=1, rank=0)
    try:
        keys = torch.from_numpy(x).to(cuda)
        wide = tthrs.psort_keys(keys, _force_wide=True)
        perm = tthrs.psort_indices(keys, _force_wide=True)
        peaks = {}
        for donate in (False, True):
            mine = keys.clone()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            out = tthrs.psort_keys(mine, donate=donate)
            torch.cuda.synchronize()
            peaks[donate] = torch.cuda.max_memory_allocated() - base
            assert (out is mine) == donate
            np.testing.assert_array_equal(_bits(out), x[p])
            del mine, out
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(_bits(wide), x[p])
    assert perm.dtype == torch.int64
    np.testing.assert_array_equal(perm.cpu().numpy(), p)
    assert peaks[True] <= peaks[False], peaks


def test_time_fn_on_a_cuda_tensor(cuda):
    from tinyhipradixsort_torch.utils import Stopwatch, time_fn

    x = torch.arange(1 << 24, dtype=torch.int32, device=cuda)
    t, floor = time_fn(lambda a: tthrs.sort_keys(a), x, reps=3)
    assert t > 0 and floor > 0
    sw = Stopwatch().start()
    tthrs.sort_keys(x)
    assert sw.stop() > 0
