"""The hand-written CUDA kernels on the card (the bitonic sweep, the digit
histogram and the two probes): against their plain PyTorch versions,
through the public entry points (the bitonic and the portable engines, a
donated sort, the partition front-end, the distributed sort on a one-rank
NCCL group with both index widths and donated, ``utils.time_fn``), and
their input checks. Marked ``cuda``; each test skips where
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
from tinyhipradixsort_torch.ops import bitonic_engine as tbe
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


@pytest.mark.parametrize("method", ["counting", "argsort", "lsd_argsort"])
def test_portable_engines_on_the_card(cuda, method):
    rng = np.random.default_rng(12)
    for dtype in (np.uint32, np.float32, np.float64, np.int64):
        x = _rand_keys(rng, dtype, 100_003)
        vals = rng.integers(0, 2**32, size=(100_003, 4), dtype=np.uint32)
        before = th.KERNEL_LAUNCHES
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


@pytest.mark.parametrize("m,rounds", [(1, 5), (4096, 2048), (16384, 3)])
def test_gather_floor_kernel_matches_plain_version(cuda, m, rounds):
    idx, src = tgf.make_tables(m, seed=m)
    before = tgf.KERNEL_LAUNCHES
    got = tgf.gather_checksum(idx, src, rounds)
    assert tgf.KERNEL_LAUNCHES == before + 1
    assert torch.equal(got, tgf.gather_checksum_reference(idx, src, rounds))


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
    # partition_min_n), bit-exact against the direct network and numpy
    n = 1 << 24
    gen = torch.Generator(device=cuda)
    gen.manual_seed(24)
    keys = torch.randint(-2**31, 2**31, (n,), generator=gen, device=cuda,
                         dtype=torch.int64).to(torch.int32).view(torch.uint32)
    vals = torch.arange(n, dtype=torch.int32, device=cuda)
    direct = tthrs.sort_pairs(keys, vals)
    routes = []
    monkeypatch.setattr(tbe, "MARK", lambda event, name, words: routes.append(
        name) if event == "route" else None)
    monkeypatch.setenv("THRS_PARTITION_BITS", "8")
    before = tbe.KERNEL_LAUNCHES
    k, v = tthrs.sort_pairs(keys, vals)
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
