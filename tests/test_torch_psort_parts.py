"""Pieces of the port's distributed sort against the JAX package's, with no
process group: the refinement plan, the word-tuple comparison and search,
and the two merges of sorted runs (the port's plain twin against the JAX
Pallas engine, interpreted on the CPU); the local sort's engines and the
rule of ``"auto"`` among them. Comparisons are bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import assert_bits_equal
from tinyhipradixsort_torch import sort as tsort
from tinyhipradixsort_torch.ops import bitonic_engine as tbe
from tinyhipradixsort_torch.parallel import psort as tps
from tinyhipradixsort_tpu.ops import bitonic_engine as jbe
from tinyhipradixsort_tpu.parallel import psort as jps

RNG_SEED = 0x9A27
# interpret-mode tiles of 2**12 keep the JAX merges quick
JAX_TUNING = jbe.EngineTuning(tile_bits_cap=12)


def _torch_words(arrays):
    return [torch.from_numpy(a.astype(np.uint32).view(np.int32).copy())
            for a in arrays]


@pytest.mark.parametrize("P", [1, 2, 3, 8, 64, 256])
def test_refine_plan_matches_jax(P):
    for B in (8, 64, 8192, 100_000, 62_500_000, 1 << 28):
        for s in (1, 8, 32 * P, 256, B):
            assert tps.refine_plan(B, P, s) == jps.refine_plan(B, P, s), \
                (B, P, s)
            assert tps.refine_plan(B, P, s, 4) == jps.refine_plan(B, P, s, 4)


def _tuples(rng, n, ncmp):
    """n tuples of ncmp u32 words: a small value range (ties on every word)
    with all-ones sentinels mixed in."""
    words = [rng.integers(0, 5, size=n).astype(np.uint32) for _ in range(ncmp)]
    for w in words:
        w[rng.random(n) < 0.2] = 0xFFFFFFFF
    return words


@pytest.mark.parametrize("ncmp", [1, 2, 3])
def test_tuple_lt_and_searchsorted_match_jax(ncmp):
    rng = np.random.default_rng(RNG_SEED + ncmp)
    a, b = _tuples(rng, 500, ncmp), _tuples(rng, 500, ncmp)
    want = np.asarray(jps._tuple_lt([jnp.asarray(w) for w in a],
                                    [jnp.asarray(w) for w in b]))
    got = tps._tuple_lt(_torch_words(a), _torch_words(b))
    np.testing.assert_array_equal(got.numpy(), want)
    # sorted tuples (a lexsort, first word most significant); queries of
    # shape (Q,) and (Q, M): copies of sorted tuples (exact ties), fresh
    # ones, and all-sentinel tuples
    for B in (1, 8, 1000):
        srt = _tuples(rng, B, ncmp)
        order = np.lexsort(srt[::-1])
        srt = [w[order] for w in srt]
        for shape in ((40,), (6, 7)):
            q = _tuples(rng, int(np.prod(shape)), ncmp)
            pick = rng.integers(0, B, size=q[0].shape[0])
            copy = rng.random(q[0].shape[0]) < 0.5
            q = [np.where(copy, s[pick], w).reshape(shape)
                 for s, w in zip(srt, q)]
            q[0].reshape(-1)[:3] = 0xFFFFFFFF
            for w in q[1:]:
                w.reshape(-1)[:3] = 0xFFFFFFFF
            want = np.asarray(jps._searchsorted_words(
                [jnp.asarray(w) for w in srt], [jnp.asarray(w) for w in q]))
            got = tps._searchsorted_words(_torch_words(srt), _torch_words(q))
            assert got.shape == shape
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"B={B} shape={shape}")


def _runs(rng, nrows, rowlen, base=0):
    """nrows sentinel-padded sorted runs of (key, index | payload) tuples,
    flat: each row's real prefix is sorted, the rest is fill. Indices are
    distinct, from ``base`` up."""
    key = np.full((nrows, rowlen), 0xFFFFFFFF, np.uint32)
    idx = np.full((nrows, rowlen), 0xFFFFFFFF, np.uint32)
    pay = np.zeros((nrows, rowlen), np.uint32)
    ids = (base + rng.permutation(nrows * rowlen)).astype(np.uint32)
    for r in range(nrows):
        ln = int(rng.integers(0, rowlen + 1))
        k = rng.integers(0, 50, size=ln).astype(np.uint32)
        i = ids[r * rowlen:r * rowlen + ln]
        order = np.lexsort((i, k))
        key[r, :ln], idx[r, :ln] = k[order], i[order]
        pay[r, :ln] = rng.integers(0, 2**32, size=ln, dtype=np.uint32)
    return [key.reshape(-1), idx.reshape(-1)], [pay.reshape(-1)]


@pytest.mark.parametrize("nrows", [2, 3, 5, 8])
def test_merge_runs_tree_matches_jax(nrows):
    # rows of 300 pad to 512; the row merges reach 2**10 and more, where
    # the sweeps run (below it, dense compare-exchange levels)
    rng = np.random.default_rng(RNG_SEED + nrows)
    cmp_w, carry_w = _runs(rng, nrows, 300)
    jc, jk = jps._merge_runs_tree([jnp.asarray(w) for w in cmp_w],
                                  [jnp.asarray(w) for w in carry_w],
                                  nrows, 300, "pallas", tuning=JAX_TUNING)
    tc, tk = tps._merge_runs_tree(_torch_words(cmp_w), _torch_words(carry_w),
                                  nrows, 300)
    for g, w in zip(tc + tk, list(jc) + list(jk)):
        assert_bits_equal(g, np.asarray(w))
    # and against a plain stable sort of the real tuples
    real = cmp_w[1] != 0xFFFFFFFF
    order = np.lexsort((cmp_w[1][real], cmp_w[0][real]))
    m = int(real.sum())
    assert_bits_equal(tc[1][:m], cmp_w[1][real][order])
    assert_bits_equal(tk[0][:m], carry_w[0][real][order])
    assert (tc[0][m:] == -1).all()


@pytest.mark.parametrize("a,b,route", [
    (1500, 1500, "merge-padded"),   # cap-length runs: 3000 pads to 4096
    (2048, 300, "merge-virtual"),   # a power of two, b <= a
    (700, 2500, "merge-padded"),
])
def test_merge_two_runs_matches_jax(monkeypatch, a, b, route):
    rng = np.random.default_rng(RNG_SEED + a + b)
    ra, rb = _runs(rng, 1, a), _runs(rng, 1, b, base=a)
    ja = [jnp.asarray(w) for w in ra[0] + ra[1]]
    jb = [jnp.asarray(w) for w in rb[0] + rb[1]]
    want = jps._merge_two_runs(ja, jb, 2, "pallas", tuning=JAX_TUNING)
    routes = []
    monkeypatch.setattr(tbe, "MARK", lambda event, name, words: routes.append(
        name) if event == "route" else None)
    got = tps._merge_two_runs(_torch_words(ra[0] + ra[1]),
                              _torch_words(rb[0] + rb[1]), 2, "bitonic")
    assert routes == [route]
    for g, w in zip(got, want):
        assert_bits_equal(g, np.asarray(w))
    # the lexsort engine gives the same merge; under "counting" (the
    # local sort's engine) the merge is the network's
    lex = tps._merge_two_runs(_torch_words(ra[0] + ra[1]),
                              _torch_words(rb[0] + rb[1]), 2, "lexsort")
    routes.clear()
    cnt = tps._merge_two_runs(_torch_words(ra[0] + ra[1]),
                              _torch_words(rb[0] + rb[1]), 2, "counting")
    assert routes == [route]
    for g, w, c in zip(lex, got, cnt):
        assert torch.equal(g, w) and torch.equal(c, w)


def test_rebalance_merge_under_counting_is_the_network(monkeypatch):
    # the local sort's engine does not reach the merges: "counting" merges
    # on the network (its routes), equal to lexsort sorting them together
    rng = np.random.default_rng(RNG_SEED + 3)
    kept = _runs(rng, 1, 1000)
    recv = _runs(rng, 4, 64, base=1000)
    routes = []
    monkeypatch.setattr(tbe, "MARK", lambda event, name, words: routes.append(
        name) if event == "route" else None)
    lex = tps.rebalance_merge(_torch_words(kept[0] + kept[1]),
                              _torch_words(recv[0] + recv[1]), 2, 4, 64,
                              "lexsort")
    assert not routes
    got = tps.rebalance_merge(_torch_words(kept[0] + kept[1]),
                              _torch_words(recv[0] + recv[1]), 2, 4, 64,
                              "counting")
    assert routes
    for g, w in zip(got, lex):
        assert torch.equal(g[:w.shape[0]], w)


def test_local_sort_methods_agree():
    rng = np.random.default_rng(RNG_SEED)
    cmp_w, carry_w = _runs(rng, 3, 1000)
    words = _torch_words(cmp_w), _torch_words(carry_w)
    bc, bk = tps._local_sort_words(*words, "bitonic")
    lc, lk = tps._local_sort_words(*words, "lexsort")
    # counting by every bit of every word: the whole tuple, in any order
    cc, ck = tps._local_sort_words(*words, "counting")
    for g, w, c in zip(bc + bk, lc + lk, cc + ck):
        assert torch.equal(g, w) and torch.equal(c, w)
    # "auto" follows what the call shows: device, words a rank, donate
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    min_n = tps.AUTO_COUNTING_MIN_N
    assert min_n is tsort.AUTO_COUNTING_MIN_N
    for device, B, donate, engine in (
            (cuda, min_n - 1, False, "bitonic"),
            (cuda, min_n, False, "counting"),
            (cuda, 1 << 28, False, "counting"),
            (cuda, 1 << 28, True, "bitonic"),
            (cpu, 1 << 28, False, "lexsort"),
            (cpu, 8, True, "lexsort")):
        assert tps._resolve_local_method("auto", device, B, donate) == engine
    for method in ("bitonic", "counting", "lexsort"):
        assert tps._resolve_local_method(method, cuda, 8, True) == method
        assert tps._resolve_local_method(method, cpu, min_n) == method
    with pytest.raises(ValueError):
        tps._resolve_local_method("pallas", cpu, 8)


def _psort_local_words(rng, n, npad, n_idx, sentinel_share=0.1):
    """A rank's words as psort's local sort takes them: keys with real
    all-ones keys among them, then ``npad`` entry pads (all-ones key and
    index) at the tail; the index ascends with position, ``n_idx`` words."""
    key = rng.integers(0, 8, size=n + npad).astype(np.uint32)
    key[rng.random(n + npad) < sentinel_share] = 0xFFFFFFFF
    key[n:] = 0xFFFFFFFF
    g = np.arange(n + npad, dtype=np.int64) * 3 + (1 << 32) * (n_idx - 1)
    idx = tps._index_words(torch.from_numpy(g), int(g[n - 1]) + 1, n_idx)
    return _torch_words([key]) + idx


@pytest.mark.parametrize("n_idx", [1, 2])
@pytest.mark.parametrize("n,npad", [(3000, 100), (4096, 0), (5, 2043)])
def test_counting_local_sort_keeps_pads_behind_equal_keys(n, npad, n_idx):
    # the keys alone sorted, the index carried: a real all-ones key stays
    # before every pad, as the whole tuple's order has it
    rng = np.random.default_rng(RNG_SEED + n + npad + n_idx)
    cmp_w = _psort_local_words(rng, n, npad, n_idx)
    carry = [torch.from_numpy(rng.integers(-2**31, 2**31, size=n + npad,
                                           dtype=np.int64).astype(np.int32))]
    want = tps._local_sort_words(cmp_w, carry, "lexsort")
    got = tps._local_sort_words(cmp_w, carry, "counting",
                                sort_bits=[32] + [0] * n_idx)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(g, w)
    # the pads last: their index words are the sorted tail's
    assert (got[0][0][n:] == -1).all()
    assert all((w[n:] == -1).all() for w in got[0][1:])


@pytest.mark.parametrize("width", [3, 8, 13])
def test_counting_local_sort_of_a_window_keeps_pads_behind(width):
    # a window's key word holds its value below 2**width, the pads
    # all-ones: sorting the window's bits alone gives the tuple order
    rng = np.random.default_rng(RNG_SEED + width)
    n, npad = 2500, 600
    key = rng.integers(0, 1 << width, size=n + npad).astype(np.uint32)
    key[rng.random(n + npad) < 0.2] = (1 << width) - 1
    key[n:] = 0xFFFFFFFF
    idx = tps._index_words(torch.arange(n + npad), n, 1)
    cmp_w = _torch_words([key]) + idx
    want = tps._local_sort_words(cmp_w, [], "lexsort")
    got = tps._local_sort_words(cmp_w, [], "counting", sort_bits=[width, 0])
    for g, w in zip(got[0], want[0]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n_idx", [1, 2])
@pytest.mark.parametrize("B,P,n", [(64, 1, 60), (64, 8, 500), (192, 3, 576),
                                   (1024, 4, 1)])
def test_synth_index_words_match_jax(B, P, n, n_idx):
    # the keys-only path's index words after the pre-exchange, every rank
    for me in range(P):
        want = jps._synth_index_words(B, P, jnp.int32(me), n, n_idx)
        got = tps._synth_index_words(B, P, me, n, n_idx, "cpu")
        assert len(got) == len(want) == n_idx
        for g, w in zip(got, want):
            assert_bits_equal(g, np.asarray(w))


def test_index_words_of_wide_positions():
    # positions at and past 2**32 as (hi, lo) words, the JAX split_u64 of
    # the u64 position; past n all-ones; one word below 2**32
    g = np.array([0, 5, 2**31, 2**32 - 1, 2**32, 2**32 + 7, 3 << 40],
                 dtype=np.int64)
    n = int(g[-2]) + 1
    hi, lo = tps._index_words(torch.from_numpy(g.copy()), n, 2)
    jhi, jlo = jbe.split_u64(jnp.asarray(g.astype(np.uint64)))
    pad = g >= n
    assert_bits_equal(hi, np.where(pad, 0xFFFFFFFF, np.asarray(jhi)))
    assert_bits_equal(lo, np.where(pad, 0xFFFFFFFF, np.asarray(jlo)))
    (w,) = tps._index_words(torch.from_numpy(g[:4].copy()), 2**32, 1)
    assert_bits_equal(w, g[:4].astype(np.uint32))
