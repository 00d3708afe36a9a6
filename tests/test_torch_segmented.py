"""The port's non-power-of-two route (pow2 segments and truncated merges),
``segment_ids=``, 16-bit keys and ``stable=False`` on the bitonic engine.

Each case sends the same numpy inputs through the JAX package (its engine
functions with ``interpret=True``, its public API with
``method="pallas"``) and through ``tinyhipradixsort_torch`` on CPU tensors,
which run the sweep kernel's plain version. Outputs are compared
bit-exactly as unsigned views; no tolerance applies. ``stable=False`` is
checked as a sorted key order plus a permutation of the payloads.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinyhipradixsort_torch as tthrs
import tinyhipradixsort_tpu as jthrs
from tests import oracles
from tests.torch_helpers import (BF16, assert_bits_equal, rand_keys,
                                 to_torch, ubits)
from tinyhipradixsort_torch import tracing
from tinyhipradixsort_torch.ops import bitonic_engine as tbe
from tinyhipradixsort_tpu.ops import bitonic_engine as jbe

RNG_SEED = 0x5E65


def _words(*arrays):
    """numpy u32 arrays -> the port's int32 words (same bits)."""
    return [torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
            for a in arrays]


def _runs(rng, a, b):
    """An ascending run of a and a descending run of b (key, index) tuples
    with dense key ties, and a carry tied to each tuple."""
    ka = np.sort(rng.integers(0, 2**8, a, dtype=np.uint32))
    ia = np.arange(a, dtype=np.uint32)
    kb = rng.integers(0, 2**8, b, dtype=np.uint32)
    ib = a + np.arange(b, dtype=np.uint32)
    rev = np.lexsort((ib, kb))[::-1]
    kb, ib = kb[rev].copy(), ib[rev].copy()
    return (ka, ia, ia * 7), (kb, ib, ib * 7)


@pytest.mark.parametrize("a,b", [
    (1024, 1), (1024, 513), (1024, 1024),     # truncated, one level
    (2048, 700), (4096, 1000), (4096, 4095),  # multi-level upper chains
    (1536, 100), (1024, 1500), (512, 100),    # the padded fallback's shapes
])
def test_merge_sorted_runs_matches_jax(a, b):
    asc, desc = _runs(np.random.default_rng(RNG_SEED + a + b), a, b)
    want = jbe._merge_sorted_runs([jnp.asarray(w) for w in asc],
                                  [jnp.asarray(w) for w in desc], 2, True,
                                  jbe.EngineTuning())
    tasc, tdesc = _words(*asc), _words(*desc)
    keep = [w.clone() for w in tasc + tdesc]
    got = tbe._merge_sorted_runs(tasc, tdesc, 2, tbe.EngineTuning())
    for g, w in zip(got, want):
        assert_bits_equal(g, np.asarray(w))
    for w, k in zip(tasc + tdesc, keep):
        assert torch.equal(w, k)  # the runs are read, never swept


def test_merge_sorted_runs_keys_only_duplicates_and_padded_merge():
    rng = np.random.default_rng(RNG_SEED)
    # keys only (no carries): tie swaps are unobservable
    ka = np.sort(rng.integers(0, 8, 4096, dtype=np.uint32))
    kb = np.sort(rng.integers(0, 8, 3000, dtype=np.uint32))[::-1].copy()
    (got,) = tbe._merge_sorted_runs(_words(ka), _words(kb), 1,
                                    tbe.EngineTuning())
    (want,) = jbe._merge_sorted_runs([jnp.asarray(ka)], [jnp.asarray(kb)], 1,
                                     True, jbe.EngineTuning())
    assert_bits_equal(got, np.asarray(want))
    assert_bits_equal(got, np.sort(np.concatenate([ka, kb])))
    # a not a power of two: the padded construction, keys only
    ka, kb = ka[:3000], kb[:2000]
    (padded,) = tbe._merge_sorted_runs(_words(ka), _words(kb), 1,
                                       tbe.EngineTuning())
    (want,) = jbe._merge_sorted_runs([jnp.asarray(ka)], [jnp.asarray(kb)], 1,
                                     True, jbe.EngineTuning())
    assert_bits_equal(padded, np.asarray(want))
    assert_bits_equal(padded, np.sort(np.concatenate([ka, kb])))


def _count_segmented(monkeypatch):
    calls = []
    real = tbe._sort_segmented

    def spy(words, n, *args):
        calls.append(n)
        return real(words, n, *args)

    monkeypatch.setattr(tbe, "_sort_segmented", spy)
    return calls


@pytest.mark.parametrize("n,depth", [(1100, 1), (3000, 1), (6244, 2)])
def test_sort_words_segmented_matches_jax(monkeypatch, n, depth):
    # seg_pad_waste=0.0 sends every non-power-of-two n down the segmented
    # route; 6244 = 4096 + 2148 nests once more, to _MAX_SEG_DEPTH
    rng = np.random.default_rng(RNG_SEED + n)
    k = rng.integers(0, 16, n, dtype=np.uint32)
    idx = np.arange(n, dtype=np.uint32)
    pay = rng.integers(0, 2**32, n, dtype=np.uint32)
    (wk, widx), (wpay,) = jbe.sort_words(
        [jnp.asarray(k), jnp.asarray(idx)], [jnp.asarray(pay)],
        interpret=True, tuning=jbe.EngineTuning(seg_pad_waste=0.0))
    calls = _count_segmented(monkeypatch)
    cmp_in, carry_in = _words(k, idx), _words(pay)
    (gk, gidx), (gpay,) = tbe.sort_words(
        cmp_in, carry_in, tuning=tbe.EngineTuning(seg_pad_waste=0.0))
    assert len(calls) == depth and calls[0] == n
    for g, w in ((gk, wk), (gidx, widx), (gpay, wpay)):
        assert_bits_equal(g, np.asarray(w))
    assert_bits_equal(cmp_in[0], k)
    assert_bits_equal(carry_in[0], pay)


def test_sort_words_segmented_above_the_merge_tail(monkeypatch):
    # a = 2**17 prefix: the merge's chain of dense levels runs above the
    # 2**16 materialized tail; the output is unique under the word contract,
    # so numpy's stable argsort is the oracle
    n = (1 << 17) + (1 << 15) + 3
    rng = np.random.default_rng(RNG_SEED + 17)
    k = rng.integers(0, 2**12, n, dtype=np.uint32)
    pay = rng.integers(0, 2**32, n, dtype=np.uint32)
    calls = _count_segmented(monkeypatch)
    (gk, gidx), (gpay,) = tbe.sort_words(
        _words(k, np.arange(n, dtype=np.uint32)), _words(pay),
        tuning=tbe.EngineTuning(seg_pad_waste=0.0))
    assert calls[0] == n
    perm = np.argsort(k, kind="stable")
    assert_bits_equal(gk, k[perm])
    assert_bits_equal(gidx, perm.astype(np.uint32))
    assert_bits_equal(gpay, pay[perm])


def test_default_routing_pads_near_a_power_of_two(monkeypatch):
    # seg_pad_waste=0.15: 8000 of 8192 pads; 5000 of 8192 is segmented
    calls = _count_segmented(monkeypatch)
    for n in (8000, 5000):
        x = np.random.default_rng(n).integers(0, 2**32, n, dtype=np.uint32)
        (got,), _ = tbe.sort_words(_words(x), [], tuning=tbe.EngineTuning())
        assert_bits_equal(got, np.sort(x))
    assert calls == [5000]


def test_seg_pad_waste_env_moves_an_api_sort_to_the_padded_route(
        monkeypatch):
    # the network reads THRS_* at its own entry: 5000 of 8192 takes the
    # segmented route by default and the padded one under a waste of 1.0
    routes = []
    monkeypatch.setattr(tbe, "MARK", lambda event, name, words: routes.append(
        name) if event == "route" else None)
    x = np.random.default_rng(RNG_SEED + 5).integers(0, 2**32, 5000,
                                                     dtype=np.uint32)
    assert_bits_equal(tthrs.sort_keys(to_torch(x), method="bitonic"),
                      np.sort(x))
    assert routes[0] == "segmented", routes
    routes.clear()
    monkeypatch.setenv("THRS_SEG_PAD_WASTE", "1.0")
    assert_bits_equal(tthrs.sort_keys(to_torch(x), method="bitonic"),
                      np.sort(x))
    assert routes == ["padded"]


def _case_words(case, rng):
    """numpy u32 ``(cmp, carry)`` words of one ``sort_words`` case."""
    if case.startswith("uniform-"):
        n = int(case.split("-")[1])
        return [rng.integers(0, 2**32, n, dtype=np.uint32)], []
    n = 5000
    idx = np.arange(n, dtype=np.uint32)
    pay = rng.integers(0, 2**32, n, dtype=np.uint32)
    if case == "stable-pairs":
        hi = rng.integers(0, 2**32, n, dtype=np.uint32)
        lo = rng.integers(0, 4, n, dtype=np.uint32)
        return [hi, lo, idx], [pay]
    if case == "zipf-head":
        z = np.minimum(rng.zipf(1.3, n), 2**32 - 1).astype(np.uint32)
        return [z, idx], [pay]
    if case == "all-equal":
        return [np.full(n, 0xDEADBEEF, np.uint32), idx], []
    # runs of one top nibble whose lengths straddle rows of 1024
    sizes = [700, 900, 1024, 1000, 1024, 300]
    top = np.concatenate([np.full(k, d, np.uint32)
                          for d, k in enumerate(sizes)])
    low = rng.integers(0, 2**28, top.shape[0], dtype=np.uint32)
    return [rng.permutation((top << np.uint32(28)) | low)], []


@pytest.mark.parametrize("case", [
    "uniform-700", "uniform-4096", "uniform-6000", "uniform-10000",
    "stable-pairs", "zipf-head", "all-equal", "bucket-straddling"])
def test_sort_words_matches_jax(case):
    # the default routes (padded or segmented) on uniform, multi-word,
    # skewed, tied and clustered words, against the JAX package's engine
    cmp_np, carry_np = _case_words(case, np.random.default_rng(
        [RNG_SEED, len(case)]))
    jc, jk = jbe.sort_words([jnp.asarray(w) for w in cmp_np],
                            [jnp.asarray(w) for w in carry_np],
                            interpret=True)
    tc, tk = tbe.sort_words(_words(*cmp_np), _words(*carry_np))
    assert len(tc) == len(jc) and len(tk) == len(jk)
    for g, w in zip(tc + tk, list(jc) + list(jk)):
        assert_bits_equal(g, np.asarray(w))
    order = np.lexsort(tuple(reversed(cmp_np)))
    assert_bits_equal(tc[0], cmp_np[0][order])


def test_partition_knobs_are_not_read(monkeypatch):
    # the front-end's old THRS_PARTITION_* variables route nothing: an API
    # sort takes the network's own route and gives the same output
    x = np.random.default_rng(RNG_SEED + 8).integers(0, 2**32, 4000,
                                                     dtype=np.uint32)
    want = tthrs.sort_pairs(to_torch(x), torch.arange(4000), method="bitonic")
    for knob, value in (("BITS", "8"), ("MIN_N", "0"), ("TILE_BITS", "8"),
                        ("ROW_BITS", "10")):
        monkeypatch.setenv(f"THRS_PARTITION_{knob}", value)
    with tracing.record() as rec:
        got = tthrs.sort_pairs(to_torch(x), torch.arange(4000),
                               method="bitonic")
    routes = [i.attrs["route"] for i in rec.instants
              if i.name == "bitonic.route"]
    assert routes == ["padded"], routes
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [np.uint16, np.float32, np.uint64],
                         ids=lambda d: np.dtype(d).name)
def test_nonpow2_pairs_match_jax_and_leave_inputs(dtype):
    # one non-power-of-two n per key width through the public API, on the
    # segmented route (1500 of 2048); the caller's keys and values (whose
    # 32-bit words are views of them) come back untouched
    n = 1500
    rng = np.random.default_rng(RNG_SEED + np.dtype(dtype).itemsize)
    x = rand_keys(rng, dtype, n)
    x[::5] = x[1]  # ties
    vals = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    jk, jv = jthrs.sort_pairs(jnp.asarray(x), jnp.asarray(vals),
                              method="pallas")
    xt, vt = to_torch(x), to_torch(vals)
    k, v = tthrs.sort_pairs(xt, vt, method="bitonic")
    assert_bits_equal(k, np.asarray(jk))
    assert_bits_equal(v, np.asarray(jv))
    assert_bits_equal(xt, x)
    assert_bits_equal(vt, vals)
    np.testing.assert_array_equal(
        tthrs.sort_indices(xt, method="bitonic").numpy(), oracles.oracle_perm(x))


def _segments(rng, n, nseg):
    return np.sort(rng.integers(0, nseg, size=n).astype(np.int32))


def test_segment_ids_flat_match_jax():
    rng = np.random.default_rng(RNG_SEED + 1)
    n = 2000
    x = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    seg = _segments(rng, n, 17)
    jk = jthrs.sort_keys(jnp.asarray(x), segment_ids=jnp.asarray(seg),
                         method="pallas")
    assert_bits_equal(tthrs.sort_keys(to_torch(x), segment_ids=to_torch(seg),
                                      method="bitonic"), np.asarray(jk))
    # heavy duplicates: stability within each segment, and the permutation
    x = rng.integers(0, 5, size=1500).astype(np.uint32)
    seg = _segments(rng, 1500, 6)
    v = np.arange(1500, dtype=np.uint32)
    jk, jv = jthrs.sort_pairs(jnp.asarray(x), jnp.asarray(v),
                              segment_ids=jnp.asarray(seg), method="pallas")
    k, vv = tthrs.sort_pairs(to_torch(x), to_torch(v),
                             segment_ids=to_torch(seg), method="bitonic")
    assert_bits_equal(k, np.asarray(jk))
    assert_bits_equal(vv, np.asarray(jv))
    perm = tthrs.sort_indices(to_torch(x), segment_ids=to_torch(seg),
                              method="bitonic")
    np.testing.assert_array_equal(perm.numpy(), np.lexsort((x, seg)))


@pytest.mark.parametrize("dtype,order", [(np.float32, "descending"),
                                         (np.uint64, "ascending")],
                         ids=["f32-desc", "u64-asc"])
def test_segment_ids_dtypes_match_jax(dtype, order):
    rng = np.random.default_rng(RNG_SEED + 2)
    n = 700
    x = rand_keys(rng, dtype, n)
    seg = rng.integers(0, 9, size=n).astype(np.int64)  # unsorted, 64-bit
    jk = jthrs.sort_keys(jnp.asarray(x), order=order,
                         segment_ids=jnp.asarray(seg), method="pallas")
    got = tthrs.sort_keys(to_torch(x), order=order,
                          segment_ids=to_torch(seg), method="bitonic")
    assert_bits_equal(got, np.asarray(jk))


SIXTEEN = [np.dtype(np.uint16), np.dtype(np.int16), np.dtype(np.float16),
           BF16]


@pytest.mark.parametrize("dtype", SIXTEEN, ids=lambda d: d.name)
def test_16bit_keys_match_jax(dtype):
    # raw-uniform patterns: NaNs with every payload and sign, denormals,
    # infinities and both zeros for the float views
    rng = np.random.default_rng(RNG_SEED + 16)
    x = rng.integers(0, 2**16, size=4000, dtype=np.uint16).view(dtype)
    x[:6] = np.array([0, 0x8000, 0x8000, 0, 0x7E01, 0xFE02],
                     dtype=np.uint16).view(dtype)
    jk = jthrs.sort_keys(jnp.asarray(x), method="pallas")
    assert_bits_equal(tthrs.sort_keys(to_torch(x), method="bitonic"),
                      np.asarray(jk))


@pytest.mark.parametrize("dtype", [np.dtype(np.float16), BF16],
                         ids=lambda d: d.name)
def test_16bit_float_pairs_and_indices_match_jax(dtype):
    rng = np.random.default_rng(RNG_SEED + 17)
    x = rng.integers(0, 2**16, size=3000, dtype=np.uint16).view(dtype)
    v = rng.integers(0, 2**16, size=3000, dtype=np.uint16).view(dtype)
    jk, jv = jthrs.sort_pairs(jnp.asarray(x), jnp.asarray(v),
                              order="descending", method="pallas")
    k, vv = tthrs.sort_pairs(to_torch(x), to_torch(v), order="descending",
                             method="bitonic")
    assert_bits_equal(k, np.asarray(jk))
    assert_bits_equal(vv, np.asarray(jv))  # NaN payloads of the values too
    want = np.argsort(tthrs.np_key_bits(x, descending=True), kind="stable")
    np.testing.assert_array_equal(
        tthrs.sort_indices(to_torch(x), order="descending",
                           method="bitonic").numpy(), want)


def _words_moved(monkeypatch):
    moved = []
    real = tbe.sort_words

    def spy(cmp_words, carry_words, **kw):
        moved.append(len(cmp_words) + len(carry_words))
        return real(cmp_words, carry_words, **kw)

    monkeypatch.setattr(tbe, "sort_words", spy)
    return moved


def _check_unstable(k, v, x, vals):
    """Keys in the stable order; each (key, value) pair is an input pair."""
    perm = np.argsort(x, kind="stable")
    assert_bits_equal(k, x[perm])
    got = np.stack([ubits(k), ubits(v)])
    want = np.stack([x, vals])
    order_g = np.lexsort(got[::-1])
    order_w = np.lexsort(want[::-1])
    np.testing.assert_array_equal(got[:, order_g], want[:, order_w])


def test_unstable_pairs_drop_the_index_word(monkeypatch):
    rng = np.random.default_rng(RNG_SEED + 3)
    n = 4096
    x = rng.integers(0, 64, size=n, dtype=np.uint32)  # many ties
    vals = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    jk, _ = jthrs.sort_pairs(jnp.asarray(x), jnp.asarray(vals),
                             stable=False, method="pallas")
    moved = _words_moved(monkeypatch)
    k, v = tthrs.sort_pairs(to_torch(x), to_torch(vals), stable=False,
                            method="bitonic")
    ks, vs = tthrs.sort_pairs(to_torch(x), to_torch(vals), method="bitonic")
    assert moved == [2, 3]  # key, value; key, index, value
    assert_bits_equal(k, np.asarray(jk))
    _check_unstable(k, v, x, vals)
    perm = np.argsort(x, kind="stable")
    assert_bits_equal(vs, vals[perm])
    # an all-ones key ties the pad sentinel: only pad-free sizes drop the
    # index, and the engine refuses tied carries where it would pad
    with pytest.raises(ValueError):
        tbe.sort_words(_words(x[:3000]), _words(vals[:3000]),
                       allow_tied_carries=True)


def test_unstable_pairs_stay_stable_where_the_sort_pads(monkeypatch):
    rng = np.random.default_rng(RNG_SEED + 4)
    moved = _words_moved(monkeypatch)
    for n in (3000, 512):  # not a power of two; below 2**MIN_L
        x = rng.integers(0, 8, size=n).astype(np.uint32)
        x[:4] = 0xFFFFFFFF  # ties the sentinel
        vals = np.arange(n, dtype=np.uint32)
        k, v = tthrs.sort_pairs(to_torch(x), to_torch(vals), stable=False,
                                method="bitonic")
        perm = np.argsort(x, kind="stable")
        assert_bits_equal(k, x[perm])
        assert_bits_equal(v, vals[perm])
    assert moved == [3, 3]
