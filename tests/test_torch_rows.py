"""The port's batched row sorts on the bitonic engine: the row network
(stages ``1..r``, stage ``r`` forced ascending, the batch padded to a tile
multiple), the row-segmented route for non-power-of-two rows (taken from
a batch of ``_ROW_SEG_MIN_PADDED`` padded elements up; the tests lower
that floor), the row merge, and 2-D keys through the public API.

The same numpy inputs go through the JAX package (engine functions with
``interpret=True``, the public API with ``method="pallas"``) and through
``tinyhipradixsort_torch`` on CPU tensors (the sweep kernel's plain
version); outputs are compared bit-exactly as unsigned views.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinyhipradixsort_torch as tthrs
import tinyhipradixsort_tpu as jthrs
from tests.torch_helpers import assert_bits_equal, rand_keys, to_torch, ubits
from tinyhipradixsort_torch.ops import bitonic_engine as tbe
from tinyhipradixsort_tpu.ops import bitonic_engine as jbe

RNG_SEED = 0x120E5


def _words(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
            for a in arrays]


def _count_row_segmented(monkeypatch):
    calls = []
    real = tbe._sort_segmented_rows

    def spy(words, B, nr, *args):
        calls.append((B, nr))
        return real(words, B, nr, *args)

    monkeypatch.setattr(tbe, "_sort_segmented_rows", spy)
    return calls


@pytest.mark.parametrize("B,nr,segmented", [
    (3, 1040, True),   # 1024 + 16: long bookkeeping chain, small merges
    (5, 100, True),    # a row of 64 + 36, batch padded to a tile multiple
    (1, 33, True),     # just above the routing floor
    (9, 64, False),    # power-of-two rows: the row network alone
])
def test_sort_words_rows_matches_jax(monkeypatch, B, nr, segmented):
    # the Hopper batch floor lowered so these small batches take the route
    monkeypatch.setattr(tbe, "_ROW_SEG_MIN_PADDED", 0)
    rng = np.random.default_rng(RNG_SEED + B * nr)
    k = rng.integers(0, 2**8, (B, nr)).astype(np.uint32).reshape(-1)
    idx = np.tile(np.arange(nr, dtype=np.uint32), B)
    pay = rng.integers(0, 2**32, B * nr, dtype=np.uint32)
    (wk, widx), (wpay,) = jbe.sort_words_rows(
        [jnp.asarray(k), jnp.asarray(idx)], [jnp.asarray(pay)], (B, nr),
        interpret=True,
        tuning=jbe.EngineTuning(row_seg_waste=0.0, row_seg_min_nr=0))
    calls = _count_row_segmented(monkeypatch)
    cmp_in, carry_in = _words(k, idx), _words(pay)
    (gk, gidx), (gpay,) = tbe.sort_words_rows(
        cmp_in, carry_in, (B, nr),
        tuning=tbe.EngineTuning(row_seg_waste=0.0, row_seg_min_nr=0))
    assert bool(calls) == segmented and (not calls or calls[0] == (B, nr))
    for g, w in ((gk, wk), (gidx, widx), (gpay, wpay)):
        assert_bits_equal(g, np.asarray(w))
    assert_bits_equal(cmp_in[0], k)
    assert_bits_equal(carry_in[0], pay)


def test_row_segmented_route_needs_a_large_batch(monkeypatch):
    # the route is taken from _ROW_SEG_MIN_PADDED padded elements (B * 2**r)
    # up; here the floor is scaled down to 64 rows of 2048 to keep it small
    assert tbe._ROW_SEG_MIN_PADDED == 1 << 26
    monkeypatch.setattr(tbe, "_ROW_SEG_MIN_PADDED", 64 * 2048)
    routes = []
    monkeypatch.setattr(tbe, "MARK", lambda event, name, words: routes.append(
        name) if event == "route" else None)
    x = np.random.default_rng(RNG_SEED + 6).integers(0, 2**32, (64, 1040),
                                                     dtype=np.uint32)
    for B, route in ((63, "rows"), (64, "rows-segmented")):
        routes.clear()
        (got,), _ = tbe.sort_words_rows(_words(x[:B].reshape(-1)), [],
                                        (B, 1040))
        assert routes[0] == route
        assert_bits_equal(got.reshape(B, 1040), np.sort(x[:B], axis=1))


def _bitonic_rows(rng, B, nr):
    rows = []
    for _ in range(B):
        a = np.sort(rng.integers(0, 2**32, nr // 2, dtype=np.uint32))
        d = np.sort(rng.integers(0, 2**32, nr // 2, dtype=np.uint32))[::-1]
        rows.append(np.concatenate([a, d]))
    return np.stack(rows)


@pytest.mark.parametrize("B,nr", [(21, 64), (21, 2048)])
def test_merge_words_rows_matches_jax(B, nr):
    # 21 rows is no tile multiple; 64 takes the dense compare-exchange
    # levels, 2048 the stage-11 sweeps
    rng = np.random.default_rng(RNG_SEED + nr)
    x = _bitonic_rows(rng, B, nr)
    (want,), _ = jbe.merge_words_rows(
        [jnp.asarray(x.reshape(-1))], [], (B, nr), interpret=True,
        tuning=jbe.EngineTuning(tile_bits_cap=12))
    words = _words(x.reshape(-1))
    (got,), _ = tbe.merge_words_rows(words, [], (B, nr))
    assert_bits_equal(got, np.asarray(want))
    assert_bits_equal(got.reshape(B, nr), np.sort(x, axis=1))
    assert_bits_equal(words[0], x.reshape(-1))
    with pytest.raises(ValueError):
        tbe.merge_words_rows(words, [], (B * 2, nr // 2 - 1))


def test_row_plan_pads_the_batch_to_the_fewest_rows():
    t = tbe.EngineTuning()
    # the tile inside one row: any B divides
    assert tbe._row_plan(3, 22, 1, t) == (15, 3)
    # whole rows per tile: a full 2**15 tile where no row pads
    assert tbe._row_plan(16384, 10, 1, t) == (15, 16384)
    # 136 rows of 32: T = 10 pads to 160 rows (T = 11 would need 192)
    assert tbe._row_plan(136, 5, 1, t) == (10, 160)
    # rows of 2**11: a one-row tile (T = r) pads nothing
    assert tbe._row_plan(21, 11, 1, t) == (11, 21)
    x = np.random.default_rng(RNG_SEED).integers(0, 2**32, (136, 32),
                                                 dtype=np.uint32)
    (got,), _ = tbe.sort_words_rows(_words(x.reshape(-1)), [], (136, 32))
    assert_bits_equal(got.reshape(136, 32), np.sort(x, axis=1))


def test_2d_keys_match_jax():
    rng = np.random.default_rng(RNG_SEED + 1)
    # u32, a non-power-of-two batch and row: keys, pairs and indices
    x = rand_keys(rng, np.uint32, 6 * 500).reshape(6, 500) % 64
    v = rng.integers(0, 2**32, size=(6, 500), dtype=np.uint32)
    jk, jv = jthrs.sort_pairs(jnp.asarray(x), jnp.asarray(v),
                              method="pallas")
    xt, vt = to_torch(x), to_torch(v)
    k, vv = tthrs.sort_pairs(xt, vt, method="bitonic")
    assert k.shape == (6, 500) and vv.shape == (6, 500)
    assert_bits_equal(k, np.asarray(jk))
    assert_bits_equal(vv, np.asarray(jv))
    assert_bits_equal(tthrs.sort_keys(xt, method="bitonic"),
                      np.sort(x, axis=1))
    perm = tthrs.sort_indices(xt, method="bitonic")
    assert perm.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(),
                                  np.argsort(x, axis=1, kind="stable"))
    assert_bits_equal(xt, x)  # inputs untouched
    assert_bits_equal(vt, v)


def test_2d_float_keys_descending_match_jax():
    # f32 with -0.0 runs and NaN payloads, descending: the tagged index
    rng = np.random.default_rng(RNG_SEED + 2)
    x = rand_keys(rng, np.float32, 5 * 300).reshape(5, 300)
    x[:, :4] = np.array([-0.0, 0.0, -0.0, np.nan], dtype=np.float32)
    jk = jthrs.sort_keys(jnp.asarray(x), order="descending", method="pallas")
    assert_bits_equal(tthrs.sort_keys(to_torch(x), order="descending",
                                      method="bitonic"),
                      np.asarray(jk))


def test_2d_u64_pairs_with_a_window_match_jax(monkeypatch):
    # (3, 1040), u64 keys carried (the window hides key bits) with a
    # (B, n, 4) u128 payload: padded rows (a batch below the Hopper floor),
    # and the row-segmented route, as the JAX package takes it, with the
    # floor lowered
    rng = np.random.default_rng(RNG_SEED + 3)
    x = rand_keys(rng, np.uint64, 3 * 1040).reshape(3, 1040)
    v = rng.integers(0, 2**32, size=(3, 1040, 4), dtype=np.uint32)
    jk, jv = jthrs.sort_pairs(jnp.asarray(x), jnp.asarray(v), start_bit=8,
                              end_bit=40, method="pallas")
    xt, vt = to_torch(x), to_torch(v)
    routes = []
    monkeypatch.setattr(tbe, "MARK", lambda event, name, words: routes.append(
        name) if event == "route" else None)
    for floor, route in ((None, "rows"), (0, "rows-segmented")):
        if floor is not None:
            monkeypatch.setattr(tbe, "_ROW_SEG_MIN_PADDED", floor)
        routes.clear()
        k, vv = tthrs.sort_pairs(xt, vt, start_bit=8, end_bit=40,
                                 method="bitonic")
        assert routes[0] == route
        assert vv.shape == (3, 1040, 4)
        assert_bits_equal(k, np.asarray(jk))
        assert_bits_equal(vv, np.asarray(jv))
        assert_bits_equal(xt, x)
        assert_bits_equal(vt, v)


def test_segment_ids_batched_match_jax():
    rng = np.random.default_rng(RNG_SEED + 4)
    x = rng.integers(0, 9, size=(4, 300)).astype(np.uint32)
    seg = rng.integers(0, 5, size=(4, 300)).astype(np.int32)
    v = np.tile(np.arange(300, dtype=np.uint32), (4, 1))
    jk, jv = jthrs.sort_pairs(jnp.asarray(x), jnp.asarray(v),
                              segment_ids=jnp.asarray(seg), method="pallas")
    k, vv = tthrs.sort_pairs(to_torch(x), to_torch(v),
                             segment_ids=to_torch(seg), method="bitonic")
    assert_bits_equal(k, np.asarray(jk))
    assert_bits_equal(vv, np.asarray(jv))
    for row in range(4):
        np.testing.assert_array_equal(ubits(vv)[row],
                                      np.lexsort((x[row], seg[row])))


def test_unstable_rows(monkeypatch):
    moved = []
    real = tbe.sort_words_rows

    def spy(cmp_words, carry_words, shape, **kw):
        moved.append(len(cmp_words) + len(carry_words))
        return real(cmp_words, carry_words, shape, **kw)

    monkeypatch.setattr(tbe, "sort_words_rows", spy)
    rng = np.random.default_rng(RNG_SEED + 5)
    for nr in (256, 300):  # power-of-two rows drop the index; others not
        x = rng.integers(0, 16, size=(4, nr)).astype(np.uint32)
        v = rng.integers(0, 2**32, size=(4, nr), dtype=np.uint32)
        k, vv = tthrs.sort_pairs(to_torch(x), to_torch(v), stable=False,
                                 method="bitonic")
        assert_bits_equal(k, np.sort(x, axis=1))
        got = np.stack([ubits(k), ubits(vv)], axis=-1)
        for row in range(4):
            pairs = np.stack([x[row], v[row]], axis=-1)
            np.testing.assert_array_equal(
                got[row][np.lexsort(got[row].T[::-1])],
                pairs[np.lexsort(pairs.T[::-1])])
        if nr == 300:
            perm = np.argsort(x, axis=1, kind="stable")
            assert_bits_equal(vv, np.take_along_axis(v, perm, 1))
    assert moved == [2, 3]
    with pytest.raises(ValueError):
        tbe.sort_words_rows(_words(x.reshape(-1)), _words(v.reshape(-1)),
                            (4, 300), allow_tied_carries=True)
