"""The port's portable engines on every API axis beyond dtype and order,
against the JAX package with the same method, bit-exact: bit windows,
``(n, 4)`` u128 payloads and payload trees, 2-D rows, ``segment_ids=`` and
``segment_ids_from_offsets``; and where inputs that are not torch tensors
go.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinyhipradixsort_torch as tthrs
import tinyhipradixsort_tpu as jthrs
from tests.test_torch_engines import DTYPES, METHODS, check_port
from tests.torch_helpers import BF16, assert_bits_equal, rand_keys, to_torch
from tinyhipradixsort_torch import sort as tsort
from tinyhipradixsort_torch import tracing
from tinyhipradixsort_torch.ops import bitonic_engine as tbe
from tinyhipradixsort_torch.ops import counting_engine
from tinyhipradixsort_torch.ops import histogram as th

RNG_SEED = 0xE9


@pytest.mark.parametrize("window", [(0, 8), (8, 16), (3, 29), None],
                         ids=str)
@pytest.mark.parametrize("method", METHODS)
def test_window_parity(method, window):
    rng = np.random.default_rng(RNG_SEED)
    kw = {} if window is None else dict(start_bit=window[0],
                                        end_bit=window[1])
    dtypes = [np.uint32, np.float32, np.int64]
    if window is None or window[1] <= 16:
        dtypes.append(np.float16)
    for dtype in dtypes:
        for n in (129, 2049):
            x = rand_keys(rng, dtype, n)
            vals = np.arange(n, dtype=np.uint32)
            check_port(x, vals, method, f"{method} {np.dtype(dtype).name} "
                       f"{window} n={n}", order="descending", **kw)


@pytest.mark.parametrize("method", METHODS)
def test_u128_payload_and_tree_parity(method):
    n = 2049
    rng = np.random.default_rng(RNG_SEED + 1)
    x = rand_keys(rng, np.uint64, n)
    x[::3] = x[0]
    values = {"u128": rng.integers(0, 2**32, size=(n, 4), dtype=np.uint32),
              "f64": rand_keys(rng, np.float64, n),
              "u8": rng.integers(0, 256, size=n, dtype=np.uint8)}
    jk, jv = jthrs.sort_pairs(jnp.asarray(x),
                              {k: jnp.asarray(v) for k, v in values.items()},
                              method=method)
    k, v = tthrs.sort_pairs(
        to_torch(x), {"nested": [to_torch(values["u128"])],
                      "f64": to_torch(values["f64"]),
                      "u8": to_torch(values["u8"])}, method=method)
    assert_bits_equal(k, np.asarray(jk))
    assert tuple(v["nested"][0].shape) == (n, 4)
    assert_bits_equal(v["nested"][0], np.asarray(jv["u128"]))
    for name in ("f64", "u8"):
        assert_bits_equal(v[name], np.asarray(jv[name]))


@pytest.mark.parametrize("shape", [(3, 129), (4, 2048)], ids=str)
@pytest.mark.parametrize("method", METHODS)
def test_rows_parity(method, shape):
    rng = np.random.default_rng(RNG_SEED + shape[0])
    for dtype, order in ((np.uint32, "ascending"), (np.float16, "descending"),
                         (np.int64, "ascending")):
        x = rand_keys(rng, dtype, shape[0] * shape[1]).reshape(shape)
        x[:, ::4] = x[:, 1:2]
        vals = rng.integers(0, 2**32, size=(*shape, 4), dtype=np.uint32)
        check_port(x, vals, method, f"{method} {np.dtype(dtype).name} "
                   f"{shape}", order=order)


@pytest.mark.parametrize("method", METHODS)
def test_rows_carry_16bit_float_values_bit_exactly(method):
    # signalling NaNs keep their quiet bit clear through a row gather; the
    # oracle is numpy (the JAX counting engine quiets bf16 NaNs)
    rng = np.random.default_rng(RNG_SEED + 6)
    x = rand_keys(rng, np.uint32, 4 * 300).reshape(4, 300)
    raw = rng.integers(0, 2**16, size=(4, 300), dtype=np.uint16)
    raw[:, :3] = [0x7C01, 0xFD56, 0x7F80]  # f16 and bf16 signalling NaNs
    want = np.take_along_axis(raw, np.argsort(x, axis=1, kind="stable"), 1)
    for dt in (np.dtype(np.float16), BF16):
        _, v = tthrs.sort_pairs(to_torch(x), to_torch(raw.view(dt)),
                                method=method)
        assert_bits_equal(v, want, f"{method} {dt.name}")


@pytest.mark.parametrize("method", METHODS)
def test_segment_ids_parity(method):
    rng = np.random.default_rng(RNG_SEED + 2)
    n = 2049
    cases = [
        (np.uint32, np.sort(rng.integers(0, 17, size=n)).astype(np.int32)),
        (np.float32, rng.integers(-3, 4, size=n).astype(np.int32)),  # ungrouped
        (np.float16, np.sort(rng.integers(0, 9, size=n)).astype(np.uint8)),
        (np.int64, np.sort(rng.integers(0, 2**40, size=n)).astype(np.int64)),
    ]
    for dtype, seg in cases:
        x = rand_keys(rng, dtype, n)
        vals = rng.integers(0, 2**32, size=n, dtype=np.uint32)
        for order in ("ascending", "descending"):
            check_port(x, vals, method, f"{method} {np.dtype(dtype).name} "
                       f"{seg.dtype} {order}", order=order, segment_ids=seg)


@pytest.mark.parametrize("segmented", [False, True],
                         ids=["flat", "segment_ids"])
@pytest.mark.parametrize("order", ["ascending", "descending"])
@pytest.mark.parametrize("dtype", [np.float16, BF16],
                         ids=lambda d: np.dtype(d).name)
def test_counting_rebuilds_16bit_float_keys_from_the_bits(dtype, order,
                                                          segmented,
                                                          monkeypatch):
    # 16-bit float keys take the from-bits path of f32 and f64 keys: the
    # engine hands back the sorted bits, and one 1-byte -0.0 flag rides
    # beside the value leaves
    seen = []
    real = tsort._PORTABLE["counting"]

    def spy(bits, arrays, start_bit, end_bit, **kw):
        seen.append([a.dtype for a in arrays])
        return real(bits, arrays, start_bit, end_bit, **kw)

    monkeypatch.setitem(tsort._PORTABLE, "counting", spy)
    rng = np.random.default_rng([len(order), int(segmented), dtype == BF16])
    n = 3000
    x = rand_keys(rng, dtype, n)
    x[::9] = x[1]  # ties: stability decides
    # -0.0, +0.0 and NaNs of either sign with a payload
    x[:4] = np.array([0x8000, 0, 0x7FC1, 0xFFC3], np.uint16).view(x.dtype)
    vals = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    kw = dict(order=order)
    if segmented:
        kw["segment_ids"] = np.sort(rng.integers(0, 7, size=n)).astype(
            np.int32)
    check_port(x, vals, "counting", f"{np.dtype(dtype).name} {order}", **kw)
    i32 = torch.int32
    # sort_keys, sort_pairs, sort_indices (no keys: no flag, the index)
    flat = [[torch.bool], [torch.bool, to_torch(vals).dtype], [i32]]
    if segmented:
        # the key pass carries the segment bits in front; the segment pass
        # carries the key pass's sorted bits last
        want = [[i32] + flat[0], flat[0] + [i32], [i32] + flat[1],
                flat[1] + [i32], [i32] + flat[2], flat[2]]
    else:
        want = flat
    assert seen == want


@pytest.mark.parametrize("method", ["counting", "argsort"])
def test_portable_calls_read_no_network_tuning(method, monkeypatch):
    # only the network reads the THRS_* knobs, at its own entry
    def refuse():
        raise AssertionError("a portable sort read the network's tuning")

    monkeypatch.setattr(tbe.EngineTuning, "from_env", staticmethod(refuse))
    rng = np.random.default_rng(RNG_SEED + 4)
    x = rand_keys(rng, np.uint32, 3000)
    vals = rng.integers(0, 2**32, size=3000, dtype=np.uint32)
    perm = np.argsort(x, kind="stable")
    assert_bits_equal(tthrs.sort_keys(to_torch(x), method=method), x[perm])
    k, v = tthrs.sort_pairs(to_torch(x), to_torch(vals), method=method)
    assert_bits_equal(k, x[perm])
    assert_bits_equal(v, vals[perm])
    with pytest.raises(AssertionError, match="tuning"):
        tthrs.sort_keys(to_torch(x), method="bitonic")


@pytest.mark.parametrize("method", METHODS)
def test_segment_ids_in_rows_parity(method):
    rng = np.random.default_rng(RNG_SEED + 3)
    x = rand_keys(rng, np.uint32, 3 * 400).reshape(3, 400)
    seg = np.sort(rng.integers(0, 5, size=(3, 400)), axis=1).astype(np.int32)
    vals = rng.integers(0, 2**32, size=(3, 400), dtype=np.uint32)
    check_port(x, vals, method, f"{method} rows+segments", segment_ids=seg)


@pytest.mark.parametrize("offsets", [[0, 3, 7], [3, 7], [0, 0, 3, 7, 10],
                                     [], [0], [10]], ids=str)
def test_segment_ids_from_offsets_parity(offsets):
    n = 10
    got = tthrs.segment_ids_from_offsets(torch.tensor(offsets,
                                                      dtype=torch.int32), n)
    want = np.asarray(jthrs.segment_ids_from_offsets(
        jnp.asarray(np.array(offsets, np.int32)), n))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_segment_ids_from_offsets_feeds_a_segmented_sort():
    rng = np.random.default_rng(RNG_SEED + 4)
    n = 4097
    offs = np.sort(rng.integers(0, n, size=40)).astype(np.int32)
    x = rand_keys(rng, np.uint32, n)
    seg = tthrs.segment_ids_from_offsets(to_torch(offs), n)
    for method in METHODS:
        got = tthrs.sort_indices(to_torch(x), segment_ids=seg, method=method)
        np.testing.assert_array_equal(
            got.numpy(), np.lexsort((x, seg.numpy())), err_msg=method)


def test_portable_validation():
    x = torch.arange(8, dtype=torch.int32)
    for method in METHODS:
        with pytest.raises(ValueError):
            tthrs.sort_keys(x, segment_ids=torch.zeros(9, dtype=torch.int32),
                            method=method)
        with pytest.raises(TypeError):
            tthrs.sort_keys(x, segment_ids=torch.zeros(8), method=method)
        with pytest.raises(TypeError):
            tthrs.sort_keys(x, segment_ids=torch.zeros(8, dtype=torch.bool),
                            method=method)
        with pytest.raises(ValueError):
            tthrs.sort_keys(torch.zeros((2, 3, 4), dtype=torch.int32),
                            method=method)
        with pytest.raises(ValueError):
            tthrs.sort_pairs(x.view(2, 4), torch.zeros(2, 5), method=method)
        # narrow integer ids widen
        out = tthrs.sort_keys(x.flip(0), method=method,
                              segment_ids=torch.zeros(8, dtype=torch.uint8))
        assert_bits_equal(out, np.arange(8, dtype=np.int32))
    for shape in ((3, 0), (3, 1), (0, 5)):
        z = torch.zeros(shape, dtype=torch.uint32)
        for method in METHODS:
            k, v = tthrs.sort_pairs(z, z.view(torch.int32), method=method)
            assert k.shape == z.shape and v.shape == z.shape


def test_counting_engine_uses_the_histogram_on_cpu_tensors_only():
    before = th.KERNEL_LAUNCHES
    x = rand_keys(np.random.default_rng(5), np.uint32, 5000)
    assert_bits_equal(tthrs.sort_keys(to_torch(x), method="counting"),
                      np.sort(x))
    assert th.KERNEL_LAUNCHES == before  # plain version on CPU tensors
    with pytest.raises(ValueError):
        counting_engine.sort_arrays_counting(
            to_torch(x).view(torch.int32), [to_torch(x)], 0, 32, tile=1000)


def test_non_tensor_inputs_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.arange(16, dtype=np.uint32)[::-1].copy()
    for call in (lambda: tthrs.sort_keys(x),
                 lambda: tthrs.sort_keys(list(x), method="counting"),
                 lambda: tthrs.sort_pairs(to_torch(x), x),
                 lambda: tthrs.sort_indices(to_torch(x), method="argsort",
                                            segment_ids=np.zeros(16, np.int32)),
                 lambda: tthrs.segment_ids_from_offsets([0, 4], 16),
                 lambda: tthrs.RadixSort().sort_keys(x)):
        with pytest.raises(RuntimeError, match="pass a CPU tensor"):
            call()
    # a CPU tensor is the caller's request for the CPU
    out = tthrs.sort_keys(to_torch(x), method="counting")
    assert out.device.type == "cpu"
    assert_bits_equal(out, np.sort(x))


def test_non_tensor_inputs_go_to_the_cuda_device(monkeypatch):
    seen = []
    as_tensor = torch.as_tensor

    def fake_as_tensor(data, device=None):
        seen.append(device)
        return as_tensor(data)  # stays on the CPU here: no card

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tsort.torch, "as_tensor", fake_as_tensor)
    keys = np.arange(8, dtype=np.int32)
    tsort._as_input(keys, "keys")
    tsort._as_input([1, 2, 3], "values")
    assert seen == ["cuda", "cuda"]
    t = torch.arange(3)
    assert tsort._as_input(t, "keys") is t  # tensors keep their device
    assert seen == ["cuda", "cuda"]


@pytest.mark.parametrize("n", [4096, 3000], ids=["whole-tiles", "ragged"])
@pytest.mark.parametrize("order", ["ascending", "descending"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_counting_keys_from_the_sorted_bits_equal_argsorts(dtype, order, n):
    # counting rebuilds the keys from its sorted bits (float keys with a
    # -0.0 flag: rand_keys holds -0.0, +0.0 and NaNs of distinct payloads);
    # argsort carries the keys themselves
    rng = np.random.default_rng([n, len(order), np.dtype(dtype).itemsize])
    x = rand_keys(rng, dtype, n)
    x[::7] = x[3]  # ties: stability decides
    xt = to_torch(x)
    want = tthrs.sort_keys(xt, order=order, method="argsort")
    assert_bits_equal(tthrs.sort_keys(xt, order=order, method="counting"),
                      want)
    k, v = tthrs.sort_pairs(xt, torch.arange(n), order=order,
                            method="counting")
    assert_bits_equal(k, want)
    assert_bits_equal(xt[v], want)
    assert_bits_equal(xt, x, "inputs are never modified")


_VIEWS = {
    "n=0": lambda a: a[:0],
    "n=1": lambda a: a[:1],
    "n=2048": lambda a: a[:2048],
    "rows": lambda a: a[:3 * 2048].view(3, 2048),
    "non-contiguous": lambda a: a[::2],
    "offset-slice": lambda a: a[1:2049],
}


@pytest.mark.parametrize("dtype", [np.uint32, np.float32],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("view", list(_VIEWS))
def test_counting_outputs_share_no_memory_with_inputs(view, dtype):
    # u32 bits are a view of the keys, and whole tiles go to the first
    # pass where they lie: every output must still be fresh memory
    rng = np.random.default_rng(len(view))
    keys = to_torch(rand_keys(rng, dtype, 8192))
    vals = torch.from_numpy(rng.integers(-2**31, 2**31, size=8192,
                                         dtype=np.int32))
    saved = keys.clone(), vals.clone()
    k, v = _VIEWS[view](keys), _VIEWS[view](vals)
    outs, wants = [], []
    for method, got in (("counting", outs), ("argsort", wants)):
        got.append(tthrs.sort_keys(k, method=method))
        got.extend(tthrs.sort_pairs(k, v, method=method))
        got.append(tthrs.sort_indices(k, method=method))
    for got, want in zip(outs, wants):
        assert_bits_equal(got, want)
        if got.numel():
            for a in (keys, vals):
                assert (got.untyped_storage().data_ptr()
                        != a.untyped_storage().data_ptr())
    assert_bits_equal(keys, saved[0])
    assert_bits_equal(vals, saved[1])


def test_counting_refuses_an_empty_window_before_any_copy():
    x = to_torch(rand_keys(np.random.default_rng(9), np.uint32, 3000))
    with tracing.record() as rec:
        with pytest.raises(ValueError, match="bit window"):
            tthrs.sort_keys(x, start_bit=8, end_bit=8, method="counting")
        with pytest.raises(ValueError, match="bit window"):
            counting_engine.sort_arrays_counting(x.view(torch.int32), [x],
                                                 8, 8)
    assert rec.counts == {}


@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.uint64, np.int64,
                                   np.uint16, np.int16, np.float32,
                                   np.float64],
                         ids=lambda d: np.dtype(d).name)
def test_counting_hands_rank_scatter_what_the_bits_cannot_rebuild(
        dtype, monkeypatch):
    # integer keys come back from the sorted bits alone, float keys with a
    # 1-byte -0.0 flag; sort_pairs adds its values
    seen = []
    real = counting_engine.rank_scatter

    def spy(bits, shift, width, base, tile, idx_dtype, payloads=(),
            want_src=True):
        seen.append([counting_engine.payload_row_bytes(p, bits.shape[0])
                     for p in payloads])
        return real(bits, shift, width, base, tile, idx_dtype, payloads,
                    want_src)

    monkeypatch.setattr(counting_engine, "rank_scatter", spy)
    rng = np.random.default_rng(np.dtype(dtype).itemsize)
    x = to_torch(rand_keys(rng, dtype, 4096))
    flag = [1] if np.dtype(dtype).kind == "f" else []
    passes = np.dtype(dtype).itemsize  # one 8-bit digit a byte
    want = tthrs.sort_keys(x, method="argsort")
    assert_bits_equal(tthrs.sort_keys(x, method="counting"), want)
    assert seen == [flag] * passes
    seen.clear()
    k, _ = tthrs.sort_pairs(x, torch.arange(4096, dtype=torch.int32),
                            method="counting")
    assert_bits_equal(k, want)
    assert seen == [flag + [4]] * passes
