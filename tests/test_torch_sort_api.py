"""The PyTorch port's public API: bit windows, float specials, payload
trees, larger sizes against the numpy oracles, and what the bitonic engine
still refuses.

Parity cases run the JAX package with ``method="pallas"`` (interpreted on
the CPU) and compare bit-exactly on unsigned views.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinyhipradixsort_torch as tthrs
import tinyhipradixsort_tpu as jthrs
from tests import oracles
from tests.torch_helpers import assert_bits_equal, rand_keys, to_torch
from tinyhipradixsort_torch.ops import bitonic_engine as tbe
from tinyhipradixsort_torch.ops import network_engine

RNG_SEED = 0x7041


@pytest.mark.parametrize("dtype,n,start,end", [
    (np.uint32, 2000, 8, 16),   # window + index packed into one word
    (np.uint32, 768, 8, 30),    # packing at exactly 32 bits (non-pow2 n)
    (np.uint32, 512, 0, 23),    # pow2 n at 32 bits: packing must not apply
    (np.int32, 1500, 4, 17),
    (np.uint64, 1500, 8, 48),   # window hides key bits: keys ride as carries
])
def test_window_parity(dtype, n, start, end):
    rng = np.random.default_rng(RNG_SEED + n)
    x = rand_keys(rng, dtype, n)
    x[::7] = x[3]  # duplicates: ties inside the window
    vals = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    jk, jv = jthrs.sort_pairs(jnp.asarray(x), jnp.asarray(vals),
                              start_bit=start, end_bit=end, method="pallas")
    k, v = tthrs.sort_pairs(to_torch(x), to_torch(vals), start_bit=start,
                            end_bit=end, method="bitonic")
    assert_bits_equal(k, np.asarray(jk))
    assert_bits_equal(v, np.asarray(jv))
    perm = tthrs.sort_indices(to_torch(x), start_bit=start, end_bit=end,
                              method="bitonic")
    np.testing.assert_array_equal(
        perm.numpy(), oracles.oracle_perm(x, start_bit=start, end_bit=end))


@pytest.mark.parametrize("dtype,order", [(np.float32, "ascending"),
                                         (np.float64, "descending")])
def test_float_specials_tagged_zero_parity(dtype, order):
    # -0.0 runs, NaNs with payloads of both signs, +-inf, denormals
    rng = np.random.default_rng(RNG_SEED)
    x = rand_keys(rng, dtype, 1000)
    tiny = np.finfo(dtype).tiny
    x[:8] = np.array([-0.0, 0.0, -0.0, tiny / 4, -tiny / 4, -np.inf, np.inf,
                      -0.0], dtype=dtype)
    jk = jthrs.sort_keys(jnp.asarray(x), order=order, method="pallas")
    assert_bits_equal(tthrs.sort_keys(to_torch(x), order=order,
                                      method="bitonic"), np.asarray(jk))
    jp = jthrs.sort_indices(jnp.asarray(x), order=order, method="pallas")
    np.testing.assert_array_equal(
        tthrs.sort_indices(to_torch(x), order=order,
                           method="bitonic").numpy(), np.asarray(jp))


def test_zeros_exact_false_parity():
    x = np.array([3.5, -0.0, 0.0, -1.25, np.inf, -np.inf, np.nan] * 150,
                 dtype=np.float32)
    jk = jthrs.sort_keys(jnp.asarray(x), method="pallas", zeros_exact=False)
    got = tthrs.sort_keys(to_torch(x), zeros_exact=False, method="bitonic")
    assert_bits_equal(got, np.asarray(jk))
    assert not (got.view(torch.int32) == -2**31).any()


@pytest.mark.parametrize("kdtype,order", [(np.int32, "descending")])
def test_payload_tree_parity(kdtype, order):
    n = 1500
    rng = np.random.default_rng(RNG_SEED + 1)
    x = rand_keys(rng, kdtype, n)
    values = {
        "u64": rng.integers(0, 2**64, size=n, dtype=np.uint64),
        "u128": rng.integers(0, 2**32, size=(n, 4), dtype=np.uint32),
        "f32": rand_keys(rng, np.float32, n),
        "f64": rand_keys(rng, np.float64, n),
        "u8": rng.integers(0, 256, size=n, dtype=np.uint8),
    }
    jk, jv = jthrs.sort_pairs(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in values.items()},
        order=order, method="pallas")
    k, v = tthrs.sort_pairs(
        to_torch(x), {"nested": [to_torch(values["u64"]),
                                 (to_torch(values["u128"]),)],
                      **{k: to_torch(values[k]) for k in ("f32", "f64", "u8")}},
        order=order, method="bitonic")
    assert_bits_equal(k, np.asarray(jk))
    assert_bits_equal(v["nested"][0], np.asarray(jv["u64"]))
    assert isinstance(v["nested"][1], tuple)
    assert_bits_equal(v["nested"][1][0], np.asarray(jv["u128"]))
    for name in ("f32", "f64", "u8"):
        assert v[name].dtype == to_torch(values[name]).dtype
        assert_bits_equal(v[name], np.asarray(jv[name]))


@pytest.mark.parametrize("kind,dtype,n,desc", [
    ("keys", np.uint32, 1 << 16, False),
    ("pairs", np.uint32, 1 << 16, False),  # __graft_entry__.entry's case
    ("keys", np.float32, 1 << 15, False),
    ("pairs", np.uint64, 1 << 14, True),
    ("indices", np.int64, (1 << 14) + 3, False),
    ("keys", np.int32, (1 << 16) - 1, True),
], ids=lambda p: getattr(p, "__name__", str(p)))
def test_port_against_numpy_oracles(kind, dtype, n, desc):
    order = "descending" if desc else "ascending"
    rng = np.random.default_rng(RNG_SEED + n)
    x = rand_keys(rng, dtype, n)
    want = oracles.oracle_perm(x, descending=desc)
    xt = to_torch(x)
    if kind == "keys":
        assert_bits_equal(tthrs.sort_keys(xt, order=order, method="bitonic"),
                          x[want])
    elif kind == "pairs":
        vals = rng.integers(0, 2**32, size=n, dtype=np.uint32)
        k, v = tthrs.sort_pairs(xt, to_torch(vals), order=order,
                                method="bitonic")
        assert_bits_equal(k, x[want])
        np.testing.assert_array_equal(v.numpy(), vals[want])
    else:
        np.testing.assert_array_equal(
            tthrs.sort_indices(xt, order=order, method="bitonic").numpy(),
            want)


def test_refuses_what_later_slices_port():
    # the bitonic engine ("auto" too) sorts 2-D keys, segment_ids= and
    # 16-bit keys bit-exactly as the portable engines do; what is refused
    # is a bad argument
    rng = np.random.default_rng(RNG_SEED + 3)
    x = torch.from_numpy(rng.integers(-2**31, 2**31, size=1200,
                                      dtype=np.int64).astype(np.int32))
    seg = torch.from_numpy(rng.integers(0, 7, size=1200).astype(np.int16))
    cases = [
        ("2-D", dict(keys=x.reshape(6, 200))),
        ("segment_ids", dict(keys=x, segment_ids=seg)),
        ("int16", dict(keys=x.to(torch.int16))),
        ("bfloat16", dict(keys=(x >> 16).to(torch.int16).view(torch.bfloat16))),
    ]
    vals = torch.arange(1200, dtype=torch.int32)
    for label, kw in cases:
        v = vals.reshape(kw["keys"].shape)
        want = tthrs.sort_pairs(values=v, method="argsort", **kw)
        for method in ("auto", "bitonic", "counting", "lsd_argsort"):
            got = tthrs.sort_pairs(values=v, method=method, **kw)
            for g, w in zip(got, want):
                assert_bits_equal(g, w, f"{label} {method}")
        assert_bits_equal(tthrs.sort_indices(method="bitonic", **kw),
                          tthrs.sort_indices(method="argsort", **kw), label)
    with pytest.raises(ValueError):
        tthrs.sort_keys(x, method="pallas")
    with pytest.raises(ValueError):
        tthrs.sort_keys(x.reshape(2, 3, 200))
    with pytest.raises(ValueError):
        tthrs.sort_keys(x, segment_ids=seg[:100])
    with pytest.raises(TypeError):
        tthrs.sort_keys(x, segment_ids=seg.to(torch.float32))
    with pytest.raises(ValueError):
        tthrs.sort_keys(x, start_bit=8, end_bit=40)
    with pytest.raises(ValueError):
        tthrs.sort_pairs(x, torch.arange(63))
    with pytest.raises(ValueError):
        network_engine.sort_semantics(
            x.reshape(6, 200), [], descending=False, start_bit=0, end_bit=32,
            want=("indices",), tuning=tbe.EngineTuning(smem_tile_bytes=1024))


def test_unstable_and_donate_keep_the_stable_result():
    rng = np.random.default_rng(RNG_SEED + 2)
    x = (rng.integers(0, 8, size=3000)).astype(np.uint32)
    vals = np.arange(3000, dtype=np.uint32)
    xt, vt = to_torch(x), to_torch(vals)
    k, v = tthrs.sort_pairs(xt, vt, stable=False, donate=True, method="bitonic")
    want = np.argsort(x, kind="stable")
    np.testing.assert_array_equal(v.numpy(), vals[want])
    # donate writes the result into the caller's tensors and returns them
    assert k is xt and v is vt
    assert_bits_equal(xt, x[want])


def test_radix_sort_and_config():
    x = rand_keys(np.random.default_rng(3), np.uint64, 2048)
    rs = tthrs.RadixSort(tthrs.Config.for_keys(torch.uint64, "descending"),
                         method="bitonic")
    assert_bits_equal(rs.sort_keys(to_torch(x)),
                      oracles.oracle_sort_keys(x, descending=True))
    k, v = rs.sort_pairs(to_torch(x), torch.arange(2048), start_bit=0,
                         end_bit=8)
    want = oracles.oracle_perm(x, descending=True, start_bit=0, end_bit=8)
    np.testing.assert_array_equal(v.numpy(), want)
    with pytest.raises(TypeError):
        rs.sort_keys(torch.zeros(4, dtype=torch.float32))
    cfg = tthrs.Config.for_key_pairs(torch.float32, 16)
    assert cfg.key_type is tthrs.KeyType.F32 and cfg.key_type.bits == 32
    assert tthrs.RadixSort(cfg).temporary_buffer_bytes(1000) == \
        jthrs.RadixSort(jthrs.Config.for_key_pairs(np.float32, 16)) \
        .temporary_buffer_bytes(1000)


def test_word_helpers():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 2**64, size=64, dtype=np.uint64)
    hi, lo = tbe.split_u64(to_torch(a))
    assert_bits_equal(hi, (a >> np.uint64(32)).astype(np.uint32))
    assert_bits_equal(lo, a.astype(np.uint32))
    assert_bits_equal(tbe.join_u64(hi, lo), a)
    idx = torch.arange(8, dtype=torch.int32)
    assert tbe.check_word_contract([idx % 2], [])
    assert not tbe.check_word_contract([idx % 2], [idx])
    assert tbe.check_word_contract([idx % 2, idx], [idx])
    for arr in (rng.integers(-128, 128, size=64, dtype=np.int8),
                rng.random(64) < 0.5,
                rand_keys(rng, np.float16, 64)):
        t = to_torch(arr)
        ws, recipe = tbe.array_to_words(t)
        assert_bits_equal(tbe.words_to_array(ws, recipe), arr)
    before = tbe.KERNEL_LAUNCHES
    out = network_engine.sort_arrays(
        tthrs.key_bits(to_torch(a)), [to_torch(a)], 0, 64)
    assert_bits_equal(out[0], np.sort(a))
    assert tbe.KERNEL_LAUNCHES == before  # CPU tensors: the plain version
