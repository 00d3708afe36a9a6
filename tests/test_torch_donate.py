"""``method="auto"`` follows the keys' device and what the call shows, and
``donate=True`` writes the result into the caller's tensors (the
reference's result-replaces-input rule, hpp:936-943; the JAX package
donates the buffers).

On CPU tensors ``"auto"`` is the argsort engine, as the JAX package picks
argsort off the TPU: no bitonic route is taken. On CUDA tensors it is the
counting engine for 1-D keys from ``sort.AUTO_COUNTING_MIN_N`` with no
``segment_ids`` and no ``donate``, and the bitonic network for every
other call. A donated sort returns the
caller's own tensors holding the stable result, bit-exact against the JAX
package, and on a route without padding the network sweeps the caller's
storage itself.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinyhipradixsort_torch as tthrs
import tinyhipradixsort_tpu as jthrs
from tests.torch_helpers import assert_bits_equal, rand_keys, to_torch
from tinyhipradixsort_torch import sort as tsort
from tinyhipradixsort_torch.ops import bitonic_engine as tbe

RNG_SEED = 0xD0A7


def _routes(monkeypatch):
    routes = []
    monkeypatch.setattr(tbe, "MARK", lambda event, name, words: routes.append(
        name) if event == "route" else None)
    return routes


def _swept(monkeypatch):
    """data_ptr of the first word of every sweep the engine runs."""
    ptrs = []
    real = tbe.run_sweep

    def spy(words, sweep, ncmp):
        ptrs.append(words[0].data_ptr())
        return real(words, sweep, ncmp)

    monkeypatch.setattr(tbe, "run_sweep", spy)
    return ptrs


def test_auto_on_cpu_runs_argsort(monkeypatch):
    routes = _routes(monkeypatch)
    calls = []
    real = tsort._PORTABLE["argsort"]
    monkeypatch.setitem(tsort._PORTABLE, "argsort",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x = rand_keys(np.random.default_rng(RNG_SEED), np.uint32, 5000)
    v = np.arange(5000, dtype=np.uint32)
    assert_bits_equal(tthrs.sort_keys(to_torch(x)), np.sort(x))
    k, vv = tthrs.sort_pairs(to_torch(x), to_torch(v))
    assert_bits_equal(vv, np.argsort(x, kind="stable"))
    tthrs.RadixSort().sort_keys(to_torch(x))
    assert routes == [] and len(calls) == 3
    assert tsort._resolve_method("auto", to_torch(x)) == "argsort"
    tthrs.sort_keys(to_torch(x), method="bitonic")
    assert routes[:1] == ["segmented"]


_MIN = tsort.AUTO_COUNTING_MIN_N


class _Keys:
    """What the route reads of a keys tensor (device, ndim, numel), at
    sizes no test allocates and on a device this machine may lack."""

    def __init__(self, device, *shape):
        self.device, self.ndim, self._n = (torch.device(device), len(shape),
                                           math.prod(shape))

    def numel(self):
        return self._n


@pytest.mark.parametrize("method,keys,kw,want", [
    pytest.param("auto", _Keys("cuda", _MIN), {}, "counting", id="at-the-min"),
    pytest.param("auto", _Keys("cuda", 160_000_000), {}, "counting",
                 id="160M"),
    pytest.param("auto", _Keys("cuda", 2**31 - 1), {}, "counting",
                 id="below-2**31"),
    pytest.param("auto", _Keys("cuda", _MIN - 1), {}, "bitonic",
                 id="one-below-the-min"),
    pytest.param("auto", _Keys("cuda", 1 << 20), {}, "bitonic", id="1M"),
    pytest.param("auto", _Keys("cuda", 0), {}, "bitonic", id="empty"),
    pytest.param("auto", _Keys("cuda", 4096, 4096), {}, "bitonic",
                 id="2-D-rows"),
    pytest.param("auto", _Keys("cuda", _MIN), dict(segmented=True), "bitonic",
                 id="segment_ids"),
    pytest.param("auto", _Keys("cuda", _MIN), dict(donate=True), "bitonic",
                 id="donate"),
    pytest.param("auto", _Keys("cuda", 1, _MIN), {}, "bitonic",
                 id="one-2-D-row"),
    pytest.param("auto", _Keys("cuda:1", _MIN), {}, "counting",
                 id="second-card"),
    pytest.param("auto", _Keys("cuda", 2 * _MIN),
                 dict(segmented=True, donate=True), "bitonic",
                 id="segment_ids-donated"),
    pytest.param("auto", _Keys("cuda", 2**31), {}, "counting", id="2**31"),
    pytest.param("auto", _Keys("cuda", 2**31 + 100), {}, "counting",
                 id="u32Large"),
    pytest.param("auto", _Keys("cpu", _MIN), {}, "argsort", id="cpu"),
    pytest.param("auto", _Keys("cpu", 8, 8), {}, "argsort", id="cpu-rows"),
    pytest.param("bitonic", _Keys("cuda", _MIN), {}, "bitonic",
                 id="explicit-bitonic"),
    pytest.param("counting", _Keys("cuda", 8, 8), dict(segmented=True),
                 "counting", id="explicit-counting"),
    pytest.param("argsort", _Keys("cuda", _MIN), {}, "argsort",
                 id="explicit-argsort"),
    pytest.param("lsd_argsort", _Keys("cpu", 0), {}, "lsd_argsort",
                 id="explicit-lsd_argsort"),
])
def test_auto_resolves_by_what_the_call_shows(method, keys, kw, want):
    assert tsort._resolve_method(method, keys, **kw) == want


def test_the_route_reads_what_the_call_carries(monkeypatch):
    # the public calls hand the route the keys as validated, whether
    # segment ids came and the donation; a THRS_* knob of the network does
    # not move it
    seen = []
    real = tsort._resolve_method
    monkeypatch.setattr(tsort, "_resolve_method", lambda method, keys, **kw:
                        seen.append((method, tuple(keys.shape), kw))
                        or real(method, keys, **kw))
    monkeypatch.setenv("THRS_CROSS_G_MAX", "6")
    x = to_torch(rand_keys(np.random.default_rng(RNG_SEED), np.uint32, 1200))
    tthrs.sort_keys(x, segment_ids=torch.zeros(1200, dtype=torch.int32))
    tthrs.sort_pairs(x.view(3, 400), x.view(3, 400), method="bitonic")
    tthrs.sort_indices(x.clone(), donate=True)
    assert seen == [
        ("auto", (1200,), dict(segmented=True, donate=False)),
        ("bitonic", (3, 400), dict(segmented=False, donate=False)),
        ("auto", (1200,), dict(segmented=False, donate=True)),
    ]
    with pytest.raises(ValueError, match="unknown method"):
        tsort._resolve_method("radix", x)


@pytest.mark.parametrize("dtype,n", [
    (np.uint32, 4096),     # one word, a view of the keys, swept in place
    (np.uint32, 3000),     # the segmented route
    (np.float32, 4096),    # tagged index word: keys rebuilt, then written
    (np.int64, 1000),      # padded: the result is copied in
])
def test_donated_keys_come_back_sorted_in_the_callers_tensor(dtype, n):
    x = rand_keys(np.random.default_rng(RNG_SEED + n), dtype, n)
    want = np.asarray(jthrs.sort_keys(jnp.asarray(x), method="pallas"))
    for method in ("bitonic", "argsort", "counting"):
        xt = to_torch(x)
        out = tthrs.sort_keys(xt, method=method, donate=True)
        assert out is xt, method
        assert_bits_equal(xt, want, method)


def test_donated_u32_keys_are_swept_where_they_lie(monkeypatch):
    x = rand_keys(np.random.default_rng(RNG_SEED), np.uint32, 1 << 12)
    ptrs = _swept(monkeypatch)
    xt = to_torch(x)
    tthrs.sort_keys(xt, method="bitonic", donate=True)
    assert ptrs and all(p == xt.data_ptr() for p in ptrs)
    assert_bits_equal(xt, np.sort(x))
    ptrs.clear()
    kept = to_torch(x)
    assert_bits_equal(tthrs.sort_keys(kept, method="bitonic"), np.sort(x))
    assert ptrs and all(p != kept.data_ptr() for p in ptrs)
    assert_bits_equal(kept, x)  # without donate the input is untouched


@pytest.mark.parametrize("n", [4096, 2500])
def test_donated_pairs_return_the_callers_leaves(n):
    rng = np.random.default_rng(RNG_SEED + 1)
    x = rng.integers(0, 64, size=n).astype(np.uint32)
    vals = {"u32": rng.integers(0, 2**32, size=n, dtype=np.uint32),
            "u64": rng.integers(0, 2**64, size=n, dtype=np.uint64)}
    jk, jv = jthrs.sort_pairs(jnp.asarray(x),
                              {k: jnp.asarray(v) for k, v in vals.items()},
                              method="pallas")
    for method in ("bitonic", "argsort"):
        xt = to_torch(x)
        vt = {k: to_torch(v) for k, v in vals.items()}
        k, v = tthrs.sort_pairs(xt, [vt["u32"], (vt["u64"],)], method=method,
                                donate=True)
        assert k is xt and v[0] is vt["u32"] and v[1][0] is vt["u64"]
        assert isinstance(v, list) and isinstance(v[1], tuple)
        assert_bits_equal(xt, np.asarray(jk), method)
        for name, t in vt.items():
            assert_bits_equal(t, np.asarray(jv[name]), f"{method} {name}")


def test_donated_rows_and_indices():
    rng = np.random.default_rng(RNG_SEED + 2)
    rows = rng.integers(0, 2**32, size=(8, 1024), dtype=np.uint32)
    xt = to_torch(rows)
    assert tthrs.sort_keys(xt, method="bitonic", donate=True) is xt
    assert_bits_equal(xt, np.sort(rows, axis=1))
    x = rng.integers(0, 9, size=3000).astype(np.int32)
    seg = np.sort(rng.integers(0, 4, size=3000)).astype(np.uint32)
    st = to_torch(seg)
    perm = tthrs.sort_indices(to_torch(x), method="bitonic", donate=True,
                              segment_ids=st)
    np.testing.assert_array_equal(perm.numpy(), np.lexsort((x, seg)))
    assert_bits_equal(st, seg)  # segment ids are never donated


def test_donate_refuses_what_it_would_have_to_copy():
    x = torch.arange(64, dtype=torch.int32).flip(0)
    with pytest.raises(ValueError, match="contiguous"):
        tthrs.sort_keys(x[::2], donate=True)
    with pytest.raises(ValueError, match="contiguous"):
        tthrs.sort_pairs(x, torch.zeros(64, 2, dtype=torch.int32)[:, 0],
                         donate=True)
    with pytest.raises(ValueError, match="share no memory"):
        tthrs.sort_pairs(x, x, donate=True)
    with pytest.raises(ValueError):
        tthrs.sort_pairs(x, torch.zeros(64, dtype=torch.int32, device="meta"),
                         donate=True)
    with pytest.raises(TypeError):
        tthrs.sort_keys(np.arange(64, dtype=np.int32), donate=True)
    with pytest.raises(TypeError):
        tthrs.sort_pairs(x, np.arange(64, dtype=np.int32), donate=True)
    assert_bits_equal(x, np.arange(64, dtype=np.int32)[::-1])
