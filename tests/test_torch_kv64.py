"""``sort_pairs`` of u64 keys with u64 payloads (the benchmark's
``u64_pairs`` deployment, the reference's SortPairs.K64V64) on the CPU,
held bit for bit against the benchmark's plain reference
(``sortbench/references/stable_sort.py``) with that configuration, through
``method="counting"`` (eight 8-bit passes, the plain ``rank_scatter``) and
``"auto"``; and the reference itself against numpy's stable argsort.
Nothing here imports JAX."""

import numpy as np
import pytest
import torch

import tinyhipradixsort_torch as tthrs
from sortbench import cells
from sortbench.references import stable_sort

TILE = 2048  # the counting engine's tile


def _keys(n, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "uniform":  # every 64-bit pattern: half have the top bit set
        return rng.integers(0, 2**64, n, dtype=np.uint64, endpoint=False)
    if kind == "top-bit":  # every key at or above 2**63
        return rng.integers(0, 2**63, n, dtype=np.uint64) | np.uint64(1 << 63)
    if kind == "ties":  # 16 values spread over the 64 bits
        values = rng.integers(0, 2**64, 16, dtype=np.uint64, endpoint=False)
        return values[rng.integers(0, 16, n)]
    raise ValueError(kind)


def _as_int64(t):
    return t.view(torch.int64)


CASES = [(10_000, "uniform"), (3 * TILE + 1, "uniform"), (4 * TILE, "uniform"),
         (10_000, "top-bit"), (5_000, "ties")]


@pytest.mark.parametrize("method", ["counting", "auto"])
@pytest.mark.parametrize("n,kind", CASES,
                         ids=[f"{k}-{n}" for n, k in CASES])
def test_kv64_pairs_match_the_plain_reference(method, n, kind):
    cfg = cells.config("u64_pairs")
    assert (cfg["key_dtype"], cfg["value_dtype"]) == ("uint64", "uint64")
    keys = torch.from_numpy(_keys(n, kind, seed=n))
    values = torch.arange(n, dtype=torch.int64).view(torch.uint64)
    got_k, got_v = tthrs.sort_pairs(keys, values, method=method,
                                    start_bit=cfg["start_bit"],
                                    end_bit=cfg["end_bit"],
                                    order=cfg["order"])
    want_k, want_v = stable_sort.expected(keys, values, cfg)
    assert got_k.dtype == torch.uint64 and got_v.dtype == torch.uint64
    assert torch.equal(_as_int64(got_k), _as_int64(want_k))
    assert torch.equal(_as_int64(got_v), _as_int64(want_v))
    if kind == "ties":  # the payload order inside each run of equal keys
        k, v = _as_int64(got_k).numpy(), _as_int64(got_v).numpy()
        same = k[1:] == k[:-1]
        assert same.sum() > n - 20 and (v[1:][same] > v[:-1][same]).all()


@pytest.mark.parametrize("kind", ["uniform", "top-bit", "ties"])
def test_the_reference_orders_u64_keys_as_numpy_does(kind):
    keys = _keys(6_000, kind, seed=7)
    values = torch.arange(keys.size, dtype=torch.int64).view(torch.uint64)
    got_k, got_v = stable_sort.expected(torch.from_numpy(keys.copy()), values,
                                        cells.config("u64_pairs"))
    order = np.argsort(keys, kind="stable")
    assert np.array_equal(got_k.numpy(), keys[order])
    assert np.array_equal(_as_int64(got_v).numpy(), order)
