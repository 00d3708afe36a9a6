"""The benchmark's ``u32_large`` deployment (the reference's SortKeys.u32Large,
2**31 + 100 u32 keys) at small sizes: its blocked plain reference
(``sortbench/references/stable_sort_blocked.py``) against the unblocked
one with many blocks, the counting engine with its int64 offsets forced
and a ragged last tile against that reference (on the CPU, and on the card
where there is one), what the recorder keeps of the offsets' width and of
the staging's copies, the cell's files and metrics, and the reader
``staging_ms_per_call`` on hand-made records. Nothing here allocates near
2**31 elements or imports JAX."""

import numpy as np
import pytest
import torch

import tinyhipradixsort_torch as tthrs
from sortbench import cells, run
from sortbench.records import Call, Records
from sortbench.references import stable_sort, stable_sort_blocked
from tinyhipradixsort_torch import tracing
from tinyhipradixsort_torch.ops import counting_engine as tce

TILE = tce.DEFAULT_TILE
RAGGED = 3 * TILE + 100  # u32Large's 2**31 + 100 in small: a ragged last tile
WHOLE = 4 * TILE
CELL = "u32_large.bulk-2p31"


def _signed(t):
    return t.view(stable_sort._SIGNED[t.dtype.itemsize])


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(_signed(got.cpu()), _signed(want.cpu()))


def _u32(n, seed, ties=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, n, dtype=np.uint32)
    if ties:  # keys drawn from a few values, so equal keys meet
        x = x[rng.integers(0, ties, n)]
    return torch.from_numpy(x)


def _u64(n, seed):
    x = np.random.default_rng(seed).integers(0, 2**64, n, dtype=np.uint64,
                                             endpoint=False)
    return torch.from_numpy(x)


def _f32_specials(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    pick = rng.integers(0, 6, n)
    for k, v in enumerate((np.nan, np.inf, -np.inf, -0.0, 0.0)):
        x[pick == k] = v
    x[rng.integers(0, n, 8)] = -np.float32(np.nan)
    return torch.from_numpy(x)


def _config(**kw):
    return {**cells.CONFIG_DEFAULTS, "api": "sort_keys",
            "key_dtype": "uint32", **kw}


REFERENCE_CASES = {  # keys, values, config
    "u32-keys": (lambda n: _u32(n, 1), None, {}),
    "u32-pairs": (lambda n: _u32(n, 2, ties=40), torch.uint32, {}),
    "u64-pairs": (lambda n: _u64(n, 3), torch.uint64, {}),
    "u64-pairs-descending": (lambda n: _u64(n, 4), torch.uint64,
                             {"order": "descending"}),
    "f32-specials": (lambda n: _f32_specials(n, 5), torch.int32, {}),
    "u32-descending": (lambda n: _u32(n, 6, ties=40), torch.int32,
                       {"order": "descending"}),
    "u32-16-bit-window": (lambda n: _u32(n, 7), torch.int32,
                          {"start_bit": 8, "end_bit": 24}),
}


@pytest.fixture
def small_blocks(monkeypatch):
    """Blocks of 64 keys, far below the cell's, so that the blocks are
    many at a test's size."""
    monkeypatch.setattr(stable_sort_blocked, "BLOCK_KEYS", 64)


@pytest.mark.parametrize("n", [RAGGED, 5003])
@pytest.mark.parametrize("case", list(REFERENCE_CASES))
def test_the_blocked_reference_is_the_stable_sort(small_blocks, case, n):
    make, value_dt, cfg = REFERENCE_CASES[case]
    keys = make(n)
    values = None if value_dt is None else \
        torch.arange(n, dtype=torch.int64).to(value_dt)
    config = _config(**cfg)
    window = (config["end_bit"] or 8 * keys.dtype.itemsize) - \
        config["start_bit"]
    assert stable_sort_blocked.block_bits(n, window) == 7
    got = stable_sort_blocked.expected(keys, values, config)
    want = stable_sort.expected(keys, values, config)
    assert len(got) == len(want) == 1 + (values is not None)
    for g, w in zip(got, want):
        _same(g, w)


def test_the_blocked_reference_takes_1d_keys_only():
    with pytest.raises(ValueError, match="1-D keys"):
        stable_sort_blocked.expected(_u32(600, 8).view(3, 200), None,
                                     _config())


def test_the_cell_sorts_in_at_least_eight_blocks():
    cfg = cells.config("u32_large")
    n = cells.traffic("bulk-2p31")["n"]
    bits = stable_sort_blocked.block_bits(n, cfg["end_bit"] - cfg["start_bit"])
    assert 1 << bits >= 8
    # the most keys a block of evenly spread keys holds
    assert n >> bits <= stable_sort_blocked.BLOCK_KEYS


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device(request.param)


@pytest.fixture
def wide_offsets(monkeypatch):
    """The counting engine with int64 offsets at any length, as it takes
    them from 2**31 padded elements on."""
    monkeypatch.setattr(tce, "_index_dtype", lambda n: torch.int64)


@pytest.mark.parametrize("n", [RAGGED, WHOLE], ids=["ragged", "whole-tiles"])
@pytest.mark.parametrize("api", ["sort_keys", "sort_pairs"])
def test_counting_with_int64_offsets_matches_the_reference(device, wide_offsets,
                                                           small_blocks, api,
                                                           n):
    keys = _u32(n, n, ties=0 if api == "sort_keys" else 50)
    values = torch.arange(n, dtype=torch.int32).view(torch.uint32)
    cfg = cells.config("u32_large")
    kw = {"method": "counting", "start_bit": cfg["start_bit"],
          "end_bit": cfg["end_bit"], "order": cfg["order"]}
    with tracing.record() as rec:
        if api == "sort_keys":
            got = [tthrs.sort_keys(keys.to(device), **kw)]
        else:
            got = list(tthrs.sort_pairs(keys.to(device), values.to(device),
                                        **kw))
    sort = next(s for s in rec.spans if s.name == "counting.sort")
    assert sort.attrs["idx_bytes"] == 8
    want = stable_sort_blocked.expected(
        keys, values if api == "sort_pairs" else None, cfg)
    for g, w in zip(got, want):
        assert g.device.type == device.type
        _same(g, w)


PAD_CASES = {  # api, key dtype, value dtype -> bytes a padded element
    "u32-keys": ("sort_keys", torch.uint32, None, 4),
    "u32-pairs": ("sort_pairs", torch.uint32, torch.uint32, 4 + 4),
    "u64-pairs": ("sort_pairs", torch.uint64, torch.uint64, 8 + 8),
}


@pytest.mark.parametrize("wide", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("n", [RAGGED, WHOLE], ids=["ragged", "whole-tiles"])
@pytest.mark.parametrize("case", list(PAD_CASES))
def test_counting_records_its_offsets_width_and_pad_bytes(monkeypatch, case,
                                                          n, wide):
    if wide:
        monkeypatch.setattr(tce, "_index_dtype", lambda n: torch.int64)
    api, key_dt, val_dt, per_element = PAD_CASES[case]
    keys = (_u32(n, 9) if key_dt == torch.uint32 else _u64(n, 9))
    args = (keys,) if val_dt is None else \
        (keys, torch.arange(n, dtype=torch.int64).to(
            torch.int32 if val_dt == torch.uint32 else torch.int64)
         .view(val_dt))

    def call():
        return getattr(tthrs, api)(*args, method="counting")

    call()  # off: nothing is recorded
    assert tracing._REC is None
    with tracing.record() as rec:
        call()
    sort = next(s for s in rec.spans if s.name == "counting.sort")
    assert sort.attrs["idx_bytes"] == (8 if wide else 4)
    npad = -(-n // TILE) * TILE
    ragged = n % TILE != 0
    assert rec.counts.get((1, "counting.pad_bytes"), 0) == \
        ragged * npad * per_element
    assert rec.counts.get((1, "counting.pad_copies"), 0) == \
        ragged * len(args)


def test_counting_takes_int64_offsets_from_two_to_the_31():
    assert tce._index_dtype(2**31 - 1) == torch.int32
    assert tce._index_dtype(2**31) == torch.int64
    # the cell's padded length
    npad = -(-cells.traffic("bulk-2p31")["n"] // TILE) * TILE
    assert npad == 2**31 + TILE and tce._index_dtype(npad) == torch.int64


# -- the cell's files and metrics -----------------------------------------

BULK = ("keys_per_s", "call_p95_ms")
LAYERS = ("host_ms_per_call", "launches_per_call", "lsd_pass_roofline",
          "device_idle_share", "rank_scatter_roofline", "staging_ms_per_call")


def test_the_configuration_and_traffic_load_by_name():
    cfg = cells.config("u32_large")
    assert (cfg["api"], cfg["key_dtype"], cfg["values"]) == \
        ("sort_keys", "uint32", None)
    assert (cfg["start_bit"], cfg["end_bit"], cfg["order"],
            cfg["reference"]) == (0, 32, "ascending", "stable_sort_blocked")
    t = cells.traffic("bulk-2p31")
    assert t["n"] == 2**31 + 100 and t["keys"] == {"dist": "uniform"}
    assert (t["method"], t["pool"], t["checked_calls"], t["ranks"]) == \
        ("auto", 1, 3, 1)
    cell = run.Cell(cells.benchmark(), CELL)
    assert cell.window_bits() == 32 and cell.entry["chips"] == 1
    assert cell.reference is not None
    entry = next(c for c in cells.benchmark()["configs"]
                 if c["name"] == "u32_large")
    assert entry["reduced"] == [] and entry["source"] == cfg["source"]


def test_the_cell_reports_the_bulk_metrics_and_its_layers():
    bench = cells.benchmark()
    e2e = {m["name"] for m in cells.metrics(bench, CELL, False)}
    layer = {m["name"] for m in cells.metrics(bench, CELL, True)}
    assert e2e == {*BULK, "sort_bytes_per_key", "setup_s"}
    assert layer == set(LAYERS)
    for m in cells.metrics(bench, CELL, True):
        assert m["moves"] in e2e
    # the staging metric is this cell's alone
    for w in bench["workloads"]:
        if w["name"] != CELL:
            assert "staging_ms_per_call" not in {
                m["name"] for m in cells.metrics(bench, w["name"], True)}


def _records(events):
    calls = [Call(0.000, 0.001, 0.010), Call(0.012, 0.013, 0.030)]
    return Records(keys_per_call=1000, keys_per_rank=1000, key_bytes=4,
                   value_bytes=0, window_bits=32, calls=calls,
                   window=(0.0, 0.031), setup_s=7.5, device_events=events,
                   peaks={"bytes_per_s": 3.35e12})


def test_staging_reads_the_copies_and_fills_inside_the_calls():
    events = [
        ("Memcpy DtoD (Device -> Device)", 0.0015, 0.0045),
        ("void at::native::vectorized_elementwise_kernel<4, "
         "at::native::FillFunctor<int> >(...)", 0.0045, 0.0046),
        ("void rank_scatter_kernel<unsigned int, long long>(...)",
         0.005, 0.009),
        ("void digit_histogram_runs_kernel<unsigned int>(...)",
         0.0046, 0.005),
        # the harness's copy of a sampled answer, between the calls
        ("Memcpy DtoD (Device -> Device)", 0.0102, 0.0115),
        ("Memset (Device)", 0.0131, 0.0132),
        ("Memcpy DtoD (Device -> Device)", 0.0133, 0.0163),
    ]
    got = cells.reader("staging_ms_per_call")(_records(events))
    assert got == pytest.approx(1e3 * (0.003 + 0.0001 + 0.0001 + 0.003) / 2)


def test_staging_reads_zero_without_such_operations_and_none_untraced():
    read = cells.reader("staging_ms_per_call")
    kernels = [("void rank_scatter_kernel<unsigned int, int>(...)",
                0.002, 0.008)]
    assert read(_records(kernels)) == 0.0
    assert read(_records([])) == 0.0
    assert read(_records(None)) is None
