"""The KV64 cell (``u64_pairs.bulk``) on the CPU: its files load by name,
it reports the metrics the bulk cells report and ``rank_scatter_roofline``,
that reader on hand-made records, the cell itself at a small size, and
the faults ``correct`` has to catch in it: the window's top digit left
out, and (on keys that tie above it) the control's lowest digit."""

from __future__ import annotations

import pytest

import tinyhipradixsort_torch as thrs
from sortbench import cells, control, run, stats
from sortbench.tests.test_sortbench_harness import (SEED, _records, _root,
                                                    _tiny)

CELL = "u64_pairs.bulk"
BULK = ("keys_per_s", "call_p95_ms")
LAYERS = ("host_ms_per_call", "launches_per_call", "lsd_pass_roofline",
          "device_idle_share")


def test_the_configuration_and_traffic_load_by_name():
    cfg = cells.config("u64_pairs")
    assert (cfg["api"], cfg["key_dtype"], cfg["value_dtype"],
            cfg["values"]) == ("sort_pairs", "uint64", "uint64", "arange")
    assert (cfg["start_bit"], cfg["end_bit"], cfg["order"],
            cfg["reference"]) == (0, 64, "ascending", "stable_sort")
    t = cells.traffic("bulk-2p28")
    assert t["n"] == 2**28 and t["keys"] == {"dist": "uniform"}
    assert (t["method"], t["pool"], t["checked_calls"], t["ranks"]) == \
        ("auto", 1, 3, 1)
    cell = run.Cell(cells.benchmark(), CELL)
    assert cell.window_bits() == 64 and cell.entry["chips"] == 1


def test_the_cell_reports_the_bulk_metrics_and_rank_scatters_roofline():
    bench = cells.benchmark()
    e2e = {m["name"] for m in cells.metrics(bench, CELL, False)}
    layer = {m["name"] for m in cells.metrics(bench, CELL, True)}
    assert e2e == {*BULK, "sort_bytes_per_key", "setup_s"}
    assert layer == {*LAYERS, "rank_scatter_roofline"}
    for m in cells.metrics(bench, CELL, True):
        assert m["moves"] in e2e
    # the new metric is this cell's alone
    for w in bench["workloads"]:
        if w["name"] != CELL:
            assert "rank_scatter_roofline" not in {
                m["name"] for m in cells.metrics(bench, w["name"], True)}


def test_rank_scatter_roofline_reads_the_kernels_time_alone():
    events = [("void rank_scatter_kernel<unsigned long, int>(...)",
               0.002, 0.006),
              ("void digit_histogram_runs_kernel<unsigned long>(...)",
               0.006, 0.007),
              ("void rank_scatter_kernel<unsigned long, int>(...)",
               0.012, 0.020), ("memset", 0.031, 0.032)]
    rec = _records(key_bytes=8, value_bytes=8, window_bits=64,
                   device_events=events)
    kernel_s = (0.004 + 0.008) / len(rec.calls)
    floor_s = 8 * 2 * 1000 * 16 / 3.35e12
    assert floor_s == stats.lsd_floor_bytes(1000, 8, 8, 64) / 3.35e12
    assert cells.reader("rank_scatter_roofline")(rec) == pytest.approx(
        100 * floor_s / kernel_s)


@pytest.mark.parametrize("kw", [{"device_events": None}, {"peaks": None},
                                {"device_events": [("k1", 0.0, 0.1)]}],
                         ids=["no-trace", "no-peaks", "no-such-kernel"])
def test_rank_scatter_roofline_without_its_kernel_reads_nothing(kw):
    assert cells.reader("rank_scatter_roofline")(_records(**kw)) is None


def _kv64_root(tmp_path, method, **traffic):
    bench = _root(tmp_path, _tiny(method, n=5000, **traffic))
    bench["workloads"].append({"name": "u64_pairs.tiny", "config": "u64_pairs",
                               "traffic": "tiny", "chips": 1})
    for m in bench["end_to_end"]:
        if m["name"] in BULK:
            m["workloads"].append("u64_pairs.tiny")
    return bench


@pytest.mark.parametrize("method", ["auto", "counting"])
def test_the_cell_at_a_small_size_is_correct(tmp_path, method):
    bench = _kv64_root(tmp_path, method)
    res = run.run_cell(bench, "u64_pairs.tiny", SEED, 0.2, False, "cpu",
                       tmp_path, say=lambda *_: None)
    assert res["correct"] and res["attempted"] >= 1
    assert set(res["metrics"]) == {*BULK, "setup_s"}
    assert res["checks"] == {"key_mismatches": {"value": 0, "limit": 0},
                             "value_mismatches": {"value": 0, "limit": 0}}


class _TopDigitLeftOut:
    """The program with the window's top digit left out (``end_bit`` 8
    bits lower): on uniform 64-bit keys the lowest digit is the one that
    almost never decides an order (two of n keys tie in their upper 56
    bits about n**2 / 2**57 times), the top one decides nearly all."""

    def sort_pairs(self, keys, values, end_bit=None, **kw):
        end = 8 * keys.dtype.itemsize if end_bit is None else end_bit
        return thrs.sort_pairs(keys, values, end_bit=end - 8, **kw)


@pytest.mark.parametrize("method", ["auto", "counting"])
def test_the_top_digit_left_out_comes_out_not_correct(tmp_path, method):
    bench = _kv64_root(tmp_path, method)
    res = run.run_cell(bench, "u64_pairs.tiny", SEED, 0.1, False, "cpu",
                       tmp_path, program=_TopDigitLeftOut(),
                       say=lambda *_: None)
    assert res["correct"] is False and res["failed"] >= 1
    assert res["checks"]["key_mismatches"]["value"] > 0


def test_the_control_reads_above_the_limit_where_keys_tie_above_it(tmp_path):
    # zipf keys are small integers: their upper 56 bits tie, so the
    # lowest digit decides their order and its control shows
    bench = _kv64_root(tmp_path, "counting",
                       keys={"dist": "zipf", "a": 1.3, "cap": 2**31})
    r = control.readings(bench, "u64_pairs.tiny", SEED, 2, "cpu", tmp_path)
    assert r["sound"] == {"key_mismatches": 0, "value_mismatches": 0}
    assert r["control"]["key_mismatches"] > 0
