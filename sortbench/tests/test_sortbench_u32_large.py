"""The u32Large cell (``u32_large.bulk-2p31``) on the CPU at a tiny ragged
size, through a throwaway root: the cell is correct with its blocked
reference, and ``correct`` catches the window's top digit left out and,
on keys that tie above it, the control's lowest digit."""

from __future__ import annotations

import pytest

import tinyhipradixsort_torch as thrs
from sortbench import control, run
from sortbench.tests.test_sortbench_harness import SEED, _root, _tiny

BULK = ("keys_per_s", "call_p95_ms")
TINY = "u32_large.tiny"
N = 3 * 2048 + 100  # a ragged last tile, as 2**31 + 100 has


def _large_root(tmp_path, method, **traffic):
    bench = _root(tmp_path, _tiny(method, n=N, **traffic))
    # blocks of 512 keys, so the tiny cell's reference walks 16 of them
    ref = tmp_path / "references" / "stable_sort_blocked.py"
    text = ref.read_text()
    assert "\nBLOCK_KEYS = 1 << 27\n" in text
    ref.write_text(text.replace("\nBLOCK_KEYS = 1 << 27\n",
                                "\nBLOCK_KEYS = 512\n"))
    bench["workloads"].append({"name": TINY, "config": "u32_large",
                               "traffic": "tiny", "chips": 1})
    for m in bench["end_to_end"]:
        if m["name"] in BULK:
            m["workloads"].append(TINY)
    return bench


@pytest.mark.parametrize("method", ["auto", "counting"])
def test_the_cell_at_a_tiny_ragged_size_is_correct(tmp_path, method):
    bench = _large_root(tmp_path, method)
    cell = run.Cell(bench, TINY, tmp_path)
    assert cell.config["reference"] == "stable_sort_blocked"
    assert cell.reference.__globals__["BLOCK_KEYS"] == 512
    res = run.run_cell(bench, TINY, SEED, 0.2, False, "cpu", tmp_path,
                       say=lambda *_: None)
    assert res["correct"] and res["attempted"] >= 1
    # sort_bytes_per_key is not measured off the card
    assert set(res["metrics"]) == {*BULK, "setup_s"}
    assert res["checks"] == {"key_mismatches": {"value": 0, "limit": 0}}


class _TopDigitLeftOut:
    """The program with the window's top digit left out (``end_bit`` 8
    bits lower)."""

    def sort_keys(self, keys, end_bit=None, **kw):
        end = 8 * keys.dtype.itemsize if end_bit is None else end_bit
        return thrs.sort_keys(keys, end_bit=end - 8, **kw)


@pytest.mark.parametrize("method", ["auto", "counting"])
def test_the_top_digit_left_out_comes_out_not_correct(tmp_path, method):
    bench = _large_root(tmp_path, method)
    res = run.run_cell(bench, TINY, SEED, 0.1, False, "cpu", tmp_path,
                       program=_TopDigitLeftOut(), say=lambda *_: None)
    assert res["correct"] is False and res["failed"] >= 1
    assert res["checks"]["key_mismatches"]["value"] > 0


def test_the_control_reads_above_the_limit_where_keys_tie_above_it(
        tmp_path):
    # zipf keys are small integers: their upper 24 bits tie, so the
    # lowest digit decides their order and its control shows
    bench = _large_root(tmp_path, "counting",
                        keys={"dist": "zipf", "a": 1.3, "cap": 2**31})
    r = control.readings(bench, TINY, SEED, 2, "cpu", tmp_path)
    assert r["sound"] == {"key_mismatches": 0}
    assert r["control"]["key_mismatches"] > 0
