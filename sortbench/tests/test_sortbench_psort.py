"""The distributed sort's cell on the CPU: its metrics, the readers of its
NCCL exchange on hand-made records, and the cell itself on four gloo
ranks at a small size."""

from __future__ import annotations

import json

import pytest
import torch

from sortbench import cells, run
from sortbench.records import Call
from sortbench.tests.test_sortbench_harness import (SEED, _records, _root,
                                                    _tiny)

CELL = "u32_zipf.psort-p4"
EXCHANGE = ("exchange_ms_per_call", "exchange_link_roofline",
            "collective_ms_per_call")


def test_the_psort_cell_reports_its_metrics():
    bench = cells.benchmark()
    e2e = {m["name"] for m in cells.metrics(bench, CELL, False)}
    layer = {m["name"] for m in cells.metrics(bench, CELL, True)}
    assert e2e == {"keys_per_s.launch_bound", "call_p95_ms.launch_bound",
                   "sort_bytes_per_key", "setup_s"}
    assert layer == {m + ".launch_bound" for m in (
        "host_ms_per_call", "launches_per_call", "lsd_pass_roofline",
        "device_idle_share")} | set(EXCHANGE)
    for m in cells.metrics(bench, CELL, True):
        assert m["moves"] in e2e
    # the exchange metrics are this cell's alone
    for w in bench["workloads"]:
        if w["name"] != CELL:
            assert not {m["name"] for m in cells.metrics(
                bench, w["name"], True)} & set(EXCHANGE)


def test_exchange_readers_without_a_trace_read_nothing():
    rec = _records(device_events=None, extra_bytes=None, peaks=None)
    for m in EXCHANGE:
        assert cells.reader(m)(rec) is None


def _exchange_records(P, n, value_bytes=0, nccl_s=0.001):
    """Two calls of ``n`` keys a rank on ``P`` ranks, in whose window the
    NCCL kernels that carry bytes run ``nccl_s`` a call (one of them
    beside a sort kernel), an AllReduce 0.5 ms and the harness's
    broadcast 1 us, among kernels of other names."""
    calls = [Call(0.0, 0.008, 0.010), Call(0.010, 0.018, 0.020)]
    events = []
    for c in calls:
        t = c.enter
        events += [
            ("void sweep_registers<1>(SweepParams)", t + 0.0001, t + 0.004),
            ("ncclDevKernel_AllToAll_Sum_int32(ncclDevKernelArgsStorage)",
             t + 0.0035, t + 0.0035 + nccl_s / 2),
            ("ncclDevKernel_AllReduce_Sum_u64_RING_LL(ncclDevKernelArgs)",
             t + 0.0045, t + 0.005),
            ("Memcpy DtoD (Device -> Device)", t + 0.006, t + 0.0065),
            ("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
             t + 0.007, t + 0.007 + nccl_s / 2),
            ("NCCLKERNEL_Broadcast_RING_LL_Sum_int8_t", t + 0.0095,
             t + 0.0095 + 1e-6)]
    return _records(keys_per_call=P * n, keys_per_rank=n,
                    value_bytes=value_bytes, calls=calls, window=(0.0, 0.020),
                    device_events=events)


def test_exchange_readers():
    ms, roof, coll = (cells.reader(m) for m in EXCHANGE)
    rec = _exchange_records(4, 1 << 28)
    # the kernels that carry bytes alone, the sort kernel beside not counted
    assert ms(rec) == pytest.approx(1.0)
    # every NCCL kernel: the AllReduce's 0.5 ms and the broadcast's 1 us too
    assert coll(rec) == pytest.approx(1.501)
    # 2**28 four-byte keys, three quarters of them sent, at 450 GB/s
    floor_s = (1 << 28) * 4 * 3 / 4 / 450e9
    assert roof(rec) == pytest.approx(100 * floor_s / 0.001)
    # P from keys_per_call / keys_per_rank; payload bytes travel too
    assert roof(_exchange_records(2, 1 << 28)) == pytest.approx(
        100 * (1 << 28) * 4 / 2 / 450e9 / 0.001)
    assert roof(_exchange_records(4, 1 << 28, value_bytes=4)) == \
        pytest.approx(2 * roof(rec))
    # a trace that moved exactly the floor's bytes at the peak reads 100%
    assert roof(_exchange_records(4, 1 << 28, nccl_s=floor_s)) == \
        pytest.approx(100.0)
    # one rank sends nothing; a trace without NCCL kernels reads 0
    assert roof(_exchange_records(1, 1 << 20)) == 0.0
    rec = _records()
    assert ms(rec) == 0.0 and roof(rec) == 0.0 and coll(rec) == 0.0


def test_the_psort_cell_on_four_gloo_ranks(tmp_path, capfd):
    """The cell as the benchmark has it (its configuration, the zipf(1.3)
    keys of its traffic, four ranks), at 2**14 keys a rank on gloo."""
    from sortbench import launch
    _root(tmp_path, _tiny())
    traffic = json.loads((cells.ROOT / "traffic" / "psort-p4.json")
                         .read_text())
    (tmp_path / "traffic" / "psort-p4.json").write_text(json.dumps(
        {**traffic, "n": 1 << 14, "backend": "gloo"}))
    bench = cells.benchmark()
    cell = run.Cell(bench, CELL, tmp_path)
    keys, _ = cell.make_inputs(SEED, 0, "cpu")
    ones = float((keys.view(torch.int32) == 1).double().mean())
    assert abs(ones - 0.254) < 0.02  # about a quarter tie on the value 1
    code = launch.spawn(bench, CELL, SEED, 0.5, False, "cpu", tmp_path, 4,
                        "gloo", run.process_start())
    out = capfd.readouterr().out.strip().splitlines()
    assert code == 0
    res = json.loads(out[-1])
    assert res["correct"] is True and res["device"]["count"] == 4
    assert res["checks"] == {"key_mismatches": {"value": 0, "limit": 0}}
    assert res["attempted"] >= 1
    assert res["metrics"]["keys_per_s.launch_bound"]["value"] > 0
