"""The harness on the CPU: loading by name, the reference, the metrics'
arithmetic, the import check, the control and faults that ``correct``
has to catch. Tests that need a card are marked ``cuda`` and decide
inside the test whether there is one."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from sortbench import cells, control, inputs, run, stats
from sortbench.records import Call, Records
from sortbench.references import stable_sort

import tinyhipradixsort_torch as thrs

SEED = 2**31 + 977  # past 32 signed bits, as a run's seed may be


def _root(tmp_path, traffic: dict):
    """A throwaway root: this folder's configurations, references and
    metrics, and one traffic mix ``tiny`` that no file of the repo holds."""
    for d in ("configs", "references", "metrics"):
        shutil.copytree(cells.ROOT / d, tmp_path / d)
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "tiny.json").write_text(json.dumps(traffic))
    bench = cells.benchmark()
    bench["workloads"] = [{"name": f"{c}.tiny", "config": c,
                           "traffic": "tiny", "chips": 1}
                          for c in ("u32_keys", "u32_pairs", "u32_psort")]
    for m in bench["end_to_end"]:  # the tiny cells report the bulk metrics
        if m["name"] in ("keys_per_s", "call_p95_ms"):
            m["workloads"] += [w["name"] for w in bench["workloads"]]
    return bench


def _tiny(method="bitonic", **kw):
    return {"n": 3000, "keys": {"dist": "uniform"}, "method": method,
            "pool": 2, "checked_calls": 3, **kw}


# -- loading by name ---------------------------------------------------------

def test_benchmark_names_files_that_exist():
    bench = cells.benchmark()
    for c in bench["configs"]:
        assert c["file"] == f"sortbench/configs/{c['name']}.json"
        assert cells.config(c["name"])["source"] == c["source"]
    for w in bench["workloads"]:
        run.Cell(bench, w["name"])  # config, traffic and reference load
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(cells.reader(m["name"]))


def test_each_cell_reports_its_metrics():
    bench = cells.benchmark()
    for w in bench["workloads"]:
        e2e = {m["name"] for m in cells.metrics(bench, w["name"], False)}
        layer = {m["name"] for m in cells.metrics(bench, w["name"], True)}
        assert "setup_s" in e2e and "sort_bytes_per_key" in e2e
        assert len(e2e) == 4 and len(layer) == 4
        suffix = ".launch_bound" if "keys_per_s.launch_bound" in e2e else ""
        assert layer == {m + suffix for m in (
            "host_ms_per_call", "launches_per_call", "lsd_pass_roofline",
            "device_idle_share")}
        for m in cells.metrics(bench, w["name"], True):
            assert m["moves"] in e2e


def test_traffic_defaults_fill_what_a_file_leaves_out(tmp_path):
    _root(tmp_path, {"n": 5, "method": "auto"})
    t = cells.traffic("tiny", tmp_path)
    assert t["ranks"] == 1 and t["pool"] == 1 and t["keys"]["dist"] == "uniform"


def test_a_new_traffic_file_runs_with_no_code_edit(tmp_path):
    bench = _root(tmp_path, _tiny())
    res = run.run_cell(bench, "u32_pairs.tiny", SEED, 0.2, False, "cpu",
                       tmp_path, say=lambda *_: None)
    assert res["correct"] and res["attempted"] >= 1
    assert set(res["metrics"]) == {"keys_per_s", "call_p95_ms", "setup_s"}
    assert list(res)[-1] == "checks"
    assert res["checks"] == {"key_mismatches": {"value": 0, "limit": 0},
                             "value_mismatches": {"value": 0, "limit": 0}}


def test_a_new_metric_file_is_read_by_name(tmp_path):
    bench = _root(tmp_path, _tiny())
    (tmp_path / "metrics" / "calls.per-run.py").write_text(
        "def read(rec):\n    return float(len(rec.calls))\n")
    bench["end_to_end"].append({"name": "calls.per-run", "unit": "calls",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock"})
    res = run.run_cell(bench, "u32_keys.tiny", SEED, 0.1, False, "cpu",
                       tmp_path, say=lambda *_: None)
    assert res["metrics"]["calls.per-run"]["value"] == res["attempted"]


def test_same_seed_same_inputs():
    t = {"n": 1000, "pool": 3, "keys": {"dist": "uniform"}}
    cfg = cells.config("u32_keys")
    a = inputs.keys(t, cfg, inputs.generator(SEED, 0, "cpu"), "cpu")
    b = inputs.keys(t, cfg, inputs.generator(SEED, 0, "cpu"), "cpu")
    c = inputs.keys(t, cfg, inputs.generator(SEED, 1, "cpu"), "cpu")
    assert a.shape == (3, 1000) and a.dtype == torch.uint32
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert not torch.equal(a.view(torch.int32), c.view(torch.int32))


@pytest.mark.parametrize("dist", [{"dist": "zipf", "a": 1.3, "cap": 2**31}])
def test_key_distributions(dist):
    t = {"n": 20000, "pool": 1, "keys": dist}
    k = inputs.keys(t, cells.config("u32_keys"),
                    inputs.generator(SEED, 0, "cpu"), "cpu")
    v = k.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    assert int(v.min()) >= 1 and int(v.max()) <= 2**31
    ref = np.random.default_rng(0).zipf(1.3, 200000)
    for x in (1, 2, 3):  # P(1) = 1 / zeta(1.3) = 0.254
        assert abs(float((v == x).double().mean())
                   - float((ref == x).mean())) < 0.01


@pytest.mark.parametrize("kind,key,value", [
    ("traffic", "loop", "open"), ("configuration", "stable", False),
    ("traffic", "values", "uniform")])
def test_a_key_that_nothing_reads_is_refused(tmp_path, kind, key, value):
    _root(tmp_path, {"n": 5, "method": "auto"})
    if kind == "traffic":
        path, load = tmp_path / "traffic" / "tiny.json", cells.traffic
    else:
        path, load = tmp_path / "configs" / "u32_keys.json", cells.config
    name = path.stem
    load(name, tmp_path)  # as it stands the file loads
    path.write_text(json.dumps({**json.loads(path.read_text()), key: value}))
    with pytest.raises(ValueError, match=f"{kind} '{name}': keys \\['{key}'\\]"):
        load(name, tmp_path)


def test_a_split_metric_is_read_by_its_base_file(tmp_path):
    _root(tmp_path, {"n": 5, "method": "auto"})
    rec = _records()
    for name in ("keys_per_s.launch_bound", "keys_per_s.a.b"):
        assert cells.reader(name, tmp_path)(rec) == \
            cells.reader("keys_per_s", tmp_path)(rec)
    (tmp_path / "metrics" / "keys_per_s.own.py").write_text(
        "def read(rec):\n    return -1.0\n")
    assert cells.reader("keys_per_s.own", tmp_path)(rec) == -1.0
    with pytest.raises(FileNotFoundError):
        cells.reader("no_such_metric.launch_bound", tmp_path)


# -- the reference ------------------------------------------------------------

def _np_order(keys: np.ndarray) -> np.ndarray:
    """numpy's stable argsort of the keys' ordered bits."""
    w = keys.dtype.itemsize * 8
    u = keys.view(f"u{keys.dtype.itemsize}").astype(np.uint64)
    top = np.uint64(1 << (w - 1))
    if keys.dtype.kind == "f":
        neg = (u & top) != 0
        u = np.where(neg, ~u & np.uint64((1 << w) - 1 if w < 64 else 2**64 - 1),
                     u | top)
    elif keys.dtype.kind == "i":
        u = u ^ top
    return np.argsort(u, kind="stable")


def _every_pattern(dtype, n=4096):
    """Random keys plus every edge bit pattern: 0, 1, the sign bit, all
    ones, the largest and smallest of each sign, and (floats) +-0, +-inf,
    NaNs of both signs and denormals."""
    w = np.dtype(dtype).itemsize * 8
    ut = np.dtype(f"u{w // 8}")
    edges = [0, 1, 2, (1 << (w - 1)) - 1, 1 << (w - 1), (1 << (w - 1)) + 1,
             (1 << w) - 1, (1 << w) - 2]
    if np.dtype(dtype).kind == "f":
        mant = {32: 23, 64: 52}[w]
        inf = ((1 << (w - 1 - mant)) - 1) << mant
        edges += [inf, inf | (1 << (w - 1)), inf | 1, inf | 1 | (1 << (w - 1)),
                  3, 3 | (1 << (w - 1))]
    rng = np.random.default_rng(5)
    rand = rng.integers(0, 2**63, n, dtype=np.uint64).astype(ut)
    bits = np.concatenate([np.array(edges * 3, dtype=np.uint64).astype(ut),
                           rand, rand[:100]])
    rng.shuffle(bits)
    return bits.view(dtype)


@pytest.mark.parametrize("dtype", ["uint32", "int32", "float32", "uint64",
                                   "int64", "float64", "uint16", "int8"])
def test_reference_matches_numpy_stable_sort(dtype):
    keys = _every_pattern(dtype)
    t = torch.from_numpy(keys.copy())
    vals = torch.arange(keys.size, dtype=torch.int32)
    cfg = {**cells.CONFIG_DEFAULTS, "end_bit": None}
    got_k, got_v = stable_sort.expected(t, vals, cfg)
    order = _np_order(keys)
    w = keys.dtype.itemsize
    assert np.array_equal(got_k.numpy().view(f"u{w}"),
                          keys[order].view(f"u{w}"))
    assert np.array_equal(got_v.numpy(), order.astype(np.int32))


def test_reference_window_and_descending():
    keys = _every_pattern("uint32")
    t = torch.from_numpy(keys.copy())
    cfg = {**cells.CONFIG_DEFAULTS, "start_bit": 8, "end_bit": 24,
           "order": "descending"}
    (got,) = stable_sort.expected(t, None, cfg)
    field = (keys.astype(np.int64) >> 8) & 0xFFFF
    order = np.argsort(-field, kind="stable")
    assert np.array_equal(got.numpy(), keys[order])


def test_reference_sorts_rows():
    keys = torch.from_numpy(_every_pattern("uint32", 4000)[:4000].copy())
    rows = keys.view(8, 500)
    vals = torch.arange(4000, dtype=torch.int64).view(8, 500)
    k, v = stable_sort.expected(rows, vals, {**cells.CONFIG_DEFAULTS,
                                            "end_bit": None})
    for r in range(8):
        (kr, vr) = stable_sort.expected(rows[r], vals[r],
                                        {**cells.CONFIG_DEFAULTS,
                                         "end_bit": None})
        assert torch.equal(k[r].view(torch.int32), kr.view(torch.int32))
        assert torch.equal(v[r], vr)


def test_reference_imports_nothing_of_the_program():
    src = (cells.ROOT / "references" / "stable_sort.py").read_text()
    assert "tinyhipradixsort" not in src and "jax" not in src


# -- the metrics' arithmetic ----------------------------------------------------

def _records(**kw):
    calls = [Call(0.0, 0.001, 0.010), Call(0.010, 0.011, 0.030),
             Call(0.030, 0.031, 0.040), Call(0.040, 0.045, 0.050)]
    base = dict(keys_per_call=1000, keys_per_rank=1000, key_bytes=4,
                value_bytes=4, window_bits=32, calls=calls,
                window=(0.0, 0.050), setup_s=7.5, extra_bytes=12000,
                device_events=[("k1", 0.002, 0.008), ("k2", 0.005, 0.009),
                               ("k3", 0.012, 0.029), ("memset", 0.031, 0.032),
                               ("k4", 0.045, 0.060)],
                peaks={"bytes_per_s": 3.35e12})
    base.update(kw)
    return Records(**base)


def test_percentile_is_numpys_linear():
    xs = [5.0, 1.0, 9.0, 3.0, 7.5, 2.0, 8.0]
    for q in (0, 50, 95, 100):
        assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_union_and_gaps():
    iv = [(1, 3), (2, 4), (6, 7), (8, 12)]
    assert stats.union_seconds(iv, 0, 10) == 3 + 1 + 2
    assert stats.gaps(iv, 0, 10) == [(0, 1), (4, 6), (7, 8)]


def test_lsd_floor_bytes():
    # 160M u32 keys, 4 passes of read + write: 5.12 GB, 1.528 ms at 3.35 TB/s
    assert stats.lsd_floor_bytes(160_000_000, 4, 0, 32) == 5_120_000_000
    assert stats.lsd_floor_bytes(160_000_000, 4, 4, 32) == 10_240_000_000
    assert stats.lsd_floor_bytes(10, 8, 8, 64) == 8 * 2 * 10 * 16
    assert stats.lsd_floor_bytes(10, 4, 0, 16) == 2 * 2 * 10 * 4
    assert stats.lsd_floor_bytes(10, 4, 0, 12) == 2 * 2 * 10 * 4


def test_metric_readers():
    rec = _records()
    read = {m: cells.reader(m)(rec) for m in (
        "keys_per_s", "call_p95_ms", "sort_bytes_per_key", "setup_s",
        "host_ms_per_call", "launches_per_call", "lsd_pass_roofline",
        "device_idle_share")}
    assert read["keys_per_s"] == pytest.approx(4 * 1000 / 0.050)
    assert read["call_p95_ms"] == pytest.approx(
        1e3 * np.percentile([0.010, 0.020, 0.010, 0.010], 95))
    assert read["sort_bytes_per_key"] == 12.0
    assert read["setup_s"] == 7.5
    assert read["host_ms_per_call"] == pytest.approx(1e3 * 0.008 / 4)
    assert read["launches_per_call"] == 5 / 4
    device_s = (0.006 + 0.004 + 0.017 + 0.001 + 0.015) / 4
    floor_s = 4 * 2 * 1000 * 8 / 3.35e12
    assert read["lsd_pass_roofline"] == pytest.approx(100 * floor_s / device_s)
    busy = 0.007 + 0.017 + 0.001 + 0.005  # k4 clipped at the window's end
    assert read["device_idle_share"] == pytest.approx(100 * (1 - busy / 0.050))


def test_readers_without_a_trace_read_nothing():
    rec = _records(device_events=None, extra_bytes=None, peaks=None)
    for m in ("launches_per_call", "lsd_pass_roofline", "device_idle_share",
              "sort_bytes_per_key"):
        assert cells.reader(m)(rec) is None


def test_breakdown_names_the_host_phase_of_each_gap():
    rec = _records()
    b = run.breakdown(rec.device_events, rec.calls, *rec.window, "sort_keys")
    assert b["device_ops"][0][0] == "k3"
    assert len(b["device_ops"]) == 5
    phases = {name for name, _ in b["idle_gaps"]}
    assert phases <= {"host inside sort_keys", "host in synchronize",
                      "harness, between calls",
                      "harness, before the first call"}
    assert sum(s for _, s in b["idle_gaps"]) == pytest.approx(
        0.050 - (0.007 + 0.017 + 0.001 + 0.005))


def test_trace_clock_aligns_past_extra_syncs():
    from sortbench.trace import align
    host = [1.0, 1.091, 1.1, 1.191, 1.282, 1.3, 1.391]  # calls and copies
    offset = 5_000_000_000
    trace = [round(h * 1e9) + offset + d for h, d in
             zip(host, (3000, 2500, 3100, 2900, 2800, 3300, 3000))]
    # a sync before the window and the profiler's own at its stop
    trace = [trace[0] - 40_000_000] + trace + [trace[-1] + 91_000_000]
    assert abs(align(trace, host) - offset - 3000) < 200
    assert align(trace[:5], host) is None


# -- the import check -------------------------------------------------------------

def test_import_check_compares_whole_top_level_names():
    assert run.banned_modules({"tinyhipradixsort_torch": 0,
                               "tinyhipradixsort_torch.ops": 0,
                               "jaxtyping": 0, "numpy": 0}) == []
    assert run.banned_modules({"tinyhipradixsort_tpu.sort": 0, "jax": 0,
                               "jaxlib.xla": 0, "flax": 0}) == [
        "flax", "jax", "jaxlib", "tinyhipradixsort_tpu"]


def test_a_run_imports_neither_jax_nor_the_jax_package(tmp_path):
    code = ("import sys, json, shutil, pathlib\n"
            "from sortbench import run, cells\n"
            f"root = pathlib.Path({str(tmp_path)!r})\n"
            "bench = json.loads((root / 'bench.json').read_text())\n"
            f"run.run_cell(bench, 'u32_keys.tiny', {SEED}, 0.05, False, 'cpu', root,"
            " say=lambda *_: None)\n"
            "print(run.banned_modules())\n")
    bench = _root(tmp_path, _tiny())
    (tmp_path / "bench.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_emit_refuses_a_run_that_imported_jax(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", object())
    code = run.emit({"checks": {}})
    cap = capsys.readouterr()
    assert code == 3 and cap.out == "" and "jax" in cap.err


def test_cli_without_a_card_prints_no_result():
    def have_card():
        return torch.cuda.is_available()
    if have_card():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "-m", "sortbench.run", "--workload",
                          "u32_keys.small", "--seed", str(SEED), "--seconds",
                          "1", "--trace", "0"], cwd=cells.ROOT.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""


# -- correct: the control and the faults -------------------------------------------

@pytest.mark.parametrize("cell", ["u32_keys.tiny", "u32_pairs.tiny"])
@pytest.mark.parametrize("method", ["bitonic", "counting"])
def test_control_reads_above_the_limit(tmp_path, cell, method):
    bench = _root(tmp_path, _tiny(method, n=20000))
    for seed in (SEED, 11, 12):
        r = control.readings(bench, cell, seed, 2, "cpu", tmp_path)
        assert all(v == 0 for v in r["sound"].values())
        assert r["control"]["key_mismatches"] > 0


class _Control:
    """The control in the program's place: the program's own window
    ``control.DROP_BITS`` bits higher, as ``control.py`` reads it."""

    def sort_keys(self, keys, start_bit=0, **kw):
        return thrs.sort_keys(keys, start_bit=start_bit + control.DROP_BITS,
                              **kw)

    def sort_pairs(self, keys, values, start_bit=0, **kw):
        return thrs.sort_pairs(keys, values,
                               start_bit=start_bit + control.DROP_BITS, **kw)


@pytest.mark.parametrize("cell", ["u32_keys.tiny", "u32_pairs.tiny"])
@pytest.mark.parametrize("method", ["bitonic", "counting"])
def test_the_control_comes_out_not_correct(tmp_path, cell, method):
    bench = _root(tmp_path, _tiny(method, n=20000))
    for seed in (SEED, 11, 12):
        res = run.run_cell(bench, cell, seed, 0.1, False, "cpu", tmp_path,
                           program=_Control(), say=lambda *_: None)
        assert res["correct"] is False and res["failed"] >= 1
        assert res["checks"]["key_mismatches"]["value"] > 0


class _Broken:
    """The program with one fault planted under the harness."""

    def __init__(self, fault):
        self.fault = fault

    def _mangle(self, outs, keys):
        if self.fault == "unchanged":  # returns its input as it found it
            return (keys.clone(),) + tuple(o for o in outs[1:])
        o = outs[0].clone()
        if self.fault == "one_key":  # one answer altered where produced
            o.view(torch.int32)[o.numel() // 2] ^= 1
            return (o,) + tuple(outs[1:])
        if self.fault == "half":  # half of the keys left out
            h = o.numel() // 2
            o[h:] = o[:h].clone()[: o.numel() - h]
            return (o,) + tuple(outs[1:])
        if self.fault == "one_value":
            v = outs[1].clone()
            v.view(torch.int32)[3] += 1
            return (outs[0], v)
        raise ValueError(self.fault)

    def sort_keys(self, keys, **kw):
        return self._mangle((thrs.sort_keys(keys, **kw),), keys)[0]

    def sort_pairs(self, keys, values, **kw):
        return self._mangle(thrs.sort_pairs(keys, values, **kw), keys)


@pytest.mark.parametrize("cell,fault", [
    ("u32_keys.tiny", "unchanged"), ("u32_keys.tiny", "one_key"),
    ("u32_keys.tiny", "half"), ("u32_pairs.tiny", "unchanged"),
    ("u32_pairs.tiny", "one_key"), ("u32_pairs.tiny", "one_value")])
def test_faults_come_out_not_correct(tmp_path, cell, fault):
    bench = _root(tmp_path, _tiny())
    res = run.run_cell(bench, cell, SEED, 0.1, False, "cpu", tmp_path,
                       program=_Broken(fault), say=lambda *_: None)
    assert res["correct"] is False and res["failed"] >= 1
    assert sum(v["value"] for v in res["checks"].values()) > 0


# -- more than one rank ---------------------------------------------------------------

def test_two_ranks_on_gloo(tmp_path, capfd):
    from sortbench import launch
    bench = _root(tmp_path, {"n": 2000, "method": "auto", "pool": 2,
                             "checked_calls": 2, "ranks": 2,
                             "backend": "gloo"})
    (tmp_path / "configs" / "u32_psort.json").write_text(json.dumps(
        {**cells.config("u32_keys"), "name": "u32_psort",
         "api": "psort_keys"}))
    code = launch.spawn(bench, "u32_psort.tiny", SEED, 0.5, False, "cpu",
                        tmp_path, 2, "gloo", run.process_start())
    out = capfd.readouterr().out.strip().splitlines()
    assert code == 0
    res = json.loads(out[-1])
    assert res["correct"] is True and res["device"]["count"] == 2
    assert res["checks"]["key_mismatches"]["value"] == 0
    assert res["metrics"]["keys_per_s"]["value"] > 0


# -- the card ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_a_small_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = cells.benchmark()
    said = []
    res = run.run_cell(bench, "u32_keys.small", SEED, 1.0, True, "cuda",
                       say=said.append)
    why = "\n".join(said + [json.dumps(res)])
    assert res["correct"] and res["device"]["busy_s"] > 0, why
    roofline = res["metrics"].get("lsd_pass_roofline.launch_bound", {})
    assert 0 < roofline.get("value", 0) <= 100, why
