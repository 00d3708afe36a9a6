"""The port's harness layer on the CPU, at small sizes: the bench entry,
``entry``, the benchmark matrix, the weak-scaling harness (a gloo world of
2 processes with a FileStore), the examples, the drives and the flagship
plan check, against the JAX repo's scripts where those are deterministic
(``__graft_entry__.entry``, ``examples/helloworld.py``, the bench's keys
and sort, psort's capacity arithmetic).
"""

import json
import os
import runpy
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinyhipradixsort_tpu as jthrs
from tinyhipradixsort_tpu.parallel import psort as jpsort
from tinyhipradixsort_torch import bench
from tinyhipradixsort_torch import entry as entry_mod
from tinyhipradixsort_torch import sort as sort_mod
from tinyhipradixsort_torch.benchmarks import full, scaling
from tinyhipradixsort_torch.examples import helloworld, segmented, soak
from tinyhipradixsort_torch.parallel import psort
from tinyhipradixsort_torch.tools import (baseline_scale, drive, host_bits,
                                          nonpow2_sweep, to_device,
                                          verify_baseline)
from tinyhipradixsort_torch.utils import call_times, native_oracle

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def test_entry_step_matches_jax_entry():
    import __graft_entry__

    jfn, jargs = __graft_entry__.entry()
    want = [np.asarray(a) for a in jfn(*jargs)]
    step, args = entry_mod.entry("cpu")
    for a, ja in zip(args, jargs):
        np.testing.assert_array_equal(host_bits(a), np.asarray(ja))
    got = step(*args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(host_bits(g), w)
    assert entry_mod.dryrun_multichip.__module__.endswith("parallel.dryrun")


def test_entry_main_prints_ok(capsys):
    assert entry_mod.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == "entry: ok"


def test_bench_sorts_what_the_jax_bench_sorts():
    n = 1 << 12
    keys = bench.bench_keys(n)
    # bench.py:72-73
    want = np.random.default_rng(0).integers(0, 2**32, size=n, dtype=np.uint32)
    np.testing.assert_array_equal(keys, want)
    jout = np.asarray(jthrs.sort_keys(jnp.asarray(want)))
    for method in ("auto", "bitonic"):
        got = sort_mod.sort_keys(to_device(keys, CPU), method=method)
        np.testing.assert_array_equal(host_bits(got), jout)
    # the bench's full check holds its output to this oracle
    np.testing.assert_array_equal(native_oracle.native_sort_bits(keys), jout)
    assert bench.run(n, 1, "full", "bitonic", "cpu")["verify"] == "full"


@pytest.mark.parametrize("verify", ["full", "spot", "none"],
                         ids=lambda v: f"verify-{v}")
def test_bench_line(verify):
    line = bench.run(1 << 12, 2, verify, "auto", "cpu")
    for key in ("metric", "value", "unit", "vs_baseline", "n", "method",
                "platform", "wall_s", "median_s", "verify", "oracle"):
        assert key in line, key
    assert "dispatch_floor_s" not in line
    assert line["metric"] == "sort_keys_u32_keys_per_s"
    assert line["n"] == 1 << 12 and line["method"] == "argsort"
    assert line["platform"] == "cpu" and line["verify"] == verify
    assert line["wall_s"] <= line["median_s"]
    assert line["value"] == pytest.approx((1 << 12) / line["wall_s"])
    assert line["vs_baseline"] == pytest.approx(line["value"] / 1e9)
    assert (line["oracle"] in ("native", "numpy")) == (verify == "full")
    json.dumps(line)


@pytest.mark.parametrize("verify", ["full", "spot"],
                         ids=lambda v: f"verify-{v}")
def test_bench_check_fails_on_a_wrong_sort(verify, monkeypatch):
    real = sort_mod.sort_keys

    def broken(x, **kw):
        out = real(x, **kw).clone()
        word = out.view(torch.int32)
        word[[0, -1]] = word[[-1, 0]]
        return out
    monkeypatch.setattr(sort_mod, "sort_keys", broken)
    with pytest.raises(AssertionError):
        bench.run(1 << 12, 1, verify, "auto", "cpu")


@pytest.mark.parametrize("verify", ["full", "spot"],
                         ids=lambda v: f"verify-{v}")
def test_bench_checks_the_last_timed_call(verify, monkeypatch):
    real, calls = sort_mod.sort_keys, []

    def broken_last(x, **kw):
        calls.append(1)
        out = real(x, **kw)
        if len(calls) == 1 + 3:  # the warm-up, then the third timed call
            out = out.clone()
            word = out.view(torch.int32)
            word[[0, -1]] = word[[-1, 0]]
        return out
    monkeypatch.setattr(sort_mod, "sort_keys", broken_last)
    with pytest.raises(AssertionError):
        bench.run(1 << 12, 3, verify, "auto", "cpu")
    assert len(calls) == 4


@pytest.mark.parametrize("n", [1, 5, 4097])
def test_bench_spot_check_invariants(n):
    keys = bench.bench_keys(n)
    x = to_device(keys, CPU)
    out = to_device(np.sort(keys), CPU)
    assert bench.spot_check(out, x)
    bumped = np.sort(keys)
    bumped[-1] ^= 1  # stays sorted, loses the XOR and the sum
    assert not bench.spot_check(to_device(bumped, CPU), x)


def test_bench_full_stays_full_without_the_native_oracle(monkeypatch):
    monkeypatch.setattr(native_oracle, "get_lib", lambda: None)
    line = bench.run(1 << 12, 1, "full", "bitonic", "cpu")
    assert line["verify"] == "full" and line["oracle"] == "numpy"


def test_harness_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench.run(16, 1, "none", "auto", "cuda")
    with pytest.raises(RuntimeError, match="--device cpu"):
        entry_mod.entry()


def test_call_times_counts_its_reps():
    times = call_times(lambda a: a + 1, torch.ones(8), reps=3)
    assert len(times) == 3 and all(t >= 0 for t in times)


def test_call_times_by_the_host_clock():
    # the host's clock around the whole call: a call that sleeps reads its
    # sleep at least
    times = call_times(lambda a: time.sleep(0.002) or a + 1, torch.ones(8),
                       reps=2, host_clock=True)
    assert len(times) == 2 and min(times) >= 0.002


def test_helloworld_prints_the_jax_helloworlds_lines(capsys):
    runpy.run_path(str(ROOT / "examples" / "helloworld.py"),
                   run_name="jax_helloworld")["main"]()
    want = capsys.readouterr().out.splitlines()
    got = []
    helloworld.run("cpu", out=got.append)
    assert len(want) == 32 and got == want


@pytest.mark.parametrize("name", ["segmented", "soak-keys", "soak-pairs",
                                  "verify_baseline"])
def test_examples_and_verify_baseline_small(name):
    lines = []
    if name == "segmented":
        segmented.run("cpu", out=lines.append)
        assert len(lines) == 3
    elif name.startswith("soak"):
        for dtype in soak.DTYPES:
            assert soak.soak(1 << 13, name.endswith("pairs"), dtype, iters=2,
                             seed=5, dev="cpu", out=lines.append) == 2
        assert len(lines) == 2 * len(soak.DTYPES)
    else:
        verify_baseline.verify("cpu", 1 << 12, 1 << 13, 1 << 14,
                               out=lines.append)
        assert lines[-1] == "BASELINE configs verified"


@pytest.mark.parametrize("method", ["auto", "bitonic", "counting"])
def test_drive_small(method):
    lines = []
    d = drive.drive("cpu", method, iters=2, cap=1 << 14, max_n=1 << 14,
                    out=lines.append)
    assert d.fails == 0, lines
    assert d.checks >= 120 and lines[-1].endswith("FAILURES: 0")


def test_drive_counts_a_failure():
    lines = []
    d = drive.Drive("cpu", out=lines.append)
    d.check("probe", torch.tensor([1, 2], dtype=torch.int32),
            np.array([1, 3], np.int32))
    assert d.fails == 1 and lines == ["FAIL: probe (first at 1)"]


def test_nonpow2_sweep_small():
    lines = []
    fails = nonpow2_sweep.sweep(
        "cpu", key_sizes=[1500, 3500, 4095, 4097, 12345, 16383],
        pair_sizes=[3000, 9999], out=lines.append)
    assert fails == 0, lines
    routes = [ln.rsplit("route=", 1)[1] for ln in lines[:-1]]
    assert routes.count("segmented") == 7 and routes.count("padded") == 3


def test_nonpow2_sweep_asserts_the_route(monkeypatch):
    monkeypatch.setattr(nonpow2_sweep, "expected_route", lambda n: "padded")
    lines = []
    assert nonpow2_sweep.sweep("cpu", key_sizes=[1500],
                               pair_sizes=[], out=lines.append) == 1
    assert lines[0].startswith("FAIL")


def test_nonpow2_default_sizes_are_the_jax_sweeps():
    sizes = nonpow2_sweep.default_key_sizes(np.random.default_rng(0))
    assert len(sizes) == 24 and all(n & (n - 1) for n in sizes)
    assert int((1 << 22) * 0.90) in sizes and 4096 * 2741 in sizes


def test_matrix_rows_have_the_jax_fields():
    src = (ROOT / "benchmarks" / "full.py").read_text()
    for name, *_ in full.workloads(["1M"]):
        assert f'"{name.replace("1M", "{label}")}"' in src, name
    gen = torch.Generator()
    gen.manual_seed(full.SEED)
    for name, kind, shape, vkind in [
            ("keys u32", "u32", 3000, None), ("keys f32", "f32", 2048, None),
            ("keys u64", "u64", 3000, None), ("pairs u32", "u32", 2048, "u32"),
            ("pairs u64", "u64", 3000, "u64"), ("keys f16", "f16", 3000, None),
            ("pairs u128", "u32", 2048, "u128"), ("rows", "u32", (16, 100), None)]:
        row = full.run_row(name, kind, shape, vkind, reps=1, method="bitonic",
                           gen=gen, dev=CPU)
        for key in ("workload", "n", "ours_s", "ours_keys_per_s",
                    "speedup_vs_torch", "torch_s", "ours_median_s"):
            assert key in row, key
        n = shape[0] * shape[1] if isinstance(shape, tuple) else shape
        assert row["n"] == n and row["reps"] in (1, 10)
        assert row["speedup_vs_torch"] == pytest.approx(
            row["torch_s"] / row["ours_s"])
        assert row["engine"] == "bitonic"
        assert row["ours_s"] <= row["ours_median_s"] <= row["ours_p95_s"]
    # the engine "auto" resolves to on the CPU
    row = full.run_row("keys u32", "u32", 3000, None, reps=4, method="auto",
                       gen=gen, dev=CPU)
    assert row["engine"] == "argsort" and row["reps"] in (4, 40)
    assert row["torch_s"] <= row["torch_median_s"] <= row["torch_p95_s"]


class _FakeMesh:
    """Just the mesh size that the JAX psort's capacity arithmetic reads."""

    def __init__(self, P):
        self.shape = {jpsort.AXIS: P}


class _Captured(Exception):
    pass


def _jax_plan(n, P, monkeypatch):
    """The JAX psort's static sizes for (n, P), captured where it builds
    its shard_map (traced abstractly: nothing is allocated)."""
    def fake_shard_map(f, **kw):
        raise _Captured(f.__closure__[0].cell_contents.keywords)
    monkeypatch.setattr(jax, "shard_map", fake_shard_map)
    with pytest.raises(_Captured) as got:
        jax.eval_shape(lambda k: jpsort.psort_keys(k, mesh=_FakeMesh(P)),
                       jax.ShapeDtypeStruct((n,), jnp.uint32))
    return got.value.args[0]


@pytest.mark.parametrize("n,P", [(16_000_000_000, 64),
                                 (16_000_000_000, 128),
                                 (16_000_000_000, 256), (12345, 3),
                                 (1 << 20, 8)])
def test_baseline_scale_matches_jax_capacity_arithmetic(n, P, monkeypatch):
    want = _jax_plan(n, P, monkeypatch)
    row = baseline_scale.plan_row(n, P)
    assert (row["cap"], row["cap3"], row["s"]) == (
        want["cap"], want["cap3"], want["sample_s"])
    assert row["refine_rounds"] == want["refine"][0]
    assert row["index_words"] == want["n_idx"]
    assert (row["problems"] == []) == (n >= 1 << 32)


def test_baseline_scale_main(capsys):
    assert baseline_scale.main([]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "OK" and len(out) == 3 + 3 + 1
    assert baseline_scale.main(["--n", "1000000", "--P", "8"]) == 1


def test_baseline_scale_flags_an_int64_overflow():
    row = baseline_scale.plan_row(1 << 61, 64)
    assert row["index_words"] == 2
    assert row["problems"] == [
        f"global bytes = {(1 << 61) * 3 * 4} overflows int64"]


def test_scaling_gloo_world_of_two(tmp_path):
    per_chip = 5001  # not a multiple of P * lcm(P, 8): the relay runs
    out = tmp_path / "scaling.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               WORLD_SIZE="2")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tinyhipradixsort_torch.benchmarks.scaling",
         "--device", "cpu", "--per-chip", str(per_chip), "--reps", "2",
         "--init-method", f"file://{tmp_path / 'store'}", "--out", str(out)],
        cwd=ROOT, env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), logs
    table = json.loads(out.read_text())
    assert table["platform"] == "cpu" and table["per_chip"] == per_chip
    rows = table["rows"]
    assert [r["devices"] for r in rows] == scaling.default_sizes(2) == [1, 2]
    assert rows[0]["weak_scaling_efficiency"] == 1.0
    for r in rows:
        P = r["devices"]
        assert r["n"] == P * per_chip and r["seconds"] <= r["median_s"]
        assert r["keys_per_s"] == pytest.approx(r["n"] / r["seconds"])
        assert r["weak_scaling_efficiency"] == pytest.approx(
            r["keys_per_s"] / (P * rows[0]["keys_per_s"]))
    # pieces of 5001 are not psort's B: relayed in and out
    assert rows[0]["wire"] == {"relay-in": 1, "ring": 1, "relay-out": 1}
    assert rows[1]["wire"] == {"relay-in": 1, "pre-exchange": 1, "ring": 1,
                               "rebalance": 1, "relay-out": 1}
    assert psort.index_words(rows[1]["n"]) == 1
