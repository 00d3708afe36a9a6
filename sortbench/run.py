"""Run one cell of the benchmark and print its result line.

    python3 -m sortbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The run makes the cell's inputs on the card
from the seed, warms up (one call per shape the cell uses, and one more),
then calls the API in a closed loop for ``--seconds``: one caller that
waits for each sorted result (``torch.cuda.synchronize()``), as the
reference's ``main.cpp`` times ``sortKeys`` in a loop. A seeded sample of
the window's answers is copied aside as they come; once the window has
closed they are compared, every element, with the configuration's plain
reference. With ``--trace 0`` the line carries the cell's end-to-end
metrics; with ``--trace 1`` the window runs under the profiler and the
line carries its per-layer metrics, the trace's busy and window seconds,
and a breakdown.

Earlier lines on stdout give the route of the first warm-up call
(``bitonic_engine.MARK``), the set-up's parts, the card's name, power
limit, clock and draw after the window (``nvidia-smi``), the calls made,
the calls in each second of the window and a call's host time inside the
API and in ``synchronize``; the last line is the result, whose last key
``checks`` gives each number compared beside its limit, as do the last
lines on stderr. Without a CUDA card (or with fewer than the cell asks
for) the run prints no result and exits with 2; if JAX or the JAX package
was imported, with 3.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import time
from pathlib import Path

import torch

from sortbench import cells, inputs, peaks, records, stats

#: top-level module names no run may have imported
BANNED = ("jax", "jaxlib", "flax", "tinyhipradixsort_tpu")


def boot_seconds() -> float:
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def process_start() -> float:
    """This process's start on the boot clock (seconds), from
    ``/proc/self/stat`` (its 22nd field, in clock ticks since boot)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return int(fields[19]) / os.sysconf("SC_CLK_TCK")


def banned_modules(modules=None) -> list:
    """Top-level names in ``modules`` (``sys.modules``) that are banned,
    each compared whole: ``tinyhipradixsort_torch`` is not
    ``tinyhipradixsort_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(BANNED))


def card_line() -> str:
    """The card's name, power limit, SM clock, power draw and temperature
    (``nvidia-smi``)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "power.draw,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().replace("\n", " | ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({e.__class__.__name__})"


class Cell:
    """One cell's configuration, traffic and program call, on one rank."""

    def __init__(self, bench: dict, name: str, root: Path = cells.ROOT):
        self.name = name
        self.entry = cells.workload(bench, name)
        self.config = cells.config(self.entry["config"], root)
        self.traffic = cells.traffic(self.entry["traffic"], root)
        self.reference = cells.reference(self.config["reference"], root)
        self.root = root

    def window_bits(self) -> int:
        key_bits = 8 * inputs.DTYPES[self.config["key_dtype"]].itemsize
        end = self.config["end_bit"]
        return (key_bits if end is None else end) - self.config["start_bit"]

    def make_inputs(self, seed: int, rank: int, device):
        """``(keys pool (pool, n), values or None)`` of one rank."""
        gen = inputs.generator(seed, rank, device)
        keys = inputs.keys(self.traffic, self.config, gen, device)
        return keys, inputs.values(self.traffic, self.config, device)

    def caller(self, program, drop_bits: int = 0):
        """``fn(keys, values) -> tuple of outputs``: the configuration's
        API call with the traffic's engine. ``drop_bits`` starts the
        window that many bits higher (the control)."""
        cfg = self.config
        kw = {"order": cfg["order"], "start_bit": cfg["start_bit"] + drop_bits,
              "end_bit": cfg["end_bit"], "method": self.traffic["method"]}
        fn = getattr(program, cfg["api"])
        if cfg["values"] is None:
            return lambda keys, values: (fn(keys, **kw),)
        return lambda keys, values: tuple(fn(keys, values, **kw))

    def expected(self, pools: list, values: list, p: int, rank: int) -> list:
        """The reference's outputs for pool entry ``p`` on ``rank``: of all
        ranks' keys end to end, this rank's share."""
        keys = pools[0][p] if len(pools) == 1 else torch.cat([k[p] for k in pools])
        vals = values[0] if len(values) == 1 or values[0] is None \
            else torch.cat(values)
        out = self.reference(keys, vals, self.config)
        n = pools[rank].shape[1]
        return [o[rank * n:(rank + 1) * n] for o in out]


def _signed(t):
    return t.view(inputs.SIGNED[t.dtype.itemsize])


def mismatches(got, want) -> int:
    """Elements of ``got`` whose bits differ from ``want`` (all of them
    where the shape or type differs)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return max(got.numel(), want.numel())
    return int((_signed(got) != _signed(want)).sum())


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_names(n_outputs: int) -> list:
    return ["key_mismatches", "value_mismatches"][:n_outputs]


def run_cell(bench: dict, name: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", root: Path = cells.ROOT,
             rank: int = 0, world: int = 1, start: float | None = None,
             program=None, say=print) -> dict | None:
    """Run one cell on this rank; rank 0 returns the result's fields (the
    others None). ``start``: the run's start on the boot clock.
    ``program``: the package under test (by default imported here)."""
    start = process_start() if start is None else start
    t_enter = boot_seconds()
    cell = Cell(bench, name, root)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    if program is None:
        import tinyhipradixsort_torch as program
    from tinyhipradixsort_torch.ops import bitonic_engine
    dist = None
    if world > 1:
        import torch.distributed as dist
    lead = rank == 0

    pool, values = cell.make_inputs(seed, rank, dev)
    _sync(dev)
    t_inputs = boot_seconds()
    fn = cell.caller(program)
    n_pool = pool.shape[0]
    routes = []
    bitonic_engine.MARK = (lambda event, route, words:
                           routes.append(route) if event == "route" else None)
    try:  # every shape the cell uses, once, and one call more
        outs = fn(pool[0], values)
        bitonic_engine.MARK = None
        outs = fn(pool[1 % n_pool], values)
    finally:
        bitonic_engine.MARK = None
    _sync(dev)
    keep = int(cell.traffic["checked_calls"])
    slots = [[torch.empty_like(o) for o in outs] for _ in range(keep)]
    del outs
    flag = torch.ones(1, dtype=torch.int32, device=dev)
    on_cuda = dev.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(dev) if on_cuda else None
    base = torch.cuda.memory_allocated(dev) if on_cuda else None
    if on_cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    if lead:
        say(f"routes of the first call: {' '.join(routes) or 'none'}")
        say(f"set-up: {t_enter - start:.3f} s to the run's start (the "
            f"interpreter, imports), {t_inputs - t_enter:.3f} s the device "
            f"and the inputs, {boot_seconds() - t_inputs:.3f} s the warm-up "
            f"calls (on a checkout's first run, with the kernels' build)")

    pick = random.Random(seed)
    kept = [None] * keep  # slot -> (call index, pool index)
    calls, syncs = [], []  # syncs: the host's clock before each synchronize

    def sync() -> float:
        t = time.perf_counter()
        syncs.append(t)
        _sync(dev)
        return t

    tracer = None
    if trace:
        from sortbench.trace import DeviceTrace
        tracer = DeviceTrace(dev).__enter__()
    sync()
    t_start = time.perf_counter()
    setup_s = boot_seconds() - start
    i, go = 0, True
    while go:
        p = i % n_pool
        keys = pool[p]
        t0 = time.perf_counter()
        outs = fn(keys, values)
        t1 = sync()
        t2 = time.perf_counter()
        calls.append(records.Call(t0, t1, t2))
        slot = i if i < keep else pick.randrange(i + 1)
        if slot < keep:  # a seeded uniform sample of the window's calls
            for dst, src in zip(slots[slot], outs):
                _signed(dst).copy_(_signed(src))
            kept[slot] = (i, p)
            sync()
        outs = None
        i += 1
        go = time.perf_counter() - t_start < seconds
        if world > 1:
            flag.fill_(int(go))
            dist.broadcast(flag, 0)
            go = bool(flag.item())
    t_end = calls[-1].done
    events = None
    if tracer is not None:
        tracer.__exit__(None, None, None)
        events = tracer.events(syncs)
        if lead and events:
            say(f"trace: {len(events)} device operations, clock from "
                f"{tracer.clock}; the first starts "
                f"{1e3 * (min(e[1] for e in events) - t_start):.3f} ms into "
                f"the window, the last ends "
                f"{1e3 * (t_end - max(e[2] for e in events)):.3f} ms before "
                f"its end")
    window_peak = torch.cuda.max_memory_allocated(dev) if on_cuda else None
    extra = None if base is None else window_peak - base
    peak_bytes = None if base is None else max(setup_peak, window_peak)

    # the answers, once the window has closed
    kind = torch.cuda.get_device_name(dev) if on_cuda else "cpu"
    if lead:
        say(f"card: {card_line() if on_cuda else 'cpu'}")
        say(f"calls: {len(calls)} in {t_end - t_start:.6f} s; checked: "
            + ", ".join(str(k[0]) for k in kept if k is not None))
        per_s = [0] * (int(t_end - t_start) + 1)
        for c in calls:
            per_s[int(c.done - t_start)] += 1
        say(f"calls in each second of the window: {per_s}; a call's mean "
            f"ms inside the API "
            f"{1e3 * sum(c.ret - c.enter for c in calls) / len(calls):.4f},"
            f" in synchronize "
            f"{1e3 * sum(c.done - c.ret for c in calls) / len(calls):.4f}")
    every = [(pool, values) if r == rank else cell.make_inputs(seed, r, dev)
             for r in range(world)]
    pools, vals = [k for k, _ in every], [v for _, v in every]
    del every
    counts = [0] * len(slots[0]) if slots else []
    failed, want_cache = 0, {}
    for slot, k in enumerate(kept):
        if k is None:
            continue
        _, p = k
        if p not in want_cache:
            want_cache.clear()
            want_cache[p] = cell.expected(pools, vals, p, rank)
        bad = [mismatches(g, w) for g, w in zip(slots[slot], want_cache[p])]
        counts = [c + b for c, b in zip(counts, bad)]
        failed += any(bad)
    want_cache.clear()

    rec = records.Records(
        keys_per_call=world * pool.shape[1], keys_per_rank=pool.shape[1],
        key_bytes=pool.dtype.itemsize,
        value_bytes=0 if values is None else
        values.dtype.itemsize * values[0].numel(),
        window_bits=cell.window_bits(), calls=calls,
        window=(t_start, t_end), setup_s=setup_s, extra_bytes=extra,
        device_events=events, peaks=peaks.peaks(kind))
    busy = None
    if events is not None:
        busy = stats.union_seconds([(s, e) for _, s, e in events],
                                   t_start, t_end)
    if world > 1:  # the sums, the most memory and the mean busy time
        t = torch.tensor([failed, *counts], dtype=torch.int64, device=dev)
        dist.all_reduce(t)
        failed, counts = int(t[0]), [int(c) for c in t[1:]]
        if peak_bytes is not None:
            t = torch.tensor([peak_bytes, extra], dtype=torch.int64,
                             device=dev)
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
            peak_bytes, extra = int(t[0]), int(t[1])
            rec.extra_bytes = extra
        if busy is not None:
            t = torch.tensor([busy], dtype=torch.float64, device=dev)
            dist.all_reduce(t)
            busy = float(t[0]) / world
    if not lead:
        return None

    metrics = {}
    for m in cells.metrics(bench, name, trace):
        value = cells.reader(m["name"], root)(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if on_cuda else "cpu", "kind": kind,
                "count": world, "memory_peak_bytes": peak_bytes}
    checks = {c: {"value": v, "limit": 0}
              for c, v in zip(check_names(len(counts)), counts)}
    result = {"correct": failed == 0 and all(
                  v["value"] <= v["limit"] for v in checks.values()),
              "attempted": len(calls), "failed": failed,
              "metrics": metrics, "device": dev_info}
    if events is not None:
        dev_info["busy_s"] = busy
        dev_info["window_s"] = t_end - t_start
        result["breakdown"] = breakdown(events, calls, t_start, t_end,
                                        cell.config["api"])
    result["checks"] = checks
    return result


def breakdown(events, calls, lo: float, hi: float, api: str) -> dict:
    """The device operations that took the most time, and the longest
    idle stretches of the device, named by what the host was doing."""
    by_name = {}
    for name, s, e in events:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(stats.gaps([(s, e) for _, s, e in events], lo, hi),
                  key=lambda g: g[0] - g[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[host_phase(calls, (a + b) / 2, api), b - a]
                          for a, b in idle]}


def host_phase(calls, t: float, api: str) -> str:
    """What the host was doing at ``t``."""
    import bisect
    i = bisect.bisect_right([c.enter for c in calls], t) - 1
    if i < 0:
        return "harness, before the first call"
    c = calls[i]
    if t < c.ret:
        return f"host inside {api}"
    if t < c.done:
        return "host in synchronize"
    return "harness, between calls"


def emit(result: dict) -> int:
    """Print the result as the last line, after the import check."""
    out, err = sys.stdout, sys.stderr
    found = banned_modules()
    if found:
        print(f"sortbench: the run imported {', '.join(found)}; no result",
              file=err, flush=True)
        return 3
    for check, v in result["checks"].items():
        print(f"check {check}: {v['value']} (limit {v['limit']})", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    start = process_start()
    t_main = boot_seconds()
    args = parse_args(argv)
    bench = cells.benchmark()
    cell = cells.workload(bench, args.workload)
    traffic = cells.traffic(cell["traffic"])
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"sortbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"set-up before the run: {t_main - start:.3f} s the interpreter "
          f"and its imports (torch), {boot_seconds() - t_main:.3f} s the "
          f"benchmark's files and CUDA's first calls", flush=True)
    ranks = int(traffic["ranks"])
    if ranks > 1:
        from sortbench import launch
        return launch.spawn(bench, args.workload, args.seed, args.seconds,
                            bool(args.trace), "cuda", cells.ROOT, ranks,
                            traffic["backend"], start)
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", start=start)
    return emit(result)


if __name__ == "__main__":
    raise SystemExit(main())
