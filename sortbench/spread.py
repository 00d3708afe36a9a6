"""Runs of cells in sets, each run a process of its own as a check makes
them, and the spread of each metric: the distance between the first and
third quartiles as a share of the median, per set.

    python3 -m sortbench.spread --workload <cell>[,<cell>...] --seeds 1,2,3,4,5,6
        [--sets 2] [--seconds S] [--trace-seeds 7,8,9] [--extra-seeds 10,11]
        [--out runs.jsonl]

``--seconds`` defaults to the benchmark's ``run_seconds``. The sets run
the same seeds in the same order, one cell after the other;
``--trace-seeds`` adds ``--trace 1`` runs and ``--extra-seeds`` more
``--trace 0`` runs with other seeds. Every run's result line goes to
``--out`` as it comes; a summary line per cell and metric follows.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

from sortbench import cells, stats

#: seconds a run may take (the first of a checkout builds the kernels)
RUN_TIMEOUT_S = 1200


def one_run(cell: str, seed: int, seconds: float, trace: int) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "sortbench.run", "--workload", cell,
         "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace)], capture_output=True, text=True, timeout=RUN_TIMEOUT_S)
    lines = proc.stdout.strip().splitlines()
    result = None
    if proc.returncode == 0 and lines:
        result = json.loads(lines[-1])
    return {"cell": cell, "seed": seed, "trace": trace,
            "rc": proc.returncode, "wall_s": time.perf_counter() - t0,
            "earlier": lines[:-1], "result": result,
            "stderr_tail": proc.stderr[-2000:]}


def summary(runs: list) -> list:
    """Per cell and metric of the ``--trace 0`` runs: each set's median
    and spread."""
    out = []
    for cell in dict.fromkeys(r["cell"] for r in runs):
        sets = {}
        for r in runs:
            if r["cell"] == cell and r["trace"] == 0 and r.get("set") \
                    and r["result"]:
                sets.setdefault(r["set"], []).append(r["result"]["metrics"])
        names = {m for ms in sets.values() for run in ms for m in run}
        for m in sorted(names):
            line = {"cell": cell, "metric": m}
            for k, ms in sorted(sets.items()):
                vals = [run[m]["value"] for run in ms if m in run]
                line[f"set{k}"] = {
                    "median": statistics.median(vals),
                    "spread": stats.spread(vals) if len(vals) >= 2 else None,
                    "values": vals}
            out.append(line)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float,
                    default=cells.benchmark()["run_seconds"])
    ap.add_argument("--trace-seeds", default="")
    ap.add_argument("--extra-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    def ints(s):
        return [int(x) for x in s.split(",") if x]

    sink = open(args.out, "a") if args.out else None
    runs = []

    def record(r):
        runs.append(r)
        res = r["result"] or {}
        print(json.dumps({k: r[k] for k in ("cell", "seed", "trace", "rc")}
                         | {"set": r.get("set"), "wall_s": round(r["wall_s"], 1),
                            "correct": res.get("correct"),
                            "metrics": {m: v["value"] for m, v in
                                        res.get("metrics", {}).items()}}),
              flush=True)
        if r["rc"] != 0:
            print(r["stderr_tail"], flush=True)
        if sink:
            sink.write(json.dumps(r) + "\n")
            sink.flush()

    try:
        for cell in args.workload.split(","):
            for k in range(1, args.sets + 1):
                for seed in ints(args.seeds):
                    record({**one_run(cell, seed, args.seconds, 0), "set": k})
            for seed in ints(args.trace_seeds):
                record(one_run(cell, seed, args.seconds, 1))
            for seed in ints(args.extra_seeds):
                record(one_run(cell, seed, args.seconds, 0))
        for line in summary(runs):
            print(json.dumps(line), flush=True)
            if sink:
                sink.write(json.dumps({"summary": line}) + "\n")
    finally:
        if sink:
            sink.close()
    return 0 if all(r["rc"] == 0 and r["result"] and r["result"]["correct"]
                    for r in runs) else 1


if __name__ == "__main__":
    raise SystemExit(main())
