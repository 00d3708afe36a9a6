"""The control of ``correct``: the program with its lowest 8-bit digit
left out of the window, on a cell's own inputs.

Each configuration states a window of key bits that the sort orders by in
full. Skipping a digit pass is the step that would tempt a later change,
and the program has that path itself: ``start_bit`` 8 bits higher. For
each seed this reads the numbers ``correct`` compares (mismatched keys and
values against the plain reference), first of the program as the
configuration states it and then of the control, on ``--entries`` of the
cell's inputs at the cell's own size, in one process:

    python3 -m sortbench.control --workload <cell> --seeds 1,2,3 [--entries 1]

One JSON line a seed; the control has to read above the limit (0).
"""

from __future__ import annotations

import argparse
import json

import torch

from sortbench import cells, run

#: bits the control leaves out of the bottom of the window: one digit
DROP_BITS = 8


def readings(bench: dict, name: str, seed: int, entries: int, device: str,
             root=cells.ROOT, program=None) -> dict:
    """``{"sound": {check: count}, "control": {check: count}}`` over the
    first ``entries`` inputs of the seed's pool."""
    if program is None:
        import tinyhipradixsort_torch as program
    cell = run.Cell(bench, name, root)
    dev = torch.device(device)
    pool, values = cell.make_inputs(seed, 0, dev)
    out = {}
    for label, drop in (("sound", 0), ("control", DROP_BITS)):
        fn = cell.caller(program, drop_bits=drop)
        counts = None
        for p in range(min(entries, pool.shape[0])):
            got = fn(pool[p], values)
            want = cell.expected([pool], [values], p, 0)
            bad = [run.mismatches(g, w) for g, w in zip(got, want)]
            del got, want
            counts = bad if counts is None else [c + b for c, b in
                                                 zip(counts, bad)]
        out[label] = dict(zip(run.check_names(len(counts)), counts))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--entries", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = cells.benchmark()
    for seed in (int(s) for s in args.seeds.split(",")):
        r = readings(bench, args.workload, seed, args.entries, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "entries": args.entries, **r}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
