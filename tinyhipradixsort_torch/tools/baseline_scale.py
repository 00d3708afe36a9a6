"""The 16e9-key plan of BASELINE config 5 in 64-bit arithmetic (the
counterpart of the JAX repo's ``tools/trace_baseline_scale.py``).

The JAX tool lowers and compiles ``psort_keys`` of 16,000,000,000 u32 keys
over P virtual devices with no buffers allocated: evidence that the static
capacities, the two-word global index and the 64-bit rank arithmetic hold
at pod scale. PyTorch has no trace-and-compile step: psort's sizes are host
integers. So this tool computes, for each P and without allocating
anything, what a keys-only ``psort_keys`` of n u32 keys would use:
``psort.capacity_plan(n, P)`` (B, s, cap, cap3, refinement rounds), the
index words ``psort.index_words`` picks, the words the local sort carries
(the key word and the index synthesized after the pre-exchange) and the
bytes per rank. One table row per P. It exits 1 where the two-word index is
not chosen, where a capacity lies outside ``[B/P, B]``, or where a size or
byte count does not fit int64 (which takes an ``--n`` far beyond 16e9).
The words each exchange step carries are observed in runs, not restated
here: ``psort.WIRE`` in ``chip_smoke.py`` phase 11 and the gloo worlds of
the CPU tests.

    python -m tinyhipradixsort_torch.tools.baseline_scale [--P 64,128,256]
        [--n 16000000000]
"""

from __future__ import annotations

import argparse

from tinyhipradixsort_torch.parallel import psort

N_FLAGSHIP = 16_000_000_000  # BASELINE.json configs[4]
INT64_MAX = (1 << 63) - 1


def plan_row(n: int, P: int) -> dict:
    """The plan of one P and its checks (``problems``: empty when it
    holds)."""
    plan = psort.capacity_plan(n, P)
    n_idx = psort.index_words(n)
    n_pad = plan.B * P
    local_words = 1 + n_idx  # the key word and the synthesized index
    problems = []
    if n_idx != 2:
        problems.append(f"the index has {n_idx} word(s), not two")
    big = {"n_pad": n_pad, "ring receive P*cap": P * plan.cap,
           "rank bytes B*words*4": plan.B * local_words * 4,
           "global bytes": n_pad * local_words * 4}
    problems += [f"{k} = {v} overflows int64" for k, v in big.items()
                 if v > INT64_MAX]
    if not plan.B // P <= plan.cap <= plan.B or plan.cap3 > plan.B:
        problems.append(f"capacities out of range: B={plan.B} cap={plan.cap} "
                        f"cap3={plan.cap3}")
    return {"P": P, "n": n, "n_pad": n_pad, "B": plan.B, "s": plan.s,
            "cap": plan.cap, "cap3": plan.cap3,
            "refine_rounds": plan.refine[0] if plan.refine else 0,
            "index_words": n_idx, "local_sort_words": local_words,
            "rank_bytes": big["rank bytes B*words*4"], "problems": problems}


def report(n: int = N_FLAGSHIP, plist=(64, 128, 256), out=print) -> int:
    """The plan's table for each P of ``plist`` through ``out``; returns
    the number of P whose plan does not hold."""
    out(f"# BASELINE configs[4] plan: n={n:,} u32 keys, keys-only "
        "psort_keys, even pieces (host arithmetic, nothing allocated)")
    out("| P | n_pad | B | s | cap | cap3 | refine rounds | index words "
        "| local sort words | GiB per rank |")
    out("|---|---|---|---|---|---|---|---|---|---|")
    bad = 0
    for P in plist:
        r = plan_row(n, P)
        out(f"| {P} | {r['n_pad']:,} | {r['B']:,} | {r['s']} | "
            f"{r['cap']:,} | {r['cap3']:,} | {r['refine_rounds']} | "
            f"{r['index_words']} | {r['local_sort_words']} | "
            f"{r['rank_bytes'] / 2**30:.4f} |")
        for p in r["problems"]:
            out(f"FAIL: P={P}: {p}")
        bad += bool(r["problems"])
    out("OK" if not bad else f"FAILURES: {bad}")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--P", default="64,128,256",
                    help="comma list of group sizes")
    ap.add_argument("--n", type=int, default=N_FLAGSHIP)
    args = ap.parse_args(argv)
    bad = report(args.n, [int(p) for p in args.P.split(",")],
                 out=lambda line: print(line, flush=True))
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
