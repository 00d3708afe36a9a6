"""One rank of a gloo world that runs the port's distributed sort.

Run as: python tests/_torch_psort_worker.py <case_dir> <world_size> <rank>

``<case_dir>/cases.json`` lists the cases: ``{"name", "fn" ("keys",
"pairs", "indices", or "dryrun" for ``parallel.dryrun.dryrun_multichip``
with ``kwargs``), "kwargs", "keys" (a .npy file of the whole global
array), "values" (null, a .npy file, or a dict of them), "lengths" (each
rank's piece), "group" (null, or the ranks of a subgroup to sort over),
"record" (optional: true runs the call inside ``tracing.record()``)}``.
The rank joins the group through ``multihost.initialize`` (gloo, a
FileStore in ``<case_dir>``), runs every case on its piece and
writes its outputs as ``<case_dir>/<name>.r<rank>.<part>.npy`` (the bits
as signed integers of the same width) and ``<case_dir>/r<rank>.json``
(per case: the overflow flag with ``check=True``, or the error raised; the
words per element each exchange step carried, from ``psort.WIRE``; whether
a donated call returned the caller's tensors; the dry run's lines; with
"record", the spans other than ``gc`` as ``[name, call, id, parent, start,
end, attrs]`` and the counters as ``[call, name, total]``).

Imports only torch, numpy and the port, so it runs where another package
named ``tests`` is installed.
"""

import contextlib
import json
import os
import sys
import traceback

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tinyhipradixsort_torch as thrs  # noqa: E402
from tinyhipradixsort_torch import tracing  # noqa: E402
from tinyhipradixsort_torch.parallel import dryrun, multihost, psort  # noqa: E402

_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _piece(path, lengths, rank):
    a = np.load(path)
    off = sum(lengths[:rank])
    return torch.from_numpy(np.ascontiguousarray(a[off:off + lengths[rank]]))


def _save(case_dir, name, rank, part, t):
    bits = t.view(_SIGNED[t.dtype.itemsize]).numpy()
    np.save(os.path.join(case_dir, f"{name}.r{rank}.{part}.npy"), bits)


def run_case(case, case_dir, rank):
    def load(f):
        return _piece(os.path.join(case_dir, f), case["lengths"], rank)

    keys = load(case["keys"])
    kw = dict(case["kwargs"])
    report = {"overflow": None, "error": None, "wire": {}, "donated": None}
    if case["fn"] == "dryrun":
        report["lines"] = dryrun.dryrun_multichip(**kw)
        return report
    if case["group"] is not None:
        # every rank creates the group; only its members sort
        kw["group"] = torch.distributed.new_group(case["group"])
        if rank not in case["group"]:
            return report
    if case["fn"] == "pairs":
        values = case["values"]
        vals = ({k: load(f) for k, f in values.items()}
                if isinstance(values, dict) else load(values))
    psort.WIRE = lambda step, nw: report["wire"].setdefault(step, nw)
    recording = (tracing.record() if case.get("record")
                 else contextlib.nullcontext())
    try:
        with recording as rec:
            if case["fn"] == "keys":
                out = thrs.psort_keys(keys, **kw)
            elif case["fn"] == "indices":
                out = thrs.psort_indices(keys, **kw)
            else:
                out = thrs.psort_pairs(keys, vals, **kw)
    finally:
        psort.WIRE = None
    if rec is not None:
        report["spans"] = [list(s) for s in rec.spans if s.name != "gc"]
        report["counts"] = [[c, name, v] for (c, name), v in
                            rec.counts.items()]
    if kw.get("donate") and case["fn"] != "indices":
        first = out[0] if isinstance(out, tuple) else out
        report["donated"] = first is keys and (
            case["fn"] == "keys" or out[1] is vals)
    flag = None
    if kw.get("check"):
        *out, flag = out
        out = tuple(out)
    if case["fn"] == "pairs":
        k, v = out
        _save(case_dir, case["name"], rank, "keys", k)
        for part, t in (v.items() if isinstance(v, dict) else [("v", v)]):
            _save(case_dir, case["name"], rank, part, t)
    else:
        _save(case_dir, case["name"], rank, case["fn"],
              out[0] if isinstance(out, tuple) else out)
    report["overflow"] = flag
    return report


def main():
    case_dir, world, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(1)
    multihost.initialize(backend="gloo",
                         init_method="file://" + os.path.join(case_dir,
                                                              "store"),
                         world_size=world, rank=rank)
    with open(os.path.join(case_dir, "cases.json")) as f:
        cases = json.load(f)
    report = {}
    for case in cases:
        try:
            report[case["name"]] = run_case(case, case_dir, rank)
        except RuntimeError as e:
            report[case["name"]] = {"overflow": None, "error": str(e)}
        except Exception:
            report[case["name"]] = {"overflow": None,
                                    "error": traceback.format_exc()}
    with open(os.path.join(case_dir, f"r{rank}.json"), "w") as f:
        json.dump(report, f)
    torch.distributed.destroy_process_group()
    print(f"rank {rank}: ok", flush=True)


if __name__ == "__main__":
    main()
