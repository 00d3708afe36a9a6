"""Where a cell's parts live, found by name.

``BENCHMARK.json`` at the repository's root names each cell's
configuration, traffic mix and metrics. A configuration is
``configs/<name>.json``, a traffic mix ``traffic/<name>.json``, a metric's
reader ``metrics/<name>.py`` and a configuration's plain reference
``references/<name>.py``, all under one root (this folder by default; the
tests pass another). Nothing here knows a cell by name.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BENCHMARK = ROOT.parent / "BENCHMARK.json"

#: what a traffic mix means where its file leaves a key out
TRAFFIC_DEFAULTS = {"pool": 1, "checked_calls": 3, "ranks": 1,
                    "backend": "nccl", "keys": {"dist": "uniform"}}
#: what a configuration means where its file leaves a key out
CONFIG_DEFAULTS = {"value_dtype": None, "values": None, "start_bit": 0,
                   "end_bit": None, "order": "ascending",
                   "reference": "stable_sort"}
#: keys a file has to give, and (configurations) the prose the harness
#: does not read; any other key is refused, since nothing would read it
TRAFFIC_REQUIRED = {"n", "method"}
CONFIG_REQUIRED = {"api", "key_dtype"}
CONFIG_PROSE = {"name", "source", "guarantees", "assumed"}


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(path: Path = BENCHMARK) -> dict:
    return _json(path)


def workload(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    known = ", ".join(c["name"] for c in bench["workloads"])
    raise KeyError(f"no workload {name!r} in the benchmark (known: {known})")


def _checked(kind: str, name: str, given: dict, defaults: dict,
             required: set, prose: set = frozenset()) -> dict:
    unread = set(given) - set(defaults) - required - prose
    missing = required - set(given)
    if unread or missing:
        raise ValueError(f"{kind} {name!r}: keys {sorted(unread)} are read "
                         f"by nothing; {sorted(missing)} are missing")
    return {**defaults, **given}


def config(name: str, root: Path = ROOT) -> dict:
    return _checked("configuration", name,
                    _json(root / "configs" / f"{name}.json"),
                    CONFIG_DEFAULTS, CONFIG_REQUIRED, CONFIG_PROSE)


def traffic(name: str, root: Path = ROOT) -> dict:
    return _checked("traffic", name, _json(root / "traffic" / f"{name}.json"),
                    TRAFFIC_DEFAULTS, TRAFFIC_REQUIRED)


def _module(path: Path):
    """A reader or reference loaded from its file (a name may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    spec = importlib.util.spec_from_file_location(
        f"sortbench_{path.parent.name}_{path.stem}".replace(".", "_")
        .replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(name: str, root: Path = ROOT):
    """The metric's ``read(records) -> float | None``. A name with a dot
    and no file of its own, such as ``keys_per_s.launch_bound`` (the same
    quantity in other cells, under a bound of its own), is read by the
    file of the name before its last dot."""
    path = root / "metrics" / f"{name}.py"
    while not path.is_file() and "." in name:
        name = name.rsplit(".", 1)[0]
        path = root / "metrics" / f"{name}.py"
    return _module(path).read


def reference(name: str, root: Path = ROOT):
    """The configuration's ``expected(keys, values, config) -> outputs``."""
    return _module(root / "references" / f"{name}.py").expected


def metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: with ``trace`` the per-layer
    ones, otherwise the end-to-end ones. A metric with ``workloads`` is
    the listed cells'; a per-layer one without it is every cell's that
    reports the end-to-end metric it moves."""
    def listed(metric):
        return cell in metric.get("workloads", [cell])

    e2e = [m for m in bench["end_to_end"] if listed(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]
