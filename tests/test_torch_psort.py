"""The port's distributed sort (``psort_keys``, ``psort_pairs``,
``psort_indices``) in gloo worlds of 8, 4, 3 and 1 CPU processes, against
the JAX package's psort on a mesh of as many of conftest's 8 CPU devices.

Every rank passes its piece of the same global input; the concatenation of
the ranks' outputs must be bit-identical to the JAX output on the
concatenated input (the unique globally stable order, whatever local
engine either side runs: the port's cases name ``"bitonic"`` or
``"counting"``, their plain twins here, or the default lexsort), and with
``check=True`` every rank's overflow flag must equal the JAX flag. The cases
mirror ``tests/test_distributed.py`` (the two-word index, the keys-only
path that synthesizes the index, real keys equal to the pad fill), plus
uneven pieces, ``donate=True``, a world of one and the dry run. The words
per element that each exchange step carried are held to the keys-only
wire of the JAX package.

Each world size starts one world for all of its cases (a world takes
seconds to start): the ranks run ``tests/_torch_psort_worker.py`` by path,
with inputs and outputs as .npy files and a FileStore in a temporary
directory, so parallel test workers never share a port.
"""

import json
import os
import subprocess
import sys
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.torch_helpers import assert_bits_equal
from tinyhipradixsort_tpu.parallel import (
    make_sort_mesh, psort_indices, psort_keys, psort_pairs)

_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "_torch_psort_worker.py")
_JAX_FNS = {"keys": psort_keys, "pairs": psort_pairs,
            "indices": psort_indices}


@dataclass
class Case:
    P: int
    name: str
    fn: str
    keys: np.ndarray
    kwargs: dict = field(default_factory=dict)
    values: object = None  # None, an array, or a dict of arrays
    lengths: list = None  # each rank's piece (default: as even as can be)
    group: list = None  # the ranks of a subgroup (default: all of them)

    def members(self):
        return list(range(self.P)) if self.group is None else self.group

    def pieces(self):
        if self.lengths is not None:
            return list(self.lengths)
        n = self.keys.shape[0]
        return [n // self.P + (r < n % self.P) for r in range(self.P)]


def _build_cases():
    rng = np.random.default_rng(0x7D57)
    cases = []

    def add(P, name, fn, keys, **kw):
        cases.append(Case(P, name, fn, keys, **kw))

    def rand(dtype, n):
        dtype = np.dtype(dtype)
        if dtype.kind == "f":
            return rng.standard_normal(n).astype(dtype)
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max, size=n, dtype=dtype,
                            endpoint=True)

    for dtype in (np.uint32, np.int32, np.float32, np.uint64):
        for n in (8, 1000, 100001):
            add(8, f"keys-{np.dtype(dtype).name}-{n}", "keys",
                rand(dtype, n), kwargs={"check": True})
    add(8, "keys-descending", "keys", rand(np.uint32, 20000),
        kwargs={"order": "descending"})
    n = 50000
    skews = {
        "constant": np.full(n, 42, dtype=np.uint32),
        "zipf": np.minimum(rng.zipf(1.3, size=n), 2**31).astype(np.uint32),
        "two-values": np.where(rng.random(n) < 0.95, 7,
                               123456789).astype(np.uint32),
    }
    for skew, x in skews.items():
        add(8, f"pairs-{skew}", "pairs", x, kwargs={"check": True},
            values=np.arange(n, dtype=np.uint32))
    n = 30000
    add(8, "pairs-dict-payload", "pairs",
        rng.integers(0, 64, size=n).astype(np.uint32),
        values={"idx": np.arange(n, dtype=np.uint32),
                "wide": rng.integers(0, 2**64, size=n, dtype=np.uint64)})
    add(8, "indices", "indices",
        rng.integers(0, 100, size=12345, dtype=np.uint32))
    x = rng.standard_normal(9999).astype(np.float32)
    x[rng.random(9999) < 0.1] = 0.0
    x[rng.random(9999) < 0.1] = -0.0
    add(8, "keys-f32-signed-zeros", "keys", x)
    add(8, "keys-bitonic", "keys", rand(np.uint32, 4096),
        kwargs={"method": "bitonic"})
    add(8, "pairs-bitonic-duplicates", "pairs",
        rng.integers(0, 6, size=3000).astype(np.uint32),
        kwargs={"method": "bitonic"}, values=np.arange(3000, dtype=np.uint32))
    x = rand(np.uint32, 16384)
    add(8, "overflow-flag", "keys", x,
        kwargs={"check": True, "_unsafe_cap": 64})
    add(8, "overflow-raises", "keys", x, kwargs={"_unsafe_cap": 64})
    add(8, "slack-oversample", "keys", rand(np.uint32, 20000),
        kwargs={"check": True, "slack": 0.1, "oversample": 4})
    for desc in (False, True):
        order = "descending" if desc else "ascending"
        wrng = np.random.default_rng(77 + desc)
        for start in (0, 24, 56):
            keys = wrng.integers(0, 2**64, size=20000, dtype=np.uint64)
            kw = {"order": order, "start_bit": start, "end_bit": start + 8}
            add(8, f"pairs-window-{order}-{start}", "pairs", keys, kwargs=kw,
                values=np.arange(20000, dtype=np.uint32))
            if not desc:
                add(8, f"keys-window-{order}-{start}", "keys", keys,
                    kwargs=kw)
    add(8, "keys-window-3-17", "keys", rand(np.uint32, 15000),
        kwargs={"start_bit": 3, "end_bit": 17})
    x = rng.standard_normal(12000).astype(np.float32)
    x[rng.random(12000) < 0.1] = 0.0
    x[rng.random(12000) < 0.1] = -0.0
    for exact in (True, False):
        add(8, f"pairs-zeros-exact-{exact}", "pairs", x,
            kwargs={"zeros_exact": exact},
            values=np.arange(12000, dtype=np.uint32))
    asc = np.arange(50000, dtype=np.uint32)
    for label, x in (("two-values", np.where(
            np.random.default_rng(99).random(50000) < 0.95, 7,
            123456789).astype(np.uint32)),
            ("presorted", asc), ("reversed", asc[::-1].copy())):
        add(8, f"refine-{label}", "keys", x, kwargs={"check": True})
    x = rand(np.uint32, 30000)
    add(8, "refine-off-keys", "keys", x,
        kwargs={"check": True, "refine": False})
    add(8, "refine-off-pairs", "pairs", x, kwargs={"refine": False},
        values=np.arange(30000, dtype=np.uint32))
    # the two-word (u64) global index at test size, heavy duplicates
    x = rng.integers(0, 256, size=30000).astype(np.uint32)
    add(8, "wide-pairs", "pairs", x, kwargs={"_force_wide": True},
        values=np.arange(30000, dtype=np.uint32))
    x = rng.integers(0, 50, size=8192, dtype=np.uint32)
    add(8, "wide-indices", "indices", x, kwargs={"_force_wide": True})
    add(8, "wide-keys-bitonic", "keys", x,
        kwargs={"_force_wide": True, "method": "bitonic", "check": True})
    # keys-only without the index on the wire: real keys equal to the pad
    # fill (all-ones ascending, 0 descending), entry pads, both widths
    x = rand(np.uint32, 100001)
    x[rng.random(100001) < 0.05] = 0xFFFFFFFF
    add(8, "sentinel-keys", "keys", x, kwargs={"check": True})
    add(8, "sentinel-keys-wide", "keys", x, kwargs={"_force_wide": True})
    x = x.copy()
    x[rng.random(100001) < 0.05] = 0
    add(8, "sentinel-keys-descending", "keys", x,
        kwargs={"order": "descending"})
    add(8, "constant-keys-no-overflow", "keys",
        np.full(65536, 0xDEAD, dtype=np.uint32), kwargs={"check": True})
    add(8, "keys-u64-descending", "keys", rand(np.uint64, 30000),
        kwargs={"order": "descending"})
    add(8, "keys-i32-descending-bitonic", "keys", rand(np.int32, 4096),
        kwargs={"order": "descending", "method": "bitonic"})
    add(8, "dryrun", "dryrun", np.zeros(8, dtype=np.uint32),
        kwargs={"n": 1 << 16})
    # the local sort on counting (its CPU twin), the merges on the
    # network's: the key words sorted alone, the index carried, real keys
    # equal to the pad fill kept before the entry pads
    cnt = {"method": "counting"}
    add(8, "counting-keys", "keys", rand(np.uint32, 100001),
        kwargs={**cnt, "check": True})
    add(8, "counting-pairs-zipf", "pairs", skews["zipf"], kwargs=cnt,
        values=np.arange(50000, dtype=np.uint32))
    add(8, "counting-pairs-dict-payload", "pairs",
        rng.integers(0, 64, size=30000).astype(np.uint32), kwargs=cnt,
        values={"a": rand(np.uint32, 30000), "b": rand(np.uint64, 30000),
                "c": rand(np.int32, 30000), "d": rand(np.uint64, 30000)})
    add(8, "counting-indices", "indices",
        rng.integers(0, 100, size=12345, dtype=np.uint32), kwargs=cnt)
    x = rand(np.uint32, 100001)
    x[rng.random(100001) < 0.05] = 0xFFFFFFFF
    add(8, "counting-sentinel-keys", "keys", x,
        kwargs={**cnt, "check": True})
    add(8, "counting-sentinel-keys-wide", "keys", x,
        kwargs={**cnt, "_force_wide": True})
    add(8, "counting-sentinel-indices", "indices", x, kwargs=cnt)
    x = x.copy()
    x[rng.random(100001) < 0.05] = 0
    add(8, "counting-sentinel-keys-descending", "keys", x,
        kwargs={**cnt, "order": "descending"})
    x = rng.integers(0, 256, size=30000).astype(np.uint32)
    add(8, "counting-wide-pairs", "pairs", x,
        kwargs={**cnt, "_force_wide": True},
        values=np.arange(30000, dtype=np.uint32))
    add(8, "counting-wide-indices", "indices", x,
        kwargs={**cnt, "_force_wide": True})
    add(8, "counting-keys-u64", "keys", rand(np.uint64, 30001),
        kwargs={**cnt, "check": True})
    add(8, "counting-keys-u64-descending", "keys", rand(np.uint64, 30001),
        kwargs={**cnt, "order": "descending"})
    add(8, "counting-keys-f32-signed-zeros", "keys",
        np.where(rng.random(9999) < 0.2, -0.0,
                 rng.standard_normal(9999)).astype(np.float32), kwargs=cnt)
    # bit windows: the counting passes cover the window's bits alone, with
    # the pads' all-ones above them (20001 keys: entry pads)
    wkeys = rand(np.uint64, 20001)
    wkeys[rng.random(20001) < 0.05] = 2**64 - 1
    for start, end in ((24, 32), (3, 17), (5, 50)):
        add(8, f"counting-pairs-window-{start}-{end}", "pairs", wkeys,
            kwargs={**cnt, "start_bit": start, "end_bit": end},
            values=np.arange(20001, dtype=np.uint32))

    # uneven pieces, empty ones included
    x = rand(np.uint32, 1042)
    uneven = [0, 5, 1000, 37]
    add(4, "uneven-keys", "keys", x, lengths=uneven)
    add(4, "uneven-pairs", "pairs", x % 100, lengths=uneven,
        values=rand(np.uint64, 1042))
    add(4, "uneven-indices", "indices", x % 10, lengths=uneven,
        kwargs={"order": "descending"})
    add(4, "uneven-bitonic", "keys", x, lengths=[300, 0, 0, 742],
        kwargs={"method": "bitonic"})
    add(4, "uneven-counting-keys", "keys", x, lengths=uneven,
        kwargs={"method": "counting"})
    add(4, "uneven-counting-pairs-descending", "pairs", x % 100,
        lengths=[600, 0, 442, 0], values=rand(np.uint64, 1042),
        kwargs={"method": "counting", "order": "descending"})
    for fn in ("keys", "pairs", "indices"):
        add(4, f"uneven-donate-{fn}", fn, x % 1000, lengths=uneven,
            kwargs={"donate": True},
            values=rand(np.uint64, 1042) if fn == "pairs" else None)
    # group=: a subgroup of three of the four ranks sorts on its own
    add(4, "subgroup-1-2-3", "keys", rand(np.uint32, 5000),
        lengths=[0, 1700, 1300, 2000], group=[1, 2, 3])
    # a mesh of three (B must divide by P)
    add(3, "keys-bitonic-7777", "keys", rand(np.uint32, 7777),
        kwargs={"method": "bitonic"})
    for n in (1, 49, 5000):
        add(3, f"keys-{n}", "keys", rand(np.uint32, n))
    # a world of one: no exchange at all
    add(1, "keys", "keys", rand(np.uint32, 1001))
    add(1, "pairs-bitonic", "pairs", rand(np.uint32, 1001) % 50,
        kwargs={"method": "bitonic"}, values=rand(np.uint64, 1001))
    add(1, "indices", "indices", rand(np.int32, 1001), kwargs={"check": True})
    add(1, "counting-pairs", "pairs", rand(np.uint32, 1001) % 50,
        kwargs={"method": "counting"}, values=rand(np.uint64, 1001))
    # a piece of exactly B: the donated words are swept where they lie
    x = rand(np.uint32, 1024)
    add(1, "donate-keys-bitonic", "keys", x,
        kwargs={"donate": True, "method": "bitonic"})
    add(1, "donate-pairs-bitonic", "pairs", x % 7,
        kwargs={"donate": True, "method": "bitonic"},
        values=rand(np.uint64, 1024))
    return cases


CASES = _build_cases()


def _save_inputs(case_dir, cases):
    table = []
    for c in cases:
        entry = {"name": c.name, "fn": c.fn, "kwargs": c.kwargs,
                 "lengths": c.pieces(), "keys": f"{c.name}.in.keys.npy",
                 "values": None, "group": c.group}
        np.save(os.path.join(case_dir, entry["keys"]), c.keys)
        if isinstance(c.values, dict):
            entry["values"] = {}
            for k, v in c.values.items():
                entry["values"][k] = f"{c.name}.in.{k}.npy"
                np.save(os.path.join(case_dir, entry["values"][k]), v)
        elif c.values is not None:
            entry["values"] = f"{c.name}.in.v.npy"
            np.save(os.path.join(case_dir, entry["values"]), c.values)
        table.append(entry)
    with open(os.path.join(case_dir, "cases.json"), "w") as f:
        json.dump(table, f)


def _run_world(case_dir, P):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, _WORKER, str(case_dir), str(P), str(r)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(P)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"rank {r}: ok" in out, out
    reports = []
    for r in range(P):
        with open(os.path.join(case_dir, f"r{r}.json")) as f:
            reports.append(json.load(f))
    return reports


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """World size -> (case directory, per-rank reports); each world runs
    once, with all of its cases, at the first test that needs it."""
    done = {}

    def get(P):
        if P not in done:
            case_dir = tmp_path_factory.mktemp(f"psort_world{P}")
            _save_inputs(case_dir, [c for c in CASES if c.P == P])
            done[P] = (case_dir, _run_world(case_dir, P))
        return done[P]
    return get


def _concat(case_dir, case, part):
    return np.concatenate([np.load(os.path.join(
        case_dir, f"{case.name}.r{r}.{part}.npy")) for r in case.members()])


def _jax_call(case):
    # the JAX side sorts locally with lexsort, whatever engine the port's
    # case names: the output is the unique stable order either way
    kw = dict(case.kwargs)
    kw.pop("method", None)
    kw.pop("donate", None)
    mesh = make_sort_mesh(jax.devices()[:len(case.members())])
    values = case.values
    args = (jnp.asarray(case.keys),)
    if case.fn == "pairs":
        args += ({k: jnp.asarray(v) for k, v in values.items()}
                 if isinstance(values, dict) else jnp.asarray(values),)
    return _JAX_FNS[case.fn](*args, mesh=mesh, **kw)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"P{c.P}-{c.name}")
def test_psort_matches_jax(worlds, case):
    case_dir, reports = worlds(case.P)
    got = [rep[case.name] for rep in reports]
    if case.fn == "dryrun":
        # the dry run checks each scenario against numpy itself: rank 0
        # prints its eight lines, the other ranks none
        assert all(g["error"] is None for g in got), got
        lines = [g["lines"] for g in got]
        assert len(lines[0]) == 8 and not any(lines[1:]), lines
        assert all(line.endswith(")") and " ok (" in line
                   for line in lines[0]), lines[0]
        return
    if "_unsafe_cap" in case.kwargs and not case.kwargs.get("check"):
        # every rank raises, after the flag's all_reduce: none hangs
        with pytest.raises(RuntimeError, match="overflow"):
            _jax_call(case)
        for g in got:
            assert g["error"] is not None and "overflow" in g["error"], g
        return
    for g in got:
        assert g["error"] is None, g["error"]
        # a donated call returns the caller's tensors (indices: a new one)
        assert g["donated"] is (True if case.kwargs.get("donate")
                                and case.fn != "indices" else None), g
    out = _jax_call(case)
    if case.kwargs.get("check"):
        *out, flag = out
        assert all(g["overflow"] == bool(flag) for g in got), (got, flag)
        out = out if case.fn == "pairs" else out[0]
    if case.fn == "pairs":
        k, v = out
        assert_bits_equal(_concat(case_dir, case, "keys"), np.asarray(k))
        parts = v.items() if isinstance(v, dict) else [("v", v)]
        for part, leaf in parts:
            assert_bits_equal(_concat(case_dir, case, part),
                              np.asarray(leaf), part)
    else:
        assert_bits_equal(_concat(case_dir, case, case.fn), np.asarray(out))
    # each rank gets back as many elements as it passed in
    for r in case.members():
        ln = case.pieces()[r]
        part = "keys" if case.fn == "pairs" else case.fn
        piece = np.load(os.path.join(case_dir, f"{case.name}.r{r}.{part}.npy"))
        assert piece.shape[0] == ln


#: words per element of each exchange step (relay only for uneven pieces):
#: keys-only sorts carry the key words alone, whatever the index width
WIRE = {
    "keys-uint32-100001": dict.fromkeys(
        ("relay-in", "pre-exchange", "ring", "rebalance", "relay-out"), 1),
    "keys-uint64-100001": dict.fromkeys(
        ("relay-in", "pre-exchange", "ring", "rebalance", "relay-out"), 2),
    "sentinel-keys-wide": dict.fromkeys(
        ("relay-in", "pre-exchange", "ring", "rebalance", "relay-out"), 1),
    "indices": {"relay-in": 1, "pre-exchange": 2, "ring": 2, "rebalance": 2,
                "relay-out": 1},
    "wide-indices": {"pre-exchange": 3, "ring": 3, "rebalance": 3},
    "wide-pairs": {"relay-in": 2, "pre-exchange": 4, "ring": 4,
                   "rebalance": 4, "relay-out": 2},
}


@pytest.mark.parametrize("name", WIRE)
def test_psort_wire_words_per_element(worlds, name):
    _, reports = worlds(8)
    for rep in reports:
        assert rep[name]["wire"] == WIRE[name], (name, rep[name]["wire"])
