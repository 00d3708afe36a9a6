"""The port's recorder (``tinyhipradixsort_torch.tracing``) on the CPU:
off by default, one root span per public call, spans nested inside their
call, the counting engine's stage spans, the split of a call's time by
layer and the names of the spans open at given times, ``observe``'s
order, ``gc`` spans, and ``bitonic_engine.MARK`` unchanged beside a
recording. The launch spans against the kernels' own counters are a card
test (``tests/test_torch_cuda.py``)."""

import gc
import threading

import numpy as np
import pytest
import torch

import tinyhipradixsort_torch as tthrs
from tinyhipradixsort_torch import tracing
from tinyhipradixsort_torch.ops import bitonic_engine as tbe
from tinyhipradixsort_torch.ops import counting_engine as tce
from tinyhipradixsort_torch.tracing import Span

METHODS = ["counting", "bitonic", "argsort", "lsd_argsort"]


def _keys(n, seed=0):
    x = np.random.default_rng(seed).integers(0, 2**32, size=n,
                                              dtype=np.uint32)
    return torch.from_numpy(x)


def _work(spans):
    """The spans that are not collections (a collection may come at any
    allocation)."""
    return [s for s in spans if s.name != "gc"]


def _calls(spans):
    """Spans by call id, gc spans left out."""
    out = {}
    for s in _work(spans):
        out.setdefault(s.call, []).append(s)
    return out


def test_nothing_is_recorded_without_record():
    hooks = list(gc.callbacks)
    assert tracing.span("sort_keys", n=1) is tracing.span("x")
    assert tracing._REC is None
    tthrs.sort_keys(_keys(3000), method="bitonic")
    with tracing.record() as rec:
        assert len(gc.callbacks) == len(hooks) + 1
    assert gc.callbacks == hooks and tracing._REC is None
    tthrs.sort_keys(_keys(3000), method="counting")
    assert rec.spans == [] and rec.instants == [] and rec.counts == {}


@pytest.mark.parametrize("api", ["sort_keys", "sort_pairs"])
@pytest.mark.parametrize("method", ["counting", "bitonic"])
def test_one_root_span_per_call(api, method):
    x = _keys(3000)
    calls = 3
    with tracing.record() as rec:
        for _ in range(calls):
            if api == "sort_keys":
                tthrs.sort_keys(x, method=method)
            else:
                tthrs.sort_pairs(x, torch.arange(3000), method=method)
    roots = [s for s in _work(rec.spans) if s.parent is None]
    assert [s.name for s in roots] == [api] * calls
    assert sorted(s.call for s in roots) == list(range(1, calls + 1))
    engine = "counting.sort" if method == "counting" else "bitonic.sort_words"
    assert sum(s.name == engine for s in rec.spans) == calls


@pytest.mark.parametrize("method", METHODS)
def test_every_span_lies_inside_its_parent_and_its_call(method):
    with tracing.record() as rec:
        tthrs.sort_keys(_keys(3000), method=method)
        tthrs.sort_indices(_keys(1500, 1), method=method)
    by_id = {s.id: s for s in rec.spans}
    assert len(by_id) == len(rec.spans)
    for s in _work(rec.spans):
        assert s.start <= s.end
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.call == s.call
            assert p.start <= s.start and s.end <= p.end
    assert sorted(_calls(rec.spans)) == [1, 2]
    for i in rec.instants:
        assert by_id[i.parent].call == i.call


@pytest.mark.parametrize("window,passes", [((0, 32), 4), ((8, 24), 2)],
                         ids=["32-bit", "16-bit"])
def test_counting_records_four_stage_spans_a_pass(window, passes):
    with tracing.record() as rec:
        got = tthrs.sort_keys(_keys(3000), method="counting",
                              start_bit=window[0], end_bit=window[1])
    stages = [s for s in rec.spans if s.name in (
        "counting.histogram", "counting.scan", "counting.rank_scatter",
        "counting.gathers")]
    assert len(stages) == 4 * passes
    assert [s.attrs["pass"] for s in stages] == sorted(
        list(range(passes)) * 4)
    shifts = sorted({s.attrs["shift"] for s in stages})
    assert shifts == list(range(window[0], window[1], 8))
    assert [s.name for s in rec.spans].count("counting.pad") == 1
    sort = next(s for s in rec.spans if s.name == "counting.sort")
    assert all(s.parent == sort.id for s in stages)
    assert got.shape == (3000,)


@pytest.mark.parametrize("api", ["sort_keys", "sort_pairs"])
@pytest.mark.parametrize("n,copies", [(4096, 0), (3000, 1)],
                         ids=["whole-tiles", "ragged"])
def test_counting_counts_the_arrays_its_pad_stage_copies(n, copies, api):
    # whole tiles are read where they lie; a ragged n pads the bits and
    # each array (the values of sort_pairs; the keys come from the bits)
    args = (_keys(n), torch.arange(n)) if api == "sort_pairs" \
        else (_keys(n),)
    with tracing.record() as rec:
        getattr(tthrs, api)(*args, method="counting")
    got = rec.counts.get((1, "counting.pad_copies"), 0)
    assert got == copies * len(args)
    assert [s.name for s in rec.spans].count("counting.pad") == 1


WIDTH_CASES = {  # keys, payload, window -> key_bytes, payload_bytes, passes
    "u32-keys": (torch.uint32, None, (0, 32), 4, 0, 4),
    "u32-keys-16-bit": (torch.uint32, None, (8, 24), 4, 0, 2),
    "u64-pairs": (torch.uint64, torch.uint64, (0, 64), 8, 8, 8),
}


@pytest.mark.parametrize("case", list(WIDTH_CASES))
def test_counting_records_its_widths_and_bytes(case):
    from sortbench import stats
    key_dt, val_dt, (lo, hi), key_bytes, payload_bytes, passes = \
        WIDTH_CASES[case]
    n, npad = 3000, 4096  # two tiles of 2048
    bits = np.random.default_rng(3).integers(0, 2**64, n, dtype=np.uint64,
                                             endpoint=False)
    keys = torch.from_numpy(bits).view(torch.int64).to(
        torch.int32 if key_dt == torch.uint32 else torch.int64).view(key_dt)

    def call():
        kw = {"method": "counting", "start_bit": lo, "end_bit": hi}
        if val_dt is None:
            return tthrs.sort_keys(keys, **kw)
        return tthrs.sort_pairs(keys, torch.arange(n).view(val_dt), **kw)

    call()  # off: records nothing, and the widths cost no work
    assert tracing._REC is None
    with tracing.record() as rec:
        call()
    sort = next(s for s in rec.spans if s.name == "counting.sort")
    assert sort.attrs == {"n": n, "words": int(val_dt is not None),
                          "key_bytes": key_bytes,
                          "payload_bytes": payload_bytes, "idx_bytes": 4,
                          "passes": passes}
    stages = [s for s in rec.spans if s.name.startswith("counting.")
              and s.name not in ("counting.sort", "counting.pad")]
    assert len(stages) == 4 * passes
    assert {s.attrs["width"] for s in stages} == {8}
    assert rec.counts[(1, "counting.passes")] == passes
    assert rec.counts[(1, "counting.moved_bytes")] == stats.lsd_floor_bytes(
        npad, key_bytes, payload_bytes, hi - lo)


@pytest.mark.parametrize("method", METHODS)
def test_the_layers_sum_to_the_root_span(method):
    with tracing.record() as rec:
        for seed in range(2):
            tthrs.sort_pairs(_keys(2500, seed), torch.arange(2500),
                             method=method)
    split = tracing.split(rec.spans)
    for call, spans in _calls(rec.spans).items():
        root = next(s for s in spans if s.parent is None)
        layers = split[call]
        assert abs(sum(layers.values()) - (root.end - root.start)) \
            <= 1000 * len(spans)
        assert layers["api"] > 0 and layers["engines"] > 0
        assert layers["kernels"] == 0  # no launch on the CPU


def test_observe_sees_begin_and_end_in_nesting_order():
    seen = []
    with tracing.observe(lambda event, name, attrs:
                         seen.append((event, name))) as rec:
        tthrs.sort_keys(_keys(3000), method="bitonic")
    stack = []
    for event, name in seen:
        if event == "begin":
            stack.append(name)
        elif event == "end":
            assert stack.pop() == name
    assert stack == []
    assert seen[0] == ("begin", "sort_keys") and seen[-1] == ("end",
                                                               "sort_keys")
    assert ("instant", "bitonic.route") in seen
    ends = [name for event, name in seen if event == "end"]
    assert ends == [s.name for s in _work(rec.spans)]


def test_observe_inside_record_joins_it():
    seen = []
    with tracing.record() as rec:
        with tracing.observe(lambda *a: seen.append(a[0])) as inner:
            assert inner is rec
            tthrs.sort_keys(_keys(2000), method="argsort")
        tthrs.sort_keys(_keys(2000), method="argsort")
        with pytest.raises(RuntimeError):
            with tracing.record():
                pass
    assert seen == ["begin", "begin", "end", "end"]
    assert len([s for s in _work(rec.spans) if s.parent is None]) == 2


def test_a_collection_is_a_gc_span_outside_the_tree():
    with tracing.record() as rec:
        with tracing.span("outer", n=1):
            gc.collect()
        gc.collect()
    gcs = [s for s in rec.spans if s.name == "gc" and s.attrs["gen"] == 2]
    outer = next(s for s in rec.spans if s.name == "outer")
    assert len(gcs) == 2 and all(s.parent is None for s in gcs)
    assert gcs[0].call == outer.call and gcs[1].call is None
    assert outer.start <= gcs[0].start and gcs[0].end <= outer.end
    # the collection stays in the root's own time
    assert tracing.split(rec.spans)[outer.call]["api"] == outer.end - \
        outer.start
    mid = (gcs[0].start + gcs[0].end) // 2
    assert tracing.paths_at(rec.spans, [mid]) == ["gc"]


def _mark_events(call):
    got = []
    tbe.MARK = lambda event, name, words: got.append(
        (event, name, int(words[0].shape[0]), len(words)))
    try:
        call()
    finally:
        tbe.MARK = None
    return got


@pytest.mark.parametrize("shape", [(3000,), (4096,), (6, 700)],
                         ids=["segmented", "padded", "rows"])
def test_mark_beside_a_recording_sees_what_it_sees_alone(shape):
    x = _keys(int(np.prod(shape))).view(shape)

    def call():
        return tthrs.sort_pairs(x, x.to(torch.int64), method="bitonic")

    alone = _mark_events(call)
    with tracing.record() as rec:
        beside = _mark_events(call)
    assert beside == alone and alone
    routes = [e[1] for e in alone if e[0] == "route"]
    assert [i.attrs["route"] for i in rec.instants] == routes
    parts = [e[1] for e in alone if e[0] == "end"]
    assert [s.name for s in rec.spans if s.name.startswith("bitonic.")
            and not s.name.startswith("bitonic.sort_words")] == [
        f"bitonic.{p}" for p in parts]


def test_counts_belong_to_the_open_call():
    with tracing.record() as rec:
        tracing.count("launches")
        with tracing.span("a"):
            tracing.count("launches", 2)
            with tracing.span("b"):
                tracing.count("launches")
                tracing.event("bitonic.route", route="padded")
        with tracing.span("c"):
            pass
    assert rec.counts == {(None, "launches"): 1, (1, "launches"): 3}
    work = _work(rec.spans)
    assert [(s.name, s.call) for s in work] == [("b", 1), ("a", 1),
                                                ("c", 2)]
    (instant,) = rec.instants
    assert instant.call == 1 and instant.parent == work[0].id
    assert rec.memory is None  # no CUDA here


def test_a_public_call_inside_an_open_span_is_its_child():
    with tracing.record() as rec:
        with tracing.span("outer"):
            tthrs.sort_keys(_keys(1000), method="argsort")
            tthrs.sort_keys(_keys(1000), method="argsort")
    assert {s.call for s in _work(rec.spans)} == {1}
    outer = next(s for s in rec.spans if s.name == "outer")
    assert [s.name for s in rec.spans if s.parent == outer.id] == [
        "sort_keys", "sort_keys"]


def test_other_threads_record_nothing():
    with tracing.record() as rec:
        t = threading.Thread(target=lambda: tthrs.sort_keys(
            _keys(1000), method="argsort"))
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
    assert _work(rec.spans) == [] and rec.counts == {}


def _tree():
    """A hand-built call: ``sort_keys`` [0, 100) > ``bitonic.sort_words``
    [10, 90) > launches [20, 30) and [50, 70) (a build inside the second,
    [55, 60)); a ``gc`` span [40, 45); a second call [200, 210)."""
    return [
        Span("launch.bitonic_sweep", 1, 3, 2, 20, 30, {}),
        Span("gc", 1, 4, None, 40, 45, {"gen": 0}),
        Span("cuda_lib.build", 1, 6, 5, 55, 60, {}),
        Span("launch.bitonic_sweep", 1, 5, 2, 50, 70, {}),
        Span("bitonic.sort_words", 1, 2, 1, 10, 90, {}),
        Span("sort_keys", 1, 1, None, 0, 100, {}),
        Span("argsort.sort", 2, 8, 7, 202, 209, {}),
        Span("sort_keys", 2, 7, None, 200, 210, {}),
    ]


def test_split_of_a_hand_built_call():
    assert tracing.split(_tree()) == {
        1: {"api": 20, "engines": 50, "kernels": 30},
        2: {"api": 3, "engines": 7, "kernels": 0}}
    assert tracing.split([]) == {}


def test_paths_at_name_the_innermost_span():
    got = tracing.paths_at(_tree(), [5, 25, 42, 57, 80, 95, 150, 205, 300])
    assert got == [
        "sort_keys",
        "sort_keys > bitonic.sort_words > launch.bitonic_sweep",
        "gc",
        "sort_keys > bitonic.sort_words > launch.bitonic_sweep"
        " > cuda_lib.build",
        "sort_keys > bitonic.sort_words",
        "sort_keys",
        None,
        "sort_keys > argsort.sort",
        None]
    assert tracing.paths_at([], [1]) == [None]


def test_engines_called_directly_root_their_own_calls():
    x = _keys(3000).view(torch.int32)
    with tracing.record() as rec:
        tce.sort_arrays_counting(x, [x], 0, 32)
        tbe.sort_words([x], [])
    roots = [s.name for s in _work(rec.spans) if s.parent is None]
    assert roots == ["counting.sort", "bitonic.sort_words"]
    assert set(tracing.split(rec.spans)) == {1, 2}



# -- the distributed sort ----------------------------------------------------

def _children(spans, root):
    """Names of the root's children in the order they started."""
    return [s.name for s in sorted(_work(spans), key=lambda s: s.start)
            if s.parent == root.id]


def _psort_steps(P, rounds, relayed):
    """The children of a psort call's root, in order, on P ranks (the
    runs the ring brings are merged inside its rounds)."""
    steps = ["psort.relay_in"] if relayed else []
    steps += ["psort.pre_exchange"] if P > 1 else []
    steps += ["psort.local_sort", "psort.splitters"]
    steps += ["psort.refine"] * rounds + ["psort.cuts"]
    steps += ["psort.ring"] * P + ["psort.rebalance"]
    return steps + (["psort.relay_out"] if relayed else [])


def _overlap(a0, a1, b0, b1):
    return max(0, min(a1, b1) - max(a0, b0))


def _wire_bytes(P, me, lengths, wire):
    """The bytes rank ``me`` puts in exchange buffers for other ranks:
    the elements each step sends elsewhere times ``psort.WIRE``'s words
    for it, four bytes a word, and the ring's length word a round."""
    from tinyhipradixsort_torch.parallel import psort
    n = sum(lengths)
    plan = psort.capacity_plan(n, P)
    B = plan.B
    off = sum(lengths[:me])
    mine = (me * B, min((me + 1) * B, n))
    sent = {"relay-in": lengths[me] - _overlap(off, off + lengths[me], *mine),
            "pre-exchange": B - B // P,
            "ring": (P - 1) * plan.cap,
            "rebalance": 2 * min(P - 1, 4) * plan.cap3,
            "relay-out": max(mine[1] - mine[0], 0)
            - _overlap(off, off + lengths[me], *mine)}
    words = sum(wire.get(step, 0) * k for step, k in sent.items())
    return 4 * (words + P - 1)


def _check_psort_call(spans, counts, api, P, me, lengths, wire):
    """One rank's record of one psort call: the root and its steps in
    order, the layers summing to the root, ``psort.wire_bytes`` from
    ``psort.WIRE``'s words and the plan, ``psort.host_reads`` (the
    pieces' lengths, the real count, the cuts, one a ring round, the
    counts before the rebalance and the overflow flag) and the local
    sort's engine."""
    from tinyhipradixsort_torch.parallel import psort
    (root,) = [s for s in _work(spans) if s.parent is None]
    assert root.name == api and {s.call for s in _work(spans)} == {root.call}
    plan = psort.capacity_plan(sum(lengths), P)
    rounds = plan.refine[0] if plan.refine else 0
    relayed = any(x != plan.B for x in lengths)
    assert _children(spans, root) == _psort_steps(P, rounds, relayed)
    assert [s.attrs["round"] for s in spans if s.name == "psort.ring"] == \
        list(range(P))
    assert [s.attrs["round"] for s in spans if s.name == "psort.refine"] == \
        list(range(rounds))
    by_id = {s.id: s for s in spans}
    merges = [s for s in spans if s.name == "psort.merge"]
    assert len(merges) == P - 1  # P runs folded into one
    assert all(by_id[s.parent].name == "psort.ring" for s in merges)
    layers = tracing.split(spans)[root.call]
    assert abs(sum(layers.values()) - (root.end - root.start)) \
        <= 1000 * len(spans)
    assert layers["api"] > 0 and layers["engines"] > 0
    assert counts.get((root.call, "psort.wire_bytes"), 0) == \
        _wire_bytes(P, me, lengths, wire)
    assert counts[(root.call, "psort.host_reads")] == 5 + P - 1
    # the local sort's engine: its span's attribute, one count a call
    # (lexsort: these calls sort CPU tensors with the default method)
    (local,) = [s for s in spans if s.name == "psort.local_sort"]
    assert local.attrs["engine"] == "lexsort"
    assert {k: v for k, v in counts.items()
            if k[1].startswith("psort.local.")} == {
        (root.call, "psort.local.lexsort"): 1}


@pytest.fixture(scope="module")
def one_rank_group(tmp_path_factory):
    """A gloo group of this process alone (a FileStore in a fresh folder)."""
    import torch.distributed as dist
    store = tmp_path_factory.mktemp("psort_group") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _psort_call(api, n):
    # ties, which the global index breaks
    x = torch.from_numpy(np.random.default_rng(7).integers(
        0, 100, size=n, dtype=np.uint32))
    if api == "psort_pairs":
        return lambda: tthrs.psort_pairs(x, torch.arange(n))
    return lambda: getattr(tthrs, api)(x)


@pytest.mark.parametrize("api", ["psort_keys", "psort_pairs",
                                 "psort_indices"])
@pytest.mark.parametrize("n", [4096, 3001], ids=["whole", "relayed"])
def test_psort_records_its_steps_at_world_size_one(one_rank_group, api, n):
    from tinyhipradixsort_torch.parallel import psort
    call = _psort_call(api, n)
    wire = {}
    psort.WIRE = lambda step, nw: wire.setdefault(step, nw)
    try:
        with tracing.record() as rec:
            call()
    finally:
        psort.WIRE = None
    _check_psort_call(rec.spans, rec.counts, api, 1, 0, [n], wire)


def test_psort_records_nothing_when_off(one_rank_group, monkeypatch):
    asked = []
    span = tracing.span

    def spy(name, **attrs):
        got = span(name, **attrs)
        asked.append((name, got is tracing._OFF))
        return got

    monkeypatch.setattr(tracing, "span", spy)
    for api in ("psort_keys", "psort_pairs", "psort_indices"):
        _psort_call(api, 3001)()
    assert tracing._REC is None
    assert {name for name, _ in asked} >= {"psort_keys", "psort.ring",
                                           "psort.relay_in"}
    assert all(off for _, off in asked)


_PSORT_WORKER = __file__.replace("test_torch_tracing.py",
                                 "_torch_psort_worker.py")
#: the gloo world of four's recorded cases: (name, fn, lengths)
WORLD_CASES = [("zipf-keys", "keys", [4096] * 4),
               ("zipf-pairs", "pairs", [4096] * 4),
               ("uneven-keys", "keys", [0, 5, 1000, 37])]


@pytest.fixture(scope="module")
def recorded_world(tmp_path_factory):
    """Each rank's report of a gloo world of four that ran WORLD_CASES
    inside ``tracing.record()`` (``tests/_torch_psort_worker.py``)."""
    import json
    import os
    import subprocess
    import sys
    case_dir = tmp_path_factory.mktemp("psort_traced")
    rng = np.random.default_rng(13)
    table = []
    for name, fn, lengths in WORLD_CASES:
        n = sum(lengths)
        keys = np.minimum(rng.zipf(1.3, n), 2**31).astype(np.uint32)
        np.save(case_dir / f"{name}.keys.npy", keys)
        entry = {"name": name, "fn": fn, "kwargs": {}, "lengths": lengths,
                 "keys": f"{name}.keys.npy", "values": None, "group": None,
                 "record": True}
        if fn == "pairs":
            np.save(case_dir / f"{name}.v.npy", np.arange(n, dtype=np.uint32))
            entry["values"] = f"{name}.v.npy"
        table.append(entry)
    (case_dir / "cases.json").write_text(json.dumps(table))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, _PSORT_WORKER, str(case_dir),
                               "4", str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(4)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"rank {r}: ok" in out, out
    return [json.loads((case_dir / f"r{r}.json").read_text())
            for r in range(4)]


@pytest.mark.parametrize("name,fn,lengths", WORLD_CASES,
                         ids=[c[0] for c in WORLD_CASES])
def test_psort_records_its_steps_on_four_ranks(recorded_world, name, fn,
                                               lengths):
    for me, report in enumerate(recorded_world):
        got = report[name]
        assert got["error"] is None, got["error"]
        spans = [Span(*s) for s in got["spans"]]
        counts = {(c, k): v for c, k, v in got["counts"]}
        _check_psort_call(spans, counts, f"psort_{fn}", 4, me, lengths,
                          got["wire"])


def test_auto_records_the_engine_it_chose_and_counts_it():
    # an explicit method records no route of "auto"; on the CPU "auto" is
    # argsort (the counters auto.counting and auto.network are the card's)
    with tracing.record() as rec:
        tthrs.sort_keys(_keys(3000))
        tthrs.sort_pairs(_keys(2000).view(4, 500), torch.arange(2000).view(
            4, 500), method="auto")
        tthrs.sort_indices(_keys(3000), method="argsort")
    roots = {s.call: s for s in _work(rec.spans) if s.parent is None}
    autos = [i for i in rec.instants if i.name == "sort.auto"]
    assert [(i.call, i.attrs) for i in autos] == [
        (1, {"engine": "argsort", "n": 3000}),
        (2, {"engine": "argsort", "n": 2000})]
    assert all(i.parent == roots[i.call].id for i in autos)
    assert {k: v for k, v in rec.counts.items()
            if k[1].startswith("auto.")} == {(1, "auto.argsort"): 1,
                                             (2, "auto.argsort"): 1}
    assert sorted(roots) == [1, 2, 3]
