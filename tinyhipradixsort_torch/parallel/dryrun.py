"""A dry run of the distributed sort over a ``torch.distributed`` group (the
counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``).

Every rank of the default group calls :func:`dryrun_multichip`; each
scenario draws its global input from a fixed seed on every rank, sorts the
rank's even piece with ``psort_*``, gathers the pieces on rank 0, checks the
whole output against numpy there, and rank 0 prints one line. A failed
check raises on every rank together (the verdicts are reduced first), so
none is left waiting in a collective. Under ``torchrun``:

    torchrun --nproc_per_node=8 -m tinyhipradixsort_torch.parallel.dryrun

(NCCL on CUDA, one rank per card; gloo on CPU tensors elsewhere.)
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from . import multihost, psort

_SIGNED = {4: torch.int32, 8: torch.int64}
_UNSIGNED = {4: np.uint32, 8: np.uint64}


def _device(group) -> torch.device:
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _spans(n: int, P_: int) -> list:
    """(offset, length) of each rank's even piece of n elements."""
    lengths = [n // P_ + (r < n % P_) for r in range(P_)]
    return [(sum(lengths[:r]), lengths[r]) for r in range(P_)]


def _gather(t: torch.Tensor, spans: list, group) -> np.ndarray:
    """The ranks' pieces of a 32/64-bit tensor, concatenated in rank order,
    as unsigned numpy bits (every rank gets them; rank 0 reads them)."""
    size = max(ln for _, ln in spans)
    word = t.view(_SIGNED[t.dtype.itemsize])
    buf = torch.zeros(size, dtype=word.dtype, device=word.device)
    buf[:word.shape[0]] = word
    out = [torch.empty_like(buf) for _ in spans]
    dist.all_gather(out, buf, group=group)
    return np.concatenate([o[:ln].cpu().numpy() for o, (_, ln) in
                           zip(out, spans)]).view(_UNSIGNED[t.dtype.itemsize])


def _agree(ok: bool, group, dev) -> bool:
    """True on every rank of the group iff it is True on each of them."""
    flag = torch.tensor([int(ok)], dtype=torch.int32, device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
    return bool(flag.item())


def _scenarios(n: int, P_: int):
    """(label, call, keys, values, kwargs, members): members is the number
    of ranks that sort (the first ones), or None for all of them."""
    rng = np.random.default_rng(0)
    u32 = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    vals = np.arange(n, dtype=np.uint32)
    ko = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    ko[rng.random(n) < 0.02] = 0xFFFFFFFF
    zipf = np.minimum(rng.zipf(1.3, size=n), 2**31).astype(np.uint32)
    zipf[rng.random(n) < 0.5] = 7
    yield "uniform psort_pairs", "pairs", u32, vals, {}, None
    yield ("keys-only psort_keys (2% 0xFFFFFFFF keys)", "keys", ko, None,
           {}, None)
    yield "zipf+duplicates psort_pairs", "pairs", zipf, vals, {}, None
    if P_ > 2:
        n3 = (P_ - 1) * 14336
        yield ("non-pow2 group psort_pairs", "pairs",
               rng.integers(0, 2**32, size=n3, dtype=np.uint32),
               np.arange(n3, dtype=np.uint32), {}, P_ - 1)
    yield "psort_indices (zipf)", "indices", zipf, None, {}, None
    dup = rng.integers(0, 1000, size=n, dtype=np.uint32)
    yield ("descending psort_pairs", "pairs", dup, vals,
           {"order": "descending"}, None)
    yield ("bit window [8, 24) psort_pairs", "pairs", u32, vals,
           {"start_bit": 8, "end_bit": 24}, None)
    yield "donate=True psort_pairs", "pairs", u32, vals, {"donate": True}, None


def _oracle(keys, values, kwargs):
    """numpy's stable order of the scenario: (sorted keys, values or the
    permutation)."""
    bits = keys.astype(np.uint64)
    if "start_bit" in kwargs:
        bits = (bits >> np.uint64(kwargs["start_bit"])) & np.uint64(
            (1 << (kwargs["end_bit"] - kwargs["start_bit"])) - 1)
    if kwargs.get("order") == "descending":
        bits = ~bits
    perm = np.argsort(bits, kind="stable")
    return keys[perm], (perm if values is None else values[perm])


def dryrun_multichip(group=None, n: int = 1 << 20) -> list:
    """Run the dry run's scenarios over ``group`` (``None``: the default
    group; a group of ``P - 1`` ranks for the non-power-of-two one is made
    only when ``group`` is ``None`` and ``P > 2``, since making a group is
    collective over the default group). Returns rank 0's lines (one per
    scenario; other ranks get an empty list); raises ``AssertionError`` on
    every rank if a check fails."""
    P_ = dist.get_world_size(group)
    me = dist.get_rank(group)
    dev = _device(group)
    lines = []
    for label, call, keys, values, kwargs, members in _scenarios(n, P_):
        sub = group
        if members is not None:
            if group is not None:
                continue
            sub = dist.new_group(list(range(members)))
            if me >= members:
                continue
        spans = _spans(keys.shape[0], dist.get_world_size(sub))
        off, ln = spans[dist.get_rank(sub)]
        k = torch.from_numpy(keys[off:off + ln].copy()).to(dev)
        wire = {}
        psort.WIRE = lambda step, nw: wire.setdefault(step, nw)
        try:
            if call == "keys":
                out = psort.psort_keys(k, group=sub, check=True, **kwargs)
            elif call == "indices":
                out = psort.psort_indices(k, group=sub, check=True, **kwargs)
            else:
                v = torch.from_numpy(values[off:off + ln].copy()).to(dev)
                out = psort.psort_pairs(k, v, group=sub, check=True, **kwargs)
        finally:
            psort.WIRE = None
        *out, overflow = out
        # a donated call returns the caller's own tensors
        ok = not kwargs.get("donate") or (out[0] is k and out[1] is v)
        got = [_gather(t, spans, sub) for t in out]
        if me == 0:
            want_k, want_v = _oracle(keys, values, kwargs)
            want = [want_v] if call == "indices" else [want_k]
            want += [want_v] if call == "pairs" else []
            ok = (ok and not overflow
                  and all(np.array_equal(g, w.astype(g.dtype))
                          for g, w in zip(got, want)))
            if call == "keys":
                ok = ok and wire.get("ring") == 1
        if not _agree(ok, sub, dev):
            raise AssertionError(f"dryrun_multichip: {label} failed")
        if me == 0:
            extra = f", ring carries {wire['ring']} word" if call == "keys" \
                else ""
            lines.append(f"dryrun_multichip: {label} ok (n={keys.shape[0]}, "
                         f"P={len(spans)}{extra})")
            print(lines[-1], flush=True)
    return lines


def main() -> None:
    multihost.initialize()
    try:
        dryrun_multichip()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
