"""Distributed stable sort over a ``torch.distributed`` process group
(PyTorch port of ``tinyhipradixsort_tpu/parallel/psort.py``).

Each rank passes its contiguous piece of the global array, in rank order,
on its own device; pieces may have any length, 0 included. Rank ``r``
gets back the globally sorted ranks ``[off_r, off_r + len_r)``, so the
output has the input's own sharding, as the JAX package's global array
keeps its sharding. The output is the unique globally stable order, so the
concatenation of the ranks' outputs is bit-identical to the JAX
``psort_*`` of the concatenated input, whatever splitters either side picks.

The algorithm is the JAX package's sample sort, step for step, with its
capacity arithmetic integer for integer (so ``check=`` reports the same
overflow verdict). Internally the pieces are re-laid into the JAX package's
padded layout: ``n_pad`` a multiple of ``P * lcm(P, 8)``, ``B = n_pad / P``
elements per rank, pads (all-ones compare words) at the global tail. One
exact ``all_to_all_single`` with uneven splits does that, and one more lays
the result back; both are skipped when every piece already has ``B``
elements.

0. **Mod-P interleaved pre-exchange** (``all_to_all_single``): rank ``j``
   ends up with the global positions ``≡ j (mod P)``, so any
   position-contiguous mass (constant keys, presorted runs) splits evenly.
1. **Local sort** of the ``B`` tuples: the bitonic engine on CUDA, a stable
   ``torch.sort`` per word (the counterpart of ``jnp.lexsort``) elsewhere.
   The compare tuple ends with the global index, so tuples are globally
   distinct and the sort is stable. The index is one u32 word below a
   global n of 2**32 and two, (hi, lo), from there on or with
   ``_force_wide=True``. A keys-only sort whose keys come back from their
   bits (``idx_synth``) ships no index: after the pre-exchange each rank
   synthesizes its words' index from its rank and their positions
   (:func:`_synth_index_words`), sorts with it, and drops it before step 4,
   so the pre-exchange, the ring and the rebalance carry the key words
   alone. From there on every count comes from lengths and cuts: a real
   all-ones key is the pad fill's twin.
2. **Splitters** from an ``all_gather`` of ``s`` regular samples per rank,
   then **exact-rank refinement** (:func:`_refine_cuts`): candidate tuples
   ``all_gather``-ed, ranked exactly by a vectorized search and an
   ``all_reduce``, which drives the splitter rank error to ``O(P)``.
3. **Cuts** clipped to the real-element count: pads never travel.
4. **Ring exchange and merge** (:func:`_ring_exchange_merge`): ``P - 1``
   rounds of ``batch_isend_irecv`` with one send and one receive, each of
   one sentinel-padded ``(cap,)`` buffer per word (plus its length),
   folded into a binary-counter merge tree as it arrives.
5. **Boundary rebalance** to exactly ``B`` per rank: counts
   ``all_gather``-ed, boundary pieces of at most ``cap3`` sent to the
   ``R = min(P - 1, 4)`` ring neighbours on each side, one merge.
6. The overflow flag is ``all_reduce``-d, so with ``check=False`` every rank
   raises together and none is left waiting in a collective.

The cuts and counts come to the host (a few integers per round), so the
slicing around the collectives is plain indexing; the words stay on the
device. ``donate=True`` writes the result into the caller's keys and value
leaves and returns them; where the caller's words enter the local sort as
they are (every piece exactly ``B``, world size 1) the sort sweeps them in
place. Buffers psort made itself (the relay's, the pre-exchange's) are
always swept in place. :data:`WIRE` observes the words each exchange step
carries per element.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .. import keybits
from ..config import SortOrder
from ..ops import bitonic_engine as be
from ..ops import common
from ..sort import _as_input, _check_disjoint, _check_donated, _flatten
from ..sort import _write_back

#: the all-ones u32 sentinel of a compare word (int32 holds the u32 bits)
SENTINEL = -1
_INT32_MIN = -(1 << 31)
_LOCAL_METHODS = ("auto", "bitonic", "lexsort")

#: observer for measurement and tests (``None``: off). Called as
#: ``WIRE(step, nwords)`` where a step builds its exchange buffers, with the
#: words per element they carry: "relay-in" and "relay-out" (only when a
#: piece differs from B), "pre-exchange" and "rebalance" (only at P > 1),
#: "ring" (its own chunk at P = 1 too).
WIRE = None


def _wire(step: str, nwords: int) -> None:
    if WIRE is not None:
        WIRE(step, nwords)


# ---------------------------------------------------------------------------
# collectives (every rank issues the same ones, in the same order)
# ---------------------------------------------------------------------------


def _peer(group, r: int) -> int:
    """Global rank of the group's rank ``r`` (point-to-point ops take it)."""
    return r if group is None else dist.get_global_rank(group, r)


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """``(P,) + t.shape``: every rank's ``t``, in rank order."""
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return torch.stack(out)


def _all_gather_ints(values: list, device, group) -> list:
    """Host lists of ``values`` (ints) from every rank, in rank order."""
    t = torch.tensor(values, dtype=torch.int64, device=device)
    return _all_gather(t, group).tolist()


def _all_to_all(rows: torch.Tensor, send: list, recv: list,
                group) -> torch.Tensor:
    """``all_to_all_single`` of the rows of ``rows`` with splits ``send`` and
    ``recv``; the identity on a group of one."""
    if len(send) == 1:
        return rows
    out = rows.new_empty((sum(recv),) + tuple(rows.shape[1:]))
    dist.all_to_all_single(out, rows.contiguous(), output_split_sizes=recv,
                           input_split_sizes=send, group=group)
    return out


def _sendrecv(buf: torch.Tensor, to: int, frm: int, group) -> torch.Tensor:
    """One ring round: send ``buf`` to rank ``to``, receive a buffer of the
    same shape from rank ``frm``."""
    got = torch.empty_like(buf)
    ops = [dist.P2POp(dist.isend, buf, _peer(group, to), group),
           dist.P2POp(dist.irecv, got, _peer(group, frm), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return got


# ---------------------------------------------------------------------------
# word-tuple helpers (rank-local)
# ---------------------------------------------------------------------------


def _flip(words: list) -> list:
    """Words with the sign bit flipped: int32 order is then the unsigned
    order of the u32 words."""
    return [w ^ _INT32_MIN for w in words]


def _tuple_lt(a_words: list, b_words: list) -> torch.Tensor:
    """a <lex b (unsigned words) for equal-length lists of int32 words
    (broadcasting ok)."""
    a, b = _flip(a_words), _flip(b_words)
    lt = a[-1] < b[-1]
    for aw, bw in zip(reversed(a[:-1]), reversed(b[:-1])):
        lt = (aw < bw) | ((aw == bw) & lt)
    return lt


def _searchsorted_words(sorted_words: list, query_words: list) -> torch.Tensor:
    """Left insertion points (int64) of query tuples in sorted word tuples.

    sorted_words: list of (B,) int32 words; query_words: int32 words of any
    one shape (the search is elementwise over it): a vectorized binary
    search of ``ceil(log2 B) + 1`` steps.
    """
    B = sorted_words[0].shape[0]
    shape, dev = query_words[0].shape, query_words[0].device
    lo = torch.zeros(shape, dtype=torch.int64, device=dev)
    hi = torch.full(shape, B, dtype=torch.int64, device=dev)
    for _ in range(max(int(math.ceil(math.log2(max(B, 1)))) + 1, 1)):
        mid = (lo + hi) // 2
        mid_c = mid.clamp(max=B - 1)
        go_right = (_tuple_lt([w[mid_c] for w in sorted_words], query_words)
                    & (mid < B))
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    return lo


def _lexsort_perm(cmp_words: list) -> torch.Tensor:
    """The stable sorting permutation of the tuples (first word most
    significant): a stable ``torch.sort`` per word, last word first."""
    n = cmp_words[0].shape[0]
    perm = torch.arange(n, dtype=torch.int64, device=cmp_words[0].device)
    for w in reversed(_flip(cmp_words)):
        _, idx = torch.sort(w[perm], stable=True)
        perm = perm[idx]
    return perm


def _resolve_local_method(method: str, device: torch.device) -> str:
    """``"auto"``: the bitonic engine on CUDA, ``"lexsort"`` elsewhere."""
    if method not in _LOCAL_METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of "
                         f"{_LOCAL_METHODS}")
    if method != "auto":
        return method
    return "bitonic" if device.type == "cuda" else "lexsort"


def _local_sort_words(cmp_words: list, carry_words: list, method: str,
                      tuning=None, in_place: bool = False) -> tuple[list, list]:
    """The stable sort of the tuples; ``in_place``: the words are buffers
    the bitonic engine may sweep where they lie."""
    if method == "bitonic":
        return be.sort_words(list(cmp_words), list(carry_words), tuning=tuning,
                             in_place=in_place)
    perm = _lexsort_perm(list(cmp_words))
    return [w[perm] for w in cmp_words], [w[perm] for w in carry_words]


def _merge_runs_tree(cmp_words: list, carry_words: list, nrows: int,
                     rowlen: int, tuning=None):
    """Merge ``nrows`` sorted sentinel-padded runs (concatenated flat, each
    ``rowlen`` long) into one sorted run, on the bitonic engine.

    The runs are already sorted, so pair rows as ``[asc, reversed(asc)]``
    (bitonic) and merge them as rows (``merge_words_rows``): ``log2(nrows)``
    one-stage rounds. Rows pad to a power of two and the row count to a
    power of two, so the output may be longer than the input; sentinels stay
    at the tail.
    """
    if nrows <= 1:
        return list(cmp_words), list(carry_words)
    ncmp = len(cmp_words)
    r = 1 << max(rowlen - 1, 0).bit_length()
    rows = 1 << max(nrows - 1, 0).bit_length()

    def pad(w, fill):
        out = torch.full((rows, r), fill, dtype=w.dtype, device=w.device)
        out[:nrows, :rowlen] = w.view(nrows, rowlen)
        return out.view(-1)

    words = [pad(w, SENTINEL) for w in cmp_words]
    words += [pad(w, 0) for w in carry_words]
    m, k = r, rows
    while k > 1:
        words = [torch.cat([w.view(k // 2, 2, m)[:, 0],
                            torch.flip(w.view(k // 2, 2, m)[:, 1], (1,))],
                           dim=1).reshape(-1) for w in words]
        m, k = m * 2, k // 2
        cw, kw = be.merge_words_rows(words[:ncmp], words[ncmp:], (k, m),
                                     tuning=tuning)
        words = list(cw) + list(kw)
    return words[:ncmp], words[ncmp:]


def _merge_two_runs(a_words: list, b_words: list, ncmp: int, method: str,
                    tuning=None) -> list:
    """Merge two sorted sentinel-padded runs (word lists) into one."""
    if method == "bitonic":
        return be._merge_sorted_runs(list(a_words),
                                     [torch.flip(w, (0,)) for w in b_words],
                                     ncmp, tuning)
    merged = [torch.cat([a, b]) for a, b in zip(a_words, b_words)]
    cw, kw = _local_sort_words(merged[:ncmp], merged[ncmp:], method, tuning)
    return list(cw) + list(kw)


def refine_plan(B: int, P_: int, s: int, k: int = 8):
    """Static ``(rounds, W_f)`` of the exact-rank splitter refinement (the
    JAX package's, integer for integer).

    ``E0 = ceil(B*P/s)`` bounds a sample splitter's global rank error, so the
    candidate space starts at ``W_0 = 2*P*E0 + 2*P``; each round gathers
    ``k`` rank-evenly spaced candidates per rank per boundary with exact
    global ranks and shrinks it to ``W // (k+1) + P + 2``, to a fixed point
    near ``P``.
    """
    W = 2 * P_ * int(math.ceil(B * P_ / max(s, 1))) + 2 * P_
    rounds = 0
    while rounds < 16 and W > P_ + 16:
        Wn = W // (k + 1) + P_ + 2
        if Wn >= W:
            break
        W, rounds = Wn, rounds + 1
    return rounds, W


def _refine_cuts(cmp_words: list, nreal: int, cuts0: torch.Tensor, E0: int,
                 rounds: int, k: int, targets: torch.Tensor, group):
    """Refine the sample splitters' local cuts to near-exact global target
    ranks (the JAX package's ``_refine_cuts``).

    cmp_words: the whole sorted local tuple (its index word makes every
    tuple globally distinct, so ranks are exact on duplicates too). cuts0:
    (Q,) local insertion points of the sample splitters; targets: (Q,)
    global target ranks. Each round brackets the target between the
    candidates of largest rank ``<= target`` and smallest rank ``> target``;
    a bracket is replaced only by a strictly better candidate. The cut is
    the hi bracket's local insertion point, made monotone by a running max.
    """
    dev = cuts0.device
    Q = cuts0.shape[0]
    P_ = dist.get_world_size(group)
    l = (cuts0 - E0).clamp(min=0)
    h = (cuts0 + E0).clamp(max=nreal)
    big = torch.iinfo(torch.int64).max
    r_lo_cur = torch.full((Q,), -1, dtype=torch.int64, device=dev)
    r_hi_cur = torch.full((Q,), big, dtype=torch.int64, device=dev)
    j = torch.arange(1, k + 1, dtype=torch.int64, device=dev)
    t = targets[:, None]
    for _ in range(rounds):
        pos = l[:, None] + ((h - l)[:, None] * j[None, :]) // (k + 1)
        pos_c = pos.clamp(max=max(nreal - 1, 0))  # (Q, k)
        local = torch.stack([w[pos_c] for w in cmp_words])  # (ncmp, Q, k)
        every = _all_gather(local, group)  # (P, ncmp, Q, k)
        cand = [every[:, i].permute(1, 0, 2).reshape(Q, P_ * k)
                for i in range(len(cmp_words))]
        ins = _searchsorted_words(cmp_words, cand)  # (Q, P*k) local
        ranks = ins.clone()
        dist.all_reduce(ranks, group=group)  # exact global ranks
        rank_lo = torch.where(ranks <= t, ranks, -1)
        rank_hi = torch.where(ranks > t, ranks, big)
        i_lo = torch.argmax(rank_lo, dim=1, keepdim=True)
        i_hi = torch.argmin(rank_hi, dim=1, keepdim=True)
        r_lo = rank_lo.gather(1, i_lo)[:, 0]
        r_hi = rank_hi.gather(1, i_hi)[:, 0]
        better_lo = r_lo > r_lo_cur
        better_hi = r_hi < r_hi_cur
        l = torch.where(better_lo, ins.gather(1, i_lo)[:, 0], l)
        h = torch.where(better_hi, ins.gather(1, i_hi)[:, 0], h)
        r_lo_cur = torch.where(better_lo, r_lo, r_lo_cur)
        r_hi_cur = torch.where(better_hi, r_hi, r_hi_cur)
    return torch.cummax(h.clamp(max=nreal), dim=0).values


# ---------------------------------------------------------------------------
# the rank-local pipeline
# ---------------------------------------------------------------------------


def _fills(nwords: int, ncmp: int) -> list:
    return [SENTINEL if i < ncmp else 0 for i in range(nwords)]


def _chunk(words: list, fills: list, start: int, ln: int,
           size: int) -> torch.Tensor:
    """``(nwords, size)``: ``words[start:start + ln]`` then the fill."""
    out = torch.empty((len(words), size), dtype=torch.int32,
                      device=words[0].device)
    for i, (w, f) in enumerate(zip(words, fills)):
        out[i, :ln] = w[start:start + ln]
        out[i, ln:] = f
    return out


class RunTree:
    """Binary-counter merge tree of sorted sentinel-padded runs: each
    :meth:`push` merges equal-level runs (one merge per run, amortized), so
    runs fold in as they arrive; :meth:`result` merges what is left."""

    def __init__(self, ncmp: int, method: str, tuning=None):
        self.ncmp, self.method, self.tuning = ncmp, method, tuning
        self.levels: dict = {}

    def push(self, run: list) -> None:
        k = 0
        while k in self.levels:
            run = _merge_two_runs(self.levels.pop(k), run, self.ncmp,
                                  self.method, self.tuning)
            k += 1
        self.levels[k] = run

    def result(self) -> list:
        runs = [self.levels[k] for k in sorted(self.levels)]
        acc = runs[0]
        for run in runs[1:]:
            acc = _merge_two_runs(run, acc, self.ncmp, self.method,
                                  self.tuning)
        return acc


def _ring_exchange_merge(words: list, ncmp: int, cuts: list, lens: list,
                         cap: int, me: int, method: str, tuning, group):
    """The main exchange: ``P - 1`` ring rounds, each one send and one
    receive of a ``(nwords * cap + 1,)`` buffer (the run, sentinel-padded to
    ``cap``, and its length); each received run folds into a
    :class:`RunTree`.

    words: the sorted local words (cmp + carry); cuts/lens: (P+1,)/(P,) host
    ints partitioning the real prefix. Returns (merged words, real count).
    """
    P_ = len(lens)
    nw = len(words)
    fills = _fills(nw, ncmp)
    tree = RunTree(ncmp, method, tuning)
    count = min(cuts[me + 1] - cuts[me], cap)
    tree.push(list(_chunk(words, fills, cuts[me], count, cap)))
    for r in range(1, P_):
        q = (me + r) % P_
        sent = _chunk(words, fills, cuts[q], lens[q], cap)
        buf = torch.cat([sent.view(-1), sent.new_tensor([lens[q]])])
        got = _sendrecv(buf, q, (me - r) % P_, group)
        count += int(got[-1])
        tree.push(list(got[:-1].view(nw, cap)))
    return tree.result(), count


def rebalance_merge(kept: list, recv: list, ncmp: int, nrows: int,
                    rowlen: int, method: str, tuning=None) -> list:
    """The rebalance's merge: the sorted kept run with ``nrows`` received
    sentinel-padded boundary pieces of ``rowlen`` (flat in ``recv``). The
    bitonic engine merge-trees the pieces and merges the two runs (1 +
    log2(nrows) stages, not a sort); lexsort sorts them together."""
    if method != "bitonic":
        final = [torch.cat([k, r]) for k, r in zip(kept, recv)] if nrows \
            else kept
        cw, kw = _local_sort_words(final[:ncmp], final[ncmp:], method, tuning)
        return list(cw) + list(kw)
    if not nrows:
        return list(kept)
    tc, tk = _merge_runs_tree(recv[:ncmp], recv[ncmp:], nrows, rowlen,
                              tuning)
    return be._merge_sorted_runs(
        kept, [torch.flip(w, (0,)) for w in list(tc) + list(tk)], ncmp,
        tuning)


def _index_words(g: torch.Tensor, n: int, n_idx: int) -> list:
    """Global positions ``g`` (int32 or int64, this function's to reuse)
    -> the index word(s): the u32 position (``n_idx == 1``, ``n <= 2**32``)
    or the (hi, lo) words of the u64 one (``n_idx == 2``), all-ones where
    ``g >= n`` (pads)."""
    pad = g >= n
    if n_idx == 1:
        w = g if g.dtype == torch.int32 else be.as_word(g)
        return [w.masked_fill_(pad, SENTINEL)]
    g = g.to(torch.int64)
    return [(g >> 32).to(torch.int32).masked_fill_(pad, SENTINEL),
            be.as_word(g & 0xFFFFFFFF).masked_fill_(pad, SENTINEL)]


def _position_dtype(P_: int, B: int) -> torch.dtype:
    """int32 where every global position of the padded layout fits it."""
    return torch.int32 if P_ * B <= 1 << 31 else torch.int64


def _synth_index_words(B: int, P_: int, me: int, n: int, n_idx: int,
                       device) -> list:
    """The index word(s) of rank ``me``'s words after the pre-exchange,
    from the rank and the positions alone (no wire): the pre-exchange is a
    fixed permutation, local position ``p = i*sub + t`` (``sub = B/P``)
    holding what rank ``i`` held at ``t*P + me``, the global position
    ``i*B + t*P + me``. All-ones where that is ``>= n`` (entry pads), as
    the index words built at the entry have it."""
    dt = _position_dtype(P_, B)
    i = torch.arange(P_, dtype=dt, device=device)[:, None]
    t = torch.arange(B // P_, dtype=dt, device=device)
    return _index_words((i * B + t * P_ + me).view(-1), n, n_idx)


def _psort_shard(cmp_words: list, carry_words: list, *, cap: int, cap3: int,
                 method: str, sample_s: int, n_idx: int = 1, synth_n=None,
                 refine=None, tuning=None, group=None, owned: bool = False):
    """The per-rank pipeline on (B,) int32 words in the padded layout (the
    JAX package's ``_psort_shard``).

    The last ``n_idx`` cmp words are the global index (all-ones on entry
    pads), unless ``synth_n`` (the global count n) is given: then the cmp
    words are the key words alone, and the index words are synthesized
    after the pre-exchange (:func:`_synth_index_words`), used by the local
    sort, the splitters, the cuts and the pad count, and dropped before the
    ring exchange. ``owned``: the words are buffers the local sort may
    sweep in place. Returns (cmp_words, carry_words, overflow): exactly B
    sorted elements per rank, rank p holding the global sorted ranks
    [p*B, (p+1)*B), and the overflow flag reduced over the group (a host
    bool); with ``synth_n`` the cmp words are the key words.
    """
    P_ = dist.get_world_size(group)
    me = dist.get_rank(group)
    B = cmp_words[0].shape[0]
    dev = cmp_words[0].device
    ncmp = len(cmp_words)
    words = list(cmp_words) + list(carry_words)
    del cmp_words, carry_words
    nw = len(words)

    # 0. stride pre-exchange with mod-P interleave: local position t*P + j
    # goes to rank j, so rank j holds exactly the global positions ≡ j
    # (mod P) and any position-contiguous mass splits evenly
    if P_ > 1:
        _wire("pre-exchange", nw)
        sub = B // P_
        send = torch.stack(words).view(nw, sub, P_).permute(2, 0, 1)
        got = _all_to_all(send.reshape(P_ * nw, sub), [nw] * P_, [nw] * P_,
                          group)
        del send
        words = list(got.view(P_, nw, sub).permute(1, 0, 2).reshape(nw, B))
        del got
        owned = True

    # 1. local stable sort (with the synthesized index on the keys-only
    # path)
    ncmp_s = ncmp
    if synth_n is not None:
        words[ncmp:ncmp] = _synth_index_words(B, P_, me, synth_n, n_idx, dev)
        ncmp_s = ncmp + n_idx
    cmp_words, carry_words = _local_sort_words(
        words[:ncmp_s], words[ncmp_s:], method, tuning, in_place=owned)
    del words

    # 2. s regular samples per rank, gathered; the replicated lexsort of
    # the P*s samples picks the P-1 splitters
    s = sample_s
    pos = torch.tensor([(i * B) // s for i in range(s)], device=dev)
    every = _all_gather(torch.stack([w[pos] for w in cmp_words]), group)
    samples = [every[:, i].reshape(-1) for i in range(ncmp_s)]  # (P*s,) each
    order = _lexsort_perm(samples)
    sel = order[torch.tensor([q * (P_ * s) // P_ for q in range(1, P_)],
                             dtype=torch.int64, device=dev)]
    splitters = [w[sel] for w in samples]

    # 3. cuts clipped to the real count: entry pads (all-ones index words,
    # the local tail) are never exchanged
    pad = cmp_words[ncmp_s - n_idx] == SENTINEL
    for w in cmp_words[ncmp_s - n_idx + 1:]:
        pad &= w == SENTINEL
    nreal = B - int(pad.sum())
    del pad
    cut = _searchsorted_words(cmp_words, splitters).clamp(max=nreal)
    if refine is not None and refine[0] > 0:
        # targets are the padded quantiles q*B (rank q outputs global ranks
        # [q*B, (q+1)*B) with the entry pads at the global tail)
        rounds, E0, k_ref = refine
        targets = torch.tensor([q * B for q in range(1, P_)],
                               dtype=torch.int64, device=dev)
        cut = _refine_cuts(cmp_words, nreal, cut, E0, rounds, k_ref, targets,
                           group).clamp(max=nreal)
    cuts = [0] + cut.tolist() + [nreal]
    seg = [b - a for a, b in zip(cuts, cuts[1:])]
    overflow = any(x > cap for x in seg)
    # the synthesized index goes no further: the counts below come from
    # lengths and cuts, and ties among equal key words are invisible in
    # keys rebuilt from their bits
    words = list(cmp_words[:ncmp]) + list(carry_words)
    del cmp_words, carry_words, every, samples, splitters

    # 4+5. the ring exchange with its merges
    _wire("ring", nw)
    merged, count = _ring_exchange_merge(
        words, ncmp, cuts, [min(x, cap) for x in seg], cap, me, method,
        tuning, group)
    del words

    # 6. boundary rebalance to exactly B per rank: the piece for myself
    # stays; boundary pieces (the cumulative splitter drift) go to the R
    # ring neighbours on each side, one (cap3,) buffer per word each
    counts = [c[0] for c in _all_gather_ints([count], dev, group)]
    start_me = sum(counts[:me])
    cuts3 = [min(max(q * B - start_me, 0), count) for q in range(P_ + 1)]
    seg3 = [b - a for a, b in zip(cuts3, cuts3[1:])]
    R = min(P_ - 1, 4)
    overflow = overflow or any(
        q != me and ((abs(q - me) > R and seg3[q] > 0) or seg3[q] > cap3)
        for q in range(P_))
    send3 = [0 if q == me else min(seg3[q], cap3) for q in range(P_)]
    fills = _fills(nw, ncmp)
    if R:
        _wire("rebalance", nw)
    pieces = []
    for d in [sgn * r for r in range(1, R + 1) for sgn in (1, -1)]:
        q = me + d  # my piece for rank q rides offset d
        qc = min(max(q, 0), P_ - 1)
        ln = send3[qc] if 0 <= q < P_ else 0
        pieces.append(_sendrecv(_chunk(merged, fills, cuts3[qc], ln, cap3),
                                (me + d) % P_, (me - d) % P_, group))
    recv3 = list(torch.cat(pieces, dim=1)) if pieces else []
    kept = list(_chunk(merged, fills, cuts3[me], cuts3[me + 1] - cuts3[me],
                       B))
    del merged, pieces
    out = rebalance_merge(kept, recv3, ncmp, 2 * R, cap3, method, tuning)
    out = [w[:B] for w in out]
    flag = torch.tensor([int(overflow)], dtype=torch.int64, device=dev)
    dist.all_reduce(flag, group=group)
    return out[:ncmp], out[ncmp:], bool(flag.item() > 0)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def _raise_on_overflow(flag: bool) -> None:
    if flag:
        raise RuntimeError(
            "psort splitter-capacity overflow: a (src,dst) exchange segment "
            "exceeded the static buffer capacity and elements would have "
            "been dropped. Raise slack/oversample, or pass check=True to "
            "receive the flag instead of this error.")


def _consume_overflow(out: list, check: bool) -> tuple:
    """``check=True`` returns the flag last; otherwise an overflow raises
    (on every rank: the flag was reduced over the group)."""
    overflow = out.pop()
    if check:
        return tuple(out) + (overflow,)
    _raise_on_overflow(overflow)
    return tuple(out)


#: replicated-sample budget (tuples): with the automatic oversample, s is
#: capped at _SAMPLE_BUDGET / P, as in the JAX package (its capacity floor
#: follows the actual s, so the cap only ever widens buffers)
_SAMPLE_BUDGET = 1 << 23


@dataclass(frozen=True)
class CapacityPlan:
    """The static sizes of one psort call: ``B`` elements per rank, ``s``
    samples per rank, the exchange capacity ``cap`` per (src, dst) segment,
    the rebalance piece capacity ``cap3``, and the refinement
    ``(rounds, E0, k)`` (``None``: off)."""

    B: int
    s: int
    cap: int
    cap3: int
    refine: tuple | None


def capacity_plan(n: int, P_: int, *, oversample=None, slack=None,
                  refine=True, _unsafe_cap=None) -> CapacityPlan:
    """The JAX package's capacity arithmetic (``_psort_entry``), integer for
    integer, so that both report the same overflow verdict.

    ``n_pad`` is ``n`` rounded up to a multiple of ``P * lcm(P, 8)`` (B must
    divide by P for the stride pre-exchange). The sample splitters' rank
    error is at most ``drift = ceil(B*P/s)``; refinement (on by default for
    P > 1) drives it to ``W_f`` of :func:`refine_plan` and adds a margin of
    ``max(8 sqrt(B/P), B/P/16)`` for the stride-granularity noise. The
    analytic bound ``B/P + 2*drift + margin`` is a floor that ``slack`` only
    raises.
    """
    refine = refine and P_ > 1
    auto_oversample = oversample is None
    if auto_oversample:
        oversample = 32 if refine else max(32, 4 * P_)
    if slack is None:
        slack = 1.0 if refine else 1.5
    quantum = P_ * math.lcm(P_, 8)
    n_pad = -(-max(n, quantum) // quantum) * quantum
    B = n_pad // P_
    s = min(B, oversample * P_)
    if auto_oversample:
        s = min(s, max(P_, _SAMPLE_BUDGET // P_))
    refine_arg = None
    drift = int(math.ceil(B * P_ / s))
    margin = 0
    if refine:
        k_ref = 8
        rounds_ref, W_f = refine_plan(B, P_, s, k_ref)
        if rounds_ref > 0:
            refine_arg = (rounds_ref, drift + 1, k_ref)
            drift = W_f
            margin = max(8 * math.isqrt(B // P_ + 1), (B // P_) // 16)
    bound = B // P_ + 2 * drift + margin
    cap = max(int(math.ceil(slack * B / P_)), bound) + 8
    if _unsafe_cap is not None:
        cap = int(_unsafe_cap)
    # rebalance pieces: the splitter drift on both sides plus the entry-pad
    # deficit (targets are ranks of the padded array, counts are real)
    return CapacityPlan(B=B, s=s, cap=min(cap, B),
                        cap3=min(4 * drift + (n_pad - n) + 16, B),
                        refine=refine_arg)


def index_words(n: int, force_wide: bool = False) -> int:
    """Words of the global index for a global ``n``: a global n >= 2**32
    needs the u64 index, (hi, lo); below it one word rides every sort and
    exchange (``force_wide`` takes the wide index at any n)."""
    return 2 if force_wide or n >= 1 << 32 else 1


def _spans(lengths: list) -> list:
    """(offset, length) of each rank's piece of the global array."""
    out, off = [], 0
    for ln in lengths:
        out.append((off, ln))
        off += ln
    return out


def _overlap(a0: int, a1: int, b0: int, b1: int) -> int:
    return max(0, min(a1, b1) - max(a0, b0))


def _relay_in(words: list, lengths: list, B: int, n: int, ncmp: int,
              me: int, group) -> list:
    """The caller's pieces -> the padded layout: rank q holds global
    positions [q*B, (q+1)*B), pads (fill) past n. One uneven
    ``all_to_all_single`` of the stacked words."""
    if all(x == B for x in lengths):
        return list(words)
    _wire("relay-in", len(words))
    off, ln = _spans(lengths)[me]
    send = [_overlap(off, off + ln, q * B, min((q + 1) * B, n))
            for q in range(len(lengths))]
    recv = [_overlap(o, o + x, me * B, min((me + 1) * B, n))
            for o, x in _spans(lengths)]
    got = _all_to_all(torch.stack(words, dim=1), send, recv, group)
    return list(_chunk(list(got.t()), _fills(len(words), ncmp), 0,
                       got.shape[0], B))


def _relay_out(words: list, lengths: list, B: int, n: int, me: int,
               group) -> list:
    """Inverse of :func:`_relay_in` on the sorted words: rank r gets the
    sorted ranks [off_r, off_r + len_r)."""
    if all(x == B for x in lengths):
        return list(words)
    _wire("relay-out", len(words))
    mine = (me * B, min((me + 1) * B, n))
    send = [_overlap(o, o + x, *mine) for o, x in _spans(lengths)]
    off, ln = _spans(lengths)[me]
    recv = [_overlap(off, off + ln, q * B, min((q + 1) * B, n))
            for q in range(len(lengths))]
    real = max(mine[1] - mine[0], 0)
    rows = torch.stack([w[:real] for w in words], dim=1)
    got = _all_to_all(rows, send, recv, group)
    return [c.contiguous() for c in got.t()]


def _psort_entry(keys, leaves, *, group, descending, method, oversample,
                 slack, want, check, zeros_exact=True, start_bit=0,
                 end_bit=None, refine=True, tuning=None, _unsafe_cap=None,
                 _force_wide=False, donate=False):
    if keys.ndim != 1:
        raise ValueError(f"keys must be 1-D, got shape {tuple(keys.shape)}")
    dev = keys.device
    method = _resolve_local_method(method, dev)
    P_ = dist.get_world_size(group)
    me = dist.get_rank(group)
    for leaf in leaves:
        if leaf.shape[:1] != keys.shape:
            raise ValueError(f"value leading axis {tuple(leaf.shape[:1])} != "
                             f"keys shape {tuple(keys.shape)}")
        if leaf.device != dev:
            raise ValueError(f"value on {leaf.device}, keys on {dev}")
    if donate:
        _check_disjoint([keys] + list(leaves))

    lengths = [x[0] for x in _all_gather_ints([keys.shape[0]], dev, group)]
    n = sum(lengths)
    n_idx = index_words(n, _force_wide)
    plan = capacity_plan(n, P_, oversample=oversample, slack=slack,
                         refine=refine, _unsafe_cap=_unsafe_cap)
    B = plan.B

    bits = keybits.key_bits(keys, descending=descending)
    width = keys.dtype.itemsize * 8
    full_window = (start_bit, end_bit) == (0, width)
    key_cmp = be.bits_to_cmp_words(bits, start_bit, end_bit)
    kind = keybits.dtype_kind(keys.dtype)
    keys_from_bits = full_window and (kind in "iu"
                                      or (kind == "f" and not zeros_exact))
    # keys-only, rebuilt from the bits: the index is needed only locally
    # (stable local sort, tie-broken cuts, pad count), so each rank
    # synthesizes it after the pre-exchange and it never travels
    synth = keys_from_bits and want == ("keys",)
    carry_in = ([keys] if "keys" in want and not keys_from_bits else [])
    carry_in += list(leaves) if "values" in want else []
    carry_words, recipes = be.pack_carries(carry_in)
    nkey = len(key_cmp)
    relayed = any(x != B for x in lengths)

    words = _relay_in(key_cmp + carry_words, lengths, B, n, nkey, me, group)
    del bits, key_cmp, carry_words
    # the global index (unless synthesized): stability tie-break, splitter
    # balance and the indices output in one; all-ones on the pads. It is
    # made in the call, so that the shard holds its only reference and
    # frees it after the local sort. The caller's words may be swept in
    # place only when donated; the relay's are psort's own.
    cmp_out, carry_out, overflow = _psort_shard(
        words[:nkey] + ([] if synth else _index_words(
            torch.arange(me * B, (me + 1) * B, dtype=_position_dtype(P_, B),
                         device=dev), n, n_idx)),
        words[nkey:], cap=plan.cap, cap3=plan.cap3, method=method,
        sample_s=plan.s, n_idx=n_idx, synth_n=n if synth else None,
        refine=plan.refine, tuning=tuning, group=group,
        owned=donate or relayed)
    del words
    # only the words the result needs travel back
    need = cmp_out[:nkey] if "keys" in want and keys_from_bits else []
    need += cmp_out[len(cmp_out) - n_idx:] if "indices" in want else []
    out = _relay_out(need + carry_out, lengths, B, n, me, group)
    del cmp_out, carry_out, need

    result = []
    if "keys" in want and keys_from_bits:
        kw, out = out[:nkey], out[nkey:]
        sbits = kw[0] if nkey == 1 else be.join_u64(kw[0], kw[1])
        keys_out = keybits.key_bits_inverse(sbits, keys.dtype,
                                            descending=descending)
    if "indices" in want:
        iw, out = out[:n_idx], out[n_idx:]
    carried = be.unpack_carries(out, recipes)
    if "keys" in want:
        k = keys_out if keys_from_bits else carried.pop(0)
        result.append(_write_back(keys, k) if donate else k)
    if "values" in want:
        result.append([_write_back(d, r) for d, r in zip(leaves, carried)]
                      if donate else carried)
    if "indices" in want:
        if n_idx == 2:
            result.append(be.join_u64(iw[0], iw[1]))
        else:
            # below 2**31 the index word holds the index itself
            result.append(iw[0] if n < 2**31 else be.unsigned(iw[0]))
    result.append(overflow)
    return result


def _prep(keys, order, start_bit, end_bit, donate):
    if donate:
        _check_donated(keys, "keys")
    keys = _as_input(keys, "keys")
    descending = SortOrder.parse(order).descending
    start_bit, end_bit = common.resolve_window(keys.dtype, start_bit, end_bit)
    return keys, dict(descending=descending, start_bit=start_bit,
                      end_bit=end_bit, tuning=be.EngineTuning.from_env(),
                      donate=donate)


def psort_keys(keys, *, group=None, order="ascending", method="auto",
               start_bit=0, end_bit=None, oversample=None, slack=None,
               check=False, zeros_exact=True, donate=False, refine=True,
               _unsafe_cap=None, _force_wide=False):
    """This rank's share of the globally sorted keys: the sorted ranks
    ``[off, off + len)`` of the concatenation of every rank's ``keys``, where
    this rank's piece sits at ``off`` and has ``len`` elements.

    Call on every rank of ``group`` (``None``: the default group), with 1-D
    keys on this rank's device. ``method``: the local sorts' and merges'
    engine, ``"bitonic"``, ``"lexsort"`` or ``"auto"`` (the bitonic engine on
    CUDA, lexsort elsewhere). ``check=True`` also returns the overflow flag
    (True: a splitter segment exceeded the static capacity and elements were
    dropped; raise ``slack``/``oversample``); otherwise an overflow raises
    ``RuntimeError`` on every rank. ``start_bit``/``end_bit`` and
    ``zeros_exact`` have :func:`..sort.sort_keys` semantics
    (``zeros_exact=False`` lets float keys come back from their bits, so
    the index stays off the wire, as for integer keys). ``donate=True``
    writes the result into ``keys`` (contiguous) and returns it.
    ``_force_wide=True`` takes the two-word index of a global n >= 2**32
    at any n.
    """
    keys, kw = _prep(keys, order, start_bit, end_bit, donate)
    out = _psort_entry(keys, [], group=group, method=method,
                       oversample=oversample, slack=slack, want=("keys",),
                       check=check, zeros_exact=zeros_exact, refine=refine,
                       _unsafe_cap=_unsafe_cap, _force_wide=_force_wide, **kw)
    out = _consume_overflow(out, check)
    return out if check else out[0]


def psort_pairs(keys, values, *, group=None, order="ascending",
                method="auto", start_bit=0, end_bit=None, oversample=None,
                slack=None, check=False, zeros_exact=True, donate=False,
                refine=True, _force_wide=False):
    """Distributed stable key-value sort: ``(keys, values)`` of this rank's
    share; ``values`` is a tensor or a (nested) dict, list or tuple of
    tensors whose leading axis matches this rank's keys. ``donate=True``
    writes the result into ``keys`` and the value leaves (contiguous
    tensors that share no memory) and returns them in ``values``'
    structure. Other arguments as in :func:`psort_keys`."""
    keys, kw = _prep(keys, order, start_bit, end_bit, donate)
    leaves, rebuild = _flatten(values, donate)
    out = _psort_entry(keys, leaves, group=group, method=method,
                       oversample=oversample, slack=slack,
                       want=("keys", "values"), check=check,
                       zeros_exact=zeros_exact, refine=refine,
                       _force_wide=_force_wide, **kw)
    out = _consume_overflow(out, check)
    k, v = out[0], rebuild(iter(out[1]))
    return (k, v, out[2]) if check else (k, v)


def psort_indices(keys, *, group=None, order="ascending", method="auto",
                  start_bit=0, end_bit=None, oversample=None, slack=None,
                  check=False, donate=False, refine=True, _force_wide=False):
    """This rank's share of the global stable sorting permutation (global
    indices into the concatenated keys; int32 for a global n < 2**31, int64
    from there on and with ``_force_wide=True``). ``donate=True`` lets the
    sort use the keys as scratch: their content afterwards is unspecified.
    Other arguments as in :func:`psort_keys`."""
    keys, kw = _prep(keys, order, start_bit, end_bit, donate)
    out = _psort_entry(keys, [], group=group, method=method,
                       oversample=oversample, slack=slack,
                       want=("indices",), check=check, refine=refine,
                       _force_wide=_force_wide, **kw)
    out = _consume_overflow(out, check)
    return out if check else out[0]
