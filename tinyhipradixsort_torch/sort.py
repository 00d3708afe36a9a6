"""Public sort API (PyTorch port of ``tinyhipradixsort_tpu/sort.py``).

Equivalents of the reference host API (reference: tinyhipradixsort.hpp:845-852
``sortKeys``/``sortPairs``), on torch tensors. Work runs on the device the
keys live on: CUDA tensors go through the hand-written Hopper kernels, CPU
tensors through their plain PyTorch versions. Inputs that are not torch
tensors (numpy arrays, lists) go to the CUDA device; without one they raise,
since a CPU run is asked for by passing a CPU tensor.

* :func:`sort_keys`    — stable radix-semantics sort of a key tensor.
* :func:`sort_pairs`   — stable key-value sort; values are a tensor or a
  (nested) dict, list or tuple of tensors whose leading axes match the keys.
* :func:`sort_indices` — the stable sorting permutation.
* :func:`segment_ids_from_offsets` — CUB-style offsets to ``segment_ids``.
* :class:`RadixSort`   — config-holding wrapper for reference-API parity.

Semantics (identical to the reference and to the JAX package): stable;
sorts by the key-bit transform of :mod:`.keybits` while original key values
(``-0.0``, NaN payloads) come back bit-exactly; ``start_bit``/``end_bit``
select any bit window of the transformed bits; descending order is the
bitwise complement of the transform, still stable.

Engines (``method=``): ``"bitonic"`` runs the bitonic network
(``csrc/bitonic_sweep.cu``). It takes every key dtype (u32, i32, f32, u64,
i64, f64 and the 16-bit u16, i16, f16, bf16), 1-D keys of any length (a
non-power-of-two n sorts as power-of-two segments joined by truncated
merges), 2-D keys (each row sorted on its own by a row-truncated network),
``segment_ids=`` (the segment bits lead the compare tuple) and
``stable=False`` (the index word is dropped where no padding is needed).
The portable engines ``"counting"`` (the reference's histogram, scan and
scatter pass; its histogram is ``csrc/digit_histogram.cu``), ``"argsort"``
and ``"lsd_argsort"`` (``torch.sort``) take the same inputs and are always
stable. ``"auto"`` follows the keys' device, as the JAX package follows
the platform, and on CUDA tensors what the call shows: the counting engine
for 1-D keys of at least ``AUTO_COUNTING_MIN_N`` with no ``segment_ids``
and no ``donate``, the bitonic engine for every other CUDA call (2-D rows,
smaller n, segmented or donated sorts); ``"argsort"`` elsewhere. A caller
who tunes the network (``THRS_*``) names ``method="bitonic"``. Both CUDA engines are stable and keep ``-0.0``,
so the route changes no output that the default ``stable=True`` and
``zeros_exact=True`` fix.

While :mod:`.tracing` records, each call of :func:`sort_keys`,
:func:`sort_pairs` and :func:`sort_indices` is one span of that name, the
root of a new call (validation, key bits, the network engine's word
packing and unpacking, and the write-back are its own time), unless a
span is already open, whose child it then is. An ``"auto"`` call also
records the instant ``sort.auto`` (``engine``, ``n``) and counts
``auto.counting`` or ``auto.network`` (``auto.argsort`` off CUDA).

``donate=True`` is the reference's rule that the result replaces the input
(tinyhipradixsort.hpp:936-943; the JAX package donates the buffers): the
result is written into the caller's keys and value leaves, and those same
tensors are returned. The keys (for ``sort_indices``, scratch) and leaves
must be contiguous tensors on one device that share no memory; nothing is
copied behind the caller's back to make them so. Where the bitonic route
needs no padding it sweeps the caller's storage in place, so the sort's
peak memory drops (u32 keys at a power-of-two n: no second buffer).
"""

from __future__ import annotations

import torch

from . import keybits, tracing
from .config import Config, SortOrder
from .ops import argsort_engine, common, counting_engine, network_engine

__all__ = ["sort_keys", "sort_pairs", "sort_indices", "RadixSort",
           "segment_ids_from_offsets"]

_ENGINES = ("auto", "bitonic", "counting", "argsort", "lsd_argsort")
_PORTABLE = {
    "argsort": argsort_engine.sort_arrays_argsort,
    "lsd_argsort": argsort_engine.sort_arrays_lsd_argsort,
    "counting": counting_engine.sort_arrays_counting,
}
#: portable engines that can hand back their sorted bits (``with_bits=``),
#: so the keys are rebuilt from them instead of carried through the passes
_FROM_BITS = frozenset({"counting"})
_INT_DTYPES = (torch.int8, torch.uint8, torch.int16, torch.uint16,
               torch.int32, torch.uint32, torch.int64, torch.uint64)


#: the smallest 1-D length that ``"auto"`` sorts on the counting engine on a
#: CUDA tensor: the smallest measured power of two from which counting beat
#: the bitonic network at every measured size and key width on an H100
#: (PERF.md §6, the crossover table; ``chip_smoke.crossover`` measures it)
AUTO_COUNTING_MIN_N = 1 << 24


def _resolve_method(method: str, keys: torch.Tensor, *,
                    segmented: bool = False, donate: bool = False) -> str:
    """The engine a call on ``keys`` runs. ``"auto"`` follows the keys'
    device, as the JAX package follows the platform (its Pallas engine on
    the TPU, argsort off it): ``"argsort"`` off CUDA; on CUDA the counting
    engine for 1-D keys of at least ``AUTO_COUNTING_MIN_N`` with no
    ``segment_ids`` and no ``donate``, the bitonic network otherwise: 2-D
    rows, small n, segmented and donated calls."""
    if method not in _ENGINES:
        raise ValueError(f"unknown method {method!r}; expected one of {_ENGINES}")
    if method != "auto":
        return method
    if keys.device.type != "cuda":
        return "argsort"
    if (keys.ndim == 1 and keys.numel() >= AUTO_COUNTING_MIN_N
            and not segmented and not donate):
        return "counting"
    return "bitonic"


def _as_input(x, what: str) -> torch.Tensor:
    """A torch tensor keeps its device (a CPU tensor asks for the CPU);
    anything else (numpy array, list) goes to the CUDA device."""
    if isinstance(x, torch.Tensor):
        return x
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} is not a torch tensor, so it would go to the CUDA "
            "device, and there is none; pass a CPU tensor to sort on the CPU")
    return torch.as_tensor(x, device="cuda")


def segment_ids_from_offsets(offsets, n: int) -> torch.Tensor:
    """CUB-style segment description -> ``segment_ids`` tensor.

    ``offsets``: non-decreasing segment start offsets (1-D integers, with or
    without the leading 0 / trailing ``n``). Returns int32 of length ``n``
    where element ``i`` holds the index of the segment containing ``i``,
    with empty *leading* segments collapsed to index 0 (the labeling groups
    exactly like cub::DeviceSegmentedRadixSort's ``d_begin_offsets``).
    """
    offsets = _as_input(offsets, "offsets")
    if offsets.ndim != 1:
        raise ValueError(f"offsets must be 1-D, got shape {tuple(offsets.shape)}")
    offsets = offsets.to(torch.int64)
    pos = torch.arange(n, dtype=torch.int64, device=offsets.device)
    ids = torch.searchsorted(offsets, pos, right=True)
    # boundaries at or before position 0 (an explicit leading 0) shift every
    # id; remove them so element 0 always gets id 0
    zero = torch.zeros(1, dtype=torch.int64, device=offsets.device)
    ids = ids - torch.searchsorted(offsets, zero, right=True)
    return ids.to(torch.int32)


def _flatten(tree, donate: bool = False):
    """Tensor leaves of a tensor or a (nested) dict/list/tuple of them, and
    a function that rebuilds the structure from an iterator of new leaves.
    A donated leaf must already be a tensor."""
    if isinstance(tree, dict):
        parts = {k: _flatten(v, donate) for k, v in tree.items()}
        leaves = [leaf for ls, _ in parts.values() for leaf in ls]
        return leaves, lambda it: {k: rb(it) for k, (_, rb) in parts.items()}
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v, donate) for v in tree]
        leaves = [leaf for ls, _ in parts for leaf in ls]
        kind = list if isinstance(tree, list) else tuple
        return leaves, lambda it: kind(rb(it) for _, rb in parts)
    if donate:
        _check_donated(tree, "values")
    return [_as_input(tree, "values")], next


def _check_donated(x, what: str) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"donate=True needs {what} as torch tensors, got "
                        f"{type(x).__name__}")
    if not x.is_contiguous():
        raise ValueError(f"donate=True needs contiguous {what}; a "
                         "non-contiguous tensor would be copied")


def _check_disjoint(tensors: list) -> None:
    """Donated tensors must not share memory: the sort writes into each."""
    seen = set()
    for t in tensors:
        if t.numel() == 0:
            continue
        ptr = (t.device, t.untyped_storage().data_ptr())
        if ptr in seen:
            raise ValueError("donate=True needs keys and value leaves that "
                             "share no memory")
        seen.add(ptr)


def _write_back(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Put a donated call's result ``src`` into the caller's ``dst``; a
    result that the sort already wrote into ``dst`` in place stays."""
    if src.data_ptr() != dst.data_ptr() or src.shape != dst.shape:
        dst.copy_(src)
    return dst


def _sort_portable(keys, leaves, *, method, descending, start_bit, end_bit,
                   want, seg):
    """The portable engines' branch of the JAX ``_sort_entry``: outputs in
    the order of ``want``, values as a flat list of leaves."""
    engine = _PORTABLE[method]
    bits = keybits.key_bits(keys, descending=descending)
    # an engine of _FROM_BITS hands back its sorted bits and the keys are
    # rebuilt from them, so a pass moves each key's bytes once; float keys
    # carry a 1-byte -0.0 flag, since the bits normalise -0.0 to +0.0; the
    # other engines carry the keys themselves
    from_bits = "keys" in want and method in _FROM_BITS
    float_flag = from_bits and keys.dtype.is_floating_point
    arrays = []
    if float_flag:
        arrays.append(keybits.neg_zero_flag(keys, torch.bool))
    elif "keys" in want and not from_bits:
        arrays.append(keys)
    arrays += leaves
    if "indices" in want:
        n = keys.shape[-1]
        idx_dt = torch.int32 if n < 2**31 else torch.int64
        arrays.append(torch.arange(n, dtype=idx_dt, device=keys.device)
                      .expand(keys.shape))
    kw = {"with_bits": True} if from_bits else {}
    if seg is None:
        out = engine(bits, arrays, start_bit, end_bit, **kw)
    else:
        # segmented: two stable passes (LSD composition), by the key bits,
        # then by the segment bits, which the first carries in front; the
        # key bits it sorts come last and ride through the second
        seg_bits = keybits.key_bits(seg)
        out = engine(bits, [seg_bits] + arrays, start_bit, end_bit, **kw)
        out = engine(out[0], out[1:], 0, seg_bits.dtype.itemsize * 8)

    result = []
    pos = 0
    if from_bits:
        raw = keybits.key_bits_inverse_raw(out.pop(), keys.dtype,
                                           descending=descending)
        if float_flag:
            sign = -(1 << (keys.dtype.itemsize * 8 - 1))
            raw = torch.where(out[0], raw | sign, raw)
            pos = 1
        result.append(keybits.raw_to_keys(raw, keys.dtype))
    elif "keys" in want:
        result.append(out[0])
        pos = 1
    if "values" in want:
        result.append(out[pos:pos + len(leaves)])
        pos += len(leaves)
    if "indices" in want:
        result.append(out[pos])
    return result


def _sort_entry(keys, values, *, method, descending, start_bit, end_bit,
                want, zeros_exact=True, seg=None, stable=True, donate=False):
    """want: subset of ('keys', 'values', 'indices') controlling outputs.
    ``donate``: write the keys and values into the caller's tensors (see
    the module docstring)."""
    leaves, rebuild = [], None
    if "values" in want:
        leaves, rebuild = _flatten(values, donate)
        for leaf in leaves:
            if leaf.shape[: keys.ndim] != keys.shape:
                raise ValueError(
                    f"value leading axes {tuple(leaf.shape[: keys.ndim])} != "
                    f"keys shape {tuple(keys.shape)}")
            if leaf.device != keys.device:
                raise ValueError(
                    f"value on {leaf.device}, keys on {keys.device}")
    if donate:
        _check_disjoint([keys] + leaves)
    if method == "bitonic":
        seg_bits = None if seg is None else keybits.key_bits(seg)
        if donate and seg is not None and seg_bits.data_ptr() == seg.data_ptr():
            seg_bits = seg_bits.clone()  # the segment ids are not donated
        out = list(network_engine.sort_semantics(
            keys, leaves, descending=descending, start_bit=start_bit,
            end_bit=end_bit, want=want, zeros_exact=zeros_exact,
            seg_bits=seg_bits, stable=stable, in_place=donate))
    else:
        out = _sort_portable(keys, leaves, method=method,
                             descending=descending, start_bit=start_bit,
                             end_bit=end_bit, want=want, seg=seg)
    if donate and "keys" in want:
        out[0] = _write_back(keys, out[0])
    if "values" in want:
        pos = want.index("values")
        if donate:
            out[pos] = [_write_back(d, r) for d, r in zip(leaves, out[pos])]
        out[pos] = rebuild(iter(out[pos]))
    return tuple(out)


def _prep_segments(segment_ids, keys):
    """Validate ``segment_ids`` and widen them to a key-bits dtype."""
    if segment_ids is None:
        return None
    seg = _as_input(segment_ids, "segment_ids")
    if seg.shape != keys.shape:
        raise ValueError(f"segment_ids shape {tuple(seg.shape)} != keys "
                         f"shape {tuple(keys.shape)}")
    if seg.dtype not in _INT_DTYPES:
        raise TypeError(f"segment_ids must be integers, got {seg.dtype}")
    if seg.device != keys.device:
        raise ValueError(f"segment_ids on {seg.device}, keys on {keys.device}")
    if seg.dtype.itemsize < 4:
        seg = seg.to(torch.int32)
    return seg


def _prep(keys, order, start_bit, end_bit, method, segment_ids,
          donate=False):
    if donate:
        _check_donated(keys, "keys")
    keys = _as_input(keys, "keys")
    engine = _resolve_method(method, keys, segmented=segment_ids is not None,
                             donate=donate)
    if method == "auto" and tracing.on():
        tracing.event("sort.auto", engine=engine, n=keys.numel())
        tracing.count("auto.network" if engine == "bitonic"
                      else f"auto.{engine}")
    if keys.ndim not in (1, 2):
        raise ValueError(
            "keys must be 1-D (single sort) or 2-D (batched row-wise sorts), "
            f"got shape {tuple(keys.shape)}")
    descending = SortOrder.parse(order).descending
    start_bit, end_bit = common.resolve_window(keys.dtype, start_bit, end_bit)
    seg = _prep_segments(segment_ids, keys)
    return keys, dict(method=engine, descending=descending,
                      start_bit=start_bit, end_bit=end_bit, seg=seg,
                      donate=donate)


def sort_keys(keys, *, order="ascending", start_bit=0, end_bit=None,
              method="auto", zeros_exact=True, segment_ids=None,
              donate=False):
    """Stable radix-semantics sort of ``keys``; returns the sorted tensor.

    Reference parity: ``RadixSort::sortKeys`` (hpp:845-848). The input is
    not modified, unless ``donate=True``: then the sorted keys are written
    into it and it is returned (see the module docstring).

    2-D ``keys`` are a batch: each row sorts on its own (on the bitonic
    engine a network truncated to one row's stages, ``B`` times one row's
    work). ``segment_ids`` (keys-shaped integers) selects a segmented sort:
    elements order by ``(segment_id, key)``, stable; segment ids always
    order ascending, ``order`` applies to keys within a segment.

    ``zeros_exact=False`` is a float-keys fast path of the bitonic engine
    (1 sorted word instead of bits + tagged stability index): every ``-0.0``
    comes back as ``+0.0``. Ignored for integer keys and by the portable
    engines, which are always exact.
    """
    with tracing.span("sort_keys"):
        keys, kw = _prep(keys, order, start_bit, end_bit, method,
                         segment_ids, donate)
        (out,) = _sort_entry(keys, None, want=("keys",),
                             zeros_exact=zeros_exact, **kw)
    return out


def sort_pairs(keys, values, *, order="ascending", start_bit=0, end_bit=None,
               method="auto", segment_ids=None, donate=False, stable=True,
               zeros_exact=True):
    """Stable key-value sort; returns ``(sorted_keys, reordered_values)``.

    ``values`` is a tensor or a (nested) dict, list or tuple of tensors
    whose leading axes match the keys (reference: ``sortPairs``,
    hpp:849-852; u128 payloads are ``(n, 4)`` 32-bit tensors). 2-D keys sort
    each row; value leaves then share the leading ``(B, n)`` axes.

    ``stable=False`` permits, and does not require, any order among equal
    keys: the bitonic engine drops the stability index word where the sort
    needs no padding (a power-of-two row length; a flat n also >= 1024),
    so u32+u32 pairs move 2 words instead of 3 and u64+u64 4 instead of 5.
    Other sizes and the portable engines stay stable. Float keys keep the
    word (it holds the ``-0.0`` tag) unless ``zeros_exact=False`` too.
    ``donate=True`` writes the result into the caller's keys and value
    leaves and returns them, in ``values``' structure. ``zeros_exact`` and
    ``segment_ids`` have :func:`sort_keys` semantics.
    """
    with tracing.span("sort_pairs"):
        keys, kw = _prep(keys, order, start_bit, end_bit, method,
                         segment_ids, donate)
        return _sort_entry(keys, values, want=("keys", "values"),
                           zeros_exact=zeros_exact, stable=stable, **kw)


def sort_indices(keys, *, order="ascending", start_bit=0, end_bit=None,
                 method="auto", segment_ids=None, donate=False):
    """The stable sorting permutation: ``keys[perm]`` is sorted (2-D keys:
    the per-row permutation). int32 for n < 2**31, else int64.
    ``donate=True`` lets the sort use the keys as scratch: their content
    afterwards is unspecified."""
    with tracing.span("sort_indices"):
        keys, kw = _prep(keys, order, start_bit, end_bit, method,
                         segment_ids, donate)
        (perm,) = _sort_entry(keys, None, want=("indices",), **kw)
    return perm


class RadixSort:
    """Config-holding wrapper mirroring ``thrs::RadixSort`` (hpp:694-948).
    Construction is free: a kernel builds at the first CUDA sort that
    needs it."""

    def __init__(self, config: Config | None = None, method: str = "auto"):
        self.config = config or Config()
        self.method = method

    def _kw(self, start_bit, end_bit):
        return dict(order=self.config.order, start_bit=start_bit,
                    end_bit=end_bit, method=self.method)

    def _check(self, keys):
        keys = _as_input(keys, "keys")
        if keys.dtype != self.config.key_type.dtype:
            raise TypeError(
                f"keys dtype {keys.dtype} != configured "
                f"{self.config.key_type.dtype}")
        return keys

    def sort_keys(self, keys, start_bit: int = 0, end_bit: int | None = None):
        return sort_keys(self._check(keys), **self._kw(start_bit, end_bit))

    def sort_pairs(self, keys, values, start_bit: int = 0,
                   end_bit: int | None = None):
        return sort_pairs(self._check(keys), values,
                          **self._kw(start_bit, end_bit))

    def temporary_buffer_bytes(self, n: int) -> int:
        from .config import temporary_buffer_bytes

        return temporary_buffer_bytes(n, self.config)
