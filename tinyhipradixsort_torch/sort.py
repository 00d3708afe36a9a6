"""Public sort API (PyTorch port of ``tinyhipradixsort_tpu/sort.py``).

Equivalents of the reference host API (reference: tinyhipradixsort.hpp:845-852
``sortKeys``/``sortPairs``), on torch tensors. Work runs on the device the
keys live on: CUDA tensors go through the hand-written Hopper kernel, CPU
tensors through its plain PyTorch version.

* :func:`sort_keys`    — stable radix-semantics sort of a key tensor.
* :func:`sort_pairs`   — stable key-value sort; values are a tensor or a
  (nested) dict, list or tuple of tensors whose leading axis matches the keys.
* :func:`sort_indices` — the stable sorting permutation.
* :class:`RadixSort`   — config-holding wrapper for reference-API parity.

Semantics (identical to the reference and to the JAX package): stable;
sorts by the key-bit transform of :mod:`.keybits` while original key values
(``-0.0``, NaN payloads) come back bit-exactly; ``start_bit``/``end_bit``
select any bit window of the transformed bits; descending order is the
bitwise complement of the transform, still stable.

This slice covers 1-D keys of u32, i32, f32, u64, i64 and f64. These raise
``NotImplementedError`` until their slices are ported: 2-D (batched) keys,
``segment_ids=``, 16-bit keys, and the portable engines (``"argsort"``,
``"lsd_argsort"``, ``"counting"``).
"""

from __future__ import annotations

import torch

from . import keybits
from .config import Config, SortOrder
from .ops import common, network_engine
from .ops.bitonic_engine import EngineTuning

__all__ = ["sort_keys", "sort_pairs", "sort_indices", "RadixSort"]

_ENGINES = ("auto", "bitonic", "counting", "argsort", "lsd_argsort")


def _resolve_method(method: str) -> str:
    """``"auto"`` and ``"bitonic"`` resolve to the bitonic engine."""
    if method not in _ENGINES:
        raise ValueError(f"unknown method {method!r}; expected one of {_ENGINES}")
    if method not in ("auto", "bitonic"):
        raise NotImplementedError(
            f"the {method!r} engine is not ported yet (portable engines: "
            "ROADMAP queue 1, item 6); use 'bitonic'")
    return "bitonic"


def _flatten(tree):
    """Tensor leaves of a tensor or a (nested) dict/list/tuple of them, and
    a function that rebuilds the structure from an iterator of new leaves."""
    if isinstance(tree, dict):
        parts = {k: _flatten(v) for k, v in tree.items()}
        leaves = [leaf for ls, _ in parts.values() for leaf in ls]
        return leaves, lambda it: {k: rb(it) for k, (_, rb) in parts.items()}
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v) for v in tree]
        leaves = [leaf for ls, _ in parts for leaf in ls]
        kind = list if isinstance(tree, list) else tuple
        return leaves, lambda it: kind(rb(it) for _, rb in parts)
    return [torch.as_tensor(tree)], next


def _sort_entry(keys, values, *, descending, start_bit, end_bit, want,
                zeros_exact=True, tuning=None):
    """want: subset of ('keys', 'values', 'indices') controlling outputs."""
    leaves, rebuild = [], None
    if "values" in want:
        leaves, rebuild = _flatten(values)
        for leaf in leaves:
            if leaf.shape[: keys.ndim] != keys.shape:
                raise ValueError(
                    f"value leading axes {tuple(leaf.shape[: keys.ndim])} != "
                    f"keys shape {tuple(keys.shape)}")
            if leaf.device != keys.device:
                raise ValueError(
                    f"value on {leaf.device}, keys on {keys.device}")
    out = list(network_engine.sort_semantics(
        keys, leaves, descending=descending, start_bit=start_bit,
        end_bit=end_bit, want=want, zeros_exact=zeros_exact, tuning=tuning))
    if "values" in want:
        pos = want.index("values")
        out[pos] = rebuild(iter(out[pos]))
    return tuple(out)


def _prep(keys, order, start_bit, end_bit, method, segment_ids):
    _resolve_method(method)
    keys = torch.as_tensor(keys)
    if segment_ids is not None:
        raise NotImplementedError(
            "segment_ids= is not ported yet (ROADMAP queue 1, item 5)")
    if keys.ndim == 2:
        raise NotImplementedError(
            "batched 2-D keys are not ported yet (row sorts: ROADMAP queue 1, "
            "item 5)")
    if keys.ndim != 1:
        raise ValueError(f"keys must be 1-D, got shape {tuple(keys.shape)}")
    if keybits.bit_width(keys.dtype) == 16:
        raise NotImplementedError(
            f"{keys.dtype} keys are not ported yet (16-bit keys: ROADMAP "
            "queue 1, item 1)")
    descending = SortOrder.parse(order).descending
    start_bit, end_bit = common.resolve_window(keys.dtype, start_bit, end_bit)
    return keys, descending, start_bit, end_bit


def sort_keys(keys, *, order="ascending", start_bit=0, end_bit=None,
              method="auto", zeros_exact=True, segment_ids=None,
              donate=False):
    """Stable radix-semantics sort of ``keys``; returns the sorted tensor.

    Reference parity: ``RadixSort::sortKeys`` (hpp:845-848). The input is
    never modified. ``donate=True`` is accepted and has no effect yet.

    ``zeros_exact=False`` is a float-keys fast path (1 sorted word instead
    of bits + tagged stability index): every ``-0.0`` comes back as
    ``+0.0``. Ignored for integer keys.
    """
    keys, descending, start_bit, end_bit = _prep(
        keys, order, start_bit, end_bit, method, segment_ids)
    (out,) = _sort_entry(
        keys, None, descending=descending, start_bit=start_bit,
        end_bit=end_bit, want=("keys",),
        zeros_exact=zeros_exact, tuning=EngineTuning.from_env())
    return out


def sort_pairs(keys, values, *, order="ascending", start_bit=0, end_bit=None,
               method="auto", segment_ids=None, donate=False, stable=True,
               zeros_exact=True):
    """Stable key-value sort; returns ``(sorted_keys, reordered_values)``.

    ``values`` is a tensor or a (nested) dict, list or tuple of tensors
    whose leading axis matches the keys (reference: ``sortPairs``,
    hpp:849-852; u128 payloads are ``(n, 4)`` 32-bit tensors).

    ``stable=False`` permits, and does not require, any order among equal
    keys (the JAX contract, ``tinyhipradixsort_tpu/sort.py``); in this port
    the sort stays stable. ``donate=True`` is accepted and has no effect
    yet. ``zeros_exact`` has :func:`sort_keys` semantics.
    """
    keys, descending, start_bit, end_bit = _prep(
        keys, order, start_bit, end_bit, method, segment_ids)
    return _sort_entry(
        keys, values, descending=descending, start_bit=start_bit,
        end_bit=end_bit, want=("keys", "values"), zeros_exact=zeros_exact,
        tuning=EngineTuning.from_env())


def sort_indices(keys, *, order="ascending", start_bit=0, end_bit=None,
                 method="auto", segment_ids=None, donate=False):
    """The stable sorting permutation: ``keys[perm]`` is sorted. int32 for
    n < 2**31, else int64. ``donate=True`` is accepted and has no effect
    yet."""
    keys, descending, start_bit, end_bit = _prep(
        keys, order, start_bit, end_bit, method, segment_ids)
    (perm,) = _sort_entry(
        keys, None, descending=descending, start_bit=start_bit,
        end_bit=end_bit, want=("indices",),
        tuning=EngineTuning.from_env())
    return perm


class RadixSort:
    """Config-holding wrapper mirroring ``thrs::RadixSort`` (hpp:694-948).
    Construction is free: the kernel builds at the first CUDA sort."""

    def __init__(self, config: Config | None = None, method: str = "auto"):
        self.config = config or Config()
        self.method = method

    def _kw(self, start_bit, end_bit):
        return dict(order=self.config.order, start_bit=start_bit,
                    end_bit=end_bit, method=self.method)

    def _check(self, keys):
        keys = torch.as_tensor(keys)
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
