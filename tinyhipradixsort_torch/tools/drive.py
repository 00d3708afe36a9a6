"""End-to-end drive of the PyTorch port on the card, against numpy oracles
(the JAX repo's ``tools/drive_tpu.py``, and with ``--iters`` the
reference-density sweep of its ``tests/test_full_matrix.py``).

Check groups: keys of five dtypes (u32, i32, f32 with NaN, +-Inf, -0.0 and
denormals, u64, i64), both orders, n in {1, 2, 1000, 100003}; pairs
stability, ascending and descending; u64 bit windows at start bits 0, 8,
24 and 56; all zeros with two sentinels; ``sort_indices``; u128 payloads as
``(n, 4)`` u32; 16-bit keys (u16, i16, and f16/bf16 with every bit pattern,
which sort directly on the card: the JAX drive's host-adapter detour was
for the TPU); batched rows and pairs; the segmented sort; the error paths.

``--iters K`` adds the reference density (unittest.cpp's TEST_ITERATION
random sizes in [1, 100000)): K sizes per (dtype x order) for keys of six
dtypes, K/2 per key/value pair of the pairs matrix and random u64 windows,
and K/2 per (dtype x order) of the ``np_key_bits`` adapter cases (f64, f16,
bf16 keys sorted as their integer bits, keys and pairs); each case's sizes
come from ``zlib.crc32`` of its name, as in the JAX tier.

The oracles are the port's ``keybits.np_key_bits`` and numpy's stable
argsort, kept in this module (nothing here imports from ``tests``). Floats
compare by their bit patterns. One line per failure, then a summary; the
exit code is the number of failures (at most 255).

    python -m tinyhipradixsort_torch.tools.drive [--iters K] [--method auto]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import zlib

import numpy as np
import torch

import tinyhipradixsort_torch as thrs
from tinyhipradixsort_torch import sort as sort_mod
from tinyhipradixsort_torch.keybits import np_key_bits, np_key_bits_inverse
from tinyhipradixsort_torch.tools import device, host_bits, to_device

MAX_N = 100_000  # reference TEST_MAX_ARRAY_SIZE

#: sizes of the fixed checks (the JAX drive's); :func:`sizes` caps them
SIZES = {"keys": 100003, "pairs": 200001, "window": 50000,
         "extreme": 100000, "indices": 65537, "u128": 30000, "b16": 100000,
         "rows": 5000, "seg": 100000}


def sizes(cap: int | None = None) -> dict:
    """The fixed checks' sizes, each at most ``cap``."""
    return {k: v if cap is None else min(v, cap) for k, v in SIZES.items()}


def _unsigned(a: np.ndarray) -> np.ndarray:
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[a.dtype.itemsize])


def oracle_perm(x: np.ndarray, descending: bool = False, start: int = 0,
                end: int | None = None) -> np.ndarray:
    """numpy's stable order of the keys' transformed bits (a window of
    them with ``start``/``end``)."""
    bits = np_key_bits(x, descending=descending)
    nb = x.dtype.itemsize * 8
    end = nb if end is None else end
    if (start, end) != (0, nb):
        u = bits.dtype.type
        bits = (bits >> u(start)) & u((1 << (end - start)) - 1)
    return np.argsort(bits, kind="stable")


def _rand_keys(rng, dtype, n: int, specials: bool) -> np.ndarray:
    """The JAX drive's keys (``specials``: NaN, +-Inf, -0.0, denormals in
    f32) or the reference-density tier's (floats x100 with +-0.0)."""
    dt = np.dtype(dtype)
    if dt.kind != "f":
        info = np.iinfo(dt)
        return rng.integers(info.min, info.max, size=n, dtype=dt,
                            endpoint=True)
    if not specials:
        x = rng.standard_normal(n).astype(dt) * dt.type(100)
        x[rng.random(n) < 0.05] = dt.type(0.0)
        x[rng.random(n) < 0.05] = dt.type(-0.0)
        return x
    x = rng.standard_normal(n).astype(dt)
    x[rng.random(n) < 0.05] = -0.0
    x[rng.random(n) < 0.02] = np.inf
    x[rng.random(n) < 0.02] = -np.inf
    x[rng.random(n) < 0.02] = np.nan
    x[rng.random(n) < 0.02] = -np.nan
    x[rng.random(n) < 0.02] = 1e-40  # denormal
    return x


def _raw16(raw: np.ndarray, name: str, dev) -> torch.Tensor:
    """16-bit keys of the bit patterns ``raw`` as a tensor on ``dev``
    (bfloat16 has no numpy dtype here, so it is a view of int16)."""
    word = to_device(raw.view(np.int16), dev)
    return word.view({"uint16": torch.uint16, "int16": torch.int16,
                      "float16": torch.float16,
                      "bfloat16": torch.bfloat16}[name])


class Drive:
    """Runs checks on ``dev`` with ``method`` and counts the failures."""

    def __init__(self, dev, method: str = "auto", out=print):
        self.dev = device(str(dev))
        self.method = method
        self.out = out
        self.fails = 0
        self.checks = 0

    def t(self, a: np.ndarray) -> torch.Tensor:
        return to_device(a, self.dev)

    def check(self, name: str, got, want: np.ndarray) -> None:
        self.checks += 1
        g, w = host_bits(got), _unsigned(np.ascontiguousarray(want))
        if g.shape != w.shape or not np.array_equal(g, w):
            self.fails += 1
            where = (f"shape {g.shape} != {w.shape}" if g.shape != w.shape
                     else f"first at {int(np.argmax(g.ravel() != w.ravel()))}")
            self.out(f"FAIL: {name} ({where})")

    def keys(self, x, **kw):
        return thrs.sort_keys(self.t(x), method=self.method, **kw)

    def pairs(self, x, v, **kw):
        return thrs.sort_pairs(self.t(x), self.t(v), method=self.method, **kw)

    # -- the JAX drive's groups --------------------------------------------

    def fixed(self, sz: dict) -> None:
        rng = np.random.default_rng(7)
        for dt in (np.uint32, np.int32, np.float32, np.uint64, np.int64):
            for n in (1, 2, 1000, sz["keys"]):
                x = _rand_keys(rng, dt, n, specials=True)
                for order in ("ascending", "descending"):
                    p = oracle_perm(x, order == "descending")
                    self.check(f"keys {np.dtype(dt).name} {order} n={n}",
                               self.keys(x, order=order), x[p])

        n = sz["pairs"]
        x = rng.integers(0, 512, size=n).astype(np.uint32)
        v = np.arange(n, dtype=np.uint32)
        k2, v2 = self.pairs(x, v)
        p = oracle_perm(x)
        self.check("pairs stability", v2, v[p])
        self.check("pairs keys", k2, x[p])
        _, v3 = self.pairs(x, v, order="descending")
        self.check("pairs desc stability", v3, v[oracle_perm(x, True)])

        # bit windows (StartBits contract, reference unittest.cpp:248-355)
        n = sz["window"]
        x64 = rng.integers(0, 2**64, size=n, dtype=np.uint64)
        v64 = np.arange(n, dtype=np.uint64)
        for sb in (0, 8, 24, 56):
            _, v4 = self.pairs(x64, v64, start_bit=sb, end_bit=sb + 8)
            self.check(f"window u64 [{sb},{sb + 8})", v4,
                       v64[oracle_perm(x64, start=sb, end=sb + 8)])

        n = sz["extreme"]
        x = np.zeros(n, dtype=np.uint32)
        x[min(7, n - 1)] = 0xFFFFFFFF
        x[min(77777, n - 1)] = 1
        self.check("extreme", self.keys(x), np.sort(x))

        x = rng.integers(0, 100, size=sz["indices"], dtype=np.uint32)
        self.check("indices", thrs.sort_indices(self.t(x), method=self.method),
                   np.argsort(x, kind="stable").astype(np.int32))

        # u128 payload (reference K64V128, unittest.cpp:471-487)
        n = sz["u128"]
        x = rng.integers(0, 2**64, size=n, dtype=np.uint64)
        v128 = rng.integers(0, 2**32, size=(n, 4), dtype=np.uint32)
        _, v5 = self.pairs(x, v128)
        self.check("u128 payload", v5, v128[oracle_perm(x)])

        # 16-bit keys, every bit pattern (NaN payloads, -0.0, denormals):
        # f16 and bf16 order by the same sign-magnitude transform
        raw16 = rng.integers(0, 2**16, size=sz["b16"], dtype=np.uint16)
        for name in ("uint16", "int16", "float16", "bfloat16"):
            like = raw16.view(np.float16 if "float" in name else name)
            for order in ("ascending", "descending"):
                p = oracle_perm(like, order == "descending")
                got = thrs.sort_keys(_raw16(raw16, name, self.dev),
                                     order=order, method=self.method)
                self.check(f"keys {name} 16-bit {order}", got, raw16[p])

        # batched rows (2-D keys: independent row sorts)
        nr = sz["rows"]
        xb = rng.integers(0, 2**32, size=(64, nr), dtype=np.uint32)
        self.check("batched keys", self.keys(xb), np.sort(xb, axis=1))
        vb = np.broadcast_to(np.arange(nr, dtype=np.uint32), (64, nr)).copy()
        xbd = (xb % 11).astype(np.uint32)
        _, vbo = self.pairs(xbd, vb)
        pb = np.argsort(xbd, axis=1, kind="stable")
        self.check("batched pairs stability", vbo,
                   np.take_along_axis(vb, pb, 1))

        # segmented sort (order by (segment, key), stable)
        n = sz["seg"]
        xs = rng.integers(0, 2**32, size=n, dtype=np.uint32)
        seg = np.sort(rng.integers(0, 37, size=n).astype(np.int32))
        ks = self.keys(xs, segment_ids=self.t(seg))
        self.check("segmented keys", ks, xs[np.lexsort((xs, seg))])

        self.errors()

    def errors(self) -> None:
        zeros = self.t(np.zeros(4, np.uint32))
        for what, bad in (
                ("3-D keys", lambda: thrs.sort_keys(
                    self.t(np.zeros((2, 3, 4), np.uint32)))),
                ("unknown method", lambda: thrs.sort_keys(zeros,
                                                          method="bogus")),
                ("empty window", lambda: thrs.sort_keys(
                    zeros, start_bit=9, end_bit=3))):
            self.checks += 1
            try:
                bad()
            except (ValueError, TypeError):
                continue
            self.fails += 1
            self.out(f"FAIL: error path did not raise: {what}")

    # -- the reference-density tier (tests/test_full_matrix.py) -----------

    def density(self, iters: int, max_n: int = MAX_N) -> None:
        # the draws follow the engine of the tier's calls, whose n stay
        # below max_n
        engine = sort_mod._resolve_method(
            self.method, torch.empty(max_n - 1, dtype=torch.uint8,
                                     device=self.dev))
        for dt in (np.uint32, np.int32, np.float32, np.uint64, np.int64,
                   np.float64):
            name = np.dtype(dt).name
            for order in ("ascending", "descending"):
                rng = np.random.default_rng(
                    zlib.crc32(f"{name}/{order}/{engine}".encode()))
                for n in rng.integers(1, max_n, size=iters):
                    x = _rand_keys(rng, dt, int(n), specials=False)
                    p = oracle_perm(x, order == "descending")
                    self.check(f"density keys {name} {order} n={n}",
                               self.keys(x, order=order), x[p])

        for kdt, vdt in ((np.uint32, np.uint32), (np.float32, np.uint32),
                         (np.uint64, np.uint32), (np.uint32, np.uint64),
                         (np.uint64, np.uint64)):
            label = f"{np.dtype(kdt).name}/{np.dtype(vdt).name}"
            rng = np.random.default_rng(zlib.crc32(
                f"{label}/{engine}".encode()))
            for n in rng.integers(1, max_n, size=iters // 2):
                n = int(n)
                x = _rand_keys(rng, kdt, n, specials=False)
                # heavy duplicates half the time: ties stress stability
                if rng.random() < 0.5 and np.dtype(kdt).kind != "f":
                    x = (x % np.dtype(kdt).type(97)).astype(kdt)
                v = np.arange(n, dtype=vdt)
                gk, gv = self.pairs(x, v)
                p = oracle_perm(x)
                self.check(f"density pairs {label} n={n} keys", gk, x[p])
                self.check(f"density pairs {label} n={n} values", gv, v[p])

        rng = np.random.default_rng(0x57A47)
        for _ in range(iters // 2):
            n = int(rng.integers(1, max_n))
            start = int(rng.integers(0, 63))
            width = int(rng.integers(1, 65 - start))
            order = "descending" if rng.random() < 0.5 else "ascending"
            x = rng.integers(0, 2**64, size=n, dtype=np.uint64)
            v = np.arange(n, dtype=np.uint32)
            gk, gv = self.pairs(x, v, order=order, start_bit=start,
                                end_bit=start + width)
            p = oracle_perm(x, order == "descending", start, start + width)
            label = f"density window [{start},{start + width}) {order} n={n}"
            self.check(f"{label} keys", gk, x[p])
            self.check(f"{label} values", gv, v[p])

        for name in ("float64", "float16", "bfloat16"):
            for order in ("ascending", "descending"):
                self.adapter(name, order, iters // 2, max_n)

    def adapter(self, name: str, order: str, count: int, max_n: int) -> None:
        """Keys of every bit pattern sorted as their ``np_key_bits``
        (integers on the card) and rebuilt by ``np_key_bits_inverse``:
        bit-exact, -0.0 normalized to +0.0 by the forward transform; pairs
        at a quarter of the density. bf16 keys take f16's transform (both
        order by sign and magnitude)."""
        like = np.dtype(np.float64 if name == "float64" else np.float16)
        width = like.itemsize * 8
        desc = order == "descending"
        rng = np.random.default_rng(zlib.crc32(
            f"adapter/{name}/{order}".encode()))
        for i in range(count):
            n = int(rng.integers(1, max_n))
            raw = rng.integers(0, 2**width, size=n, dtype=np.uint64)
            x = raw.astype(f"u{like.itemsize}").view(like)
            bits = np_key_bits(x, descending=desc)
            p = np.argsort(bits, kind="stable")
            want = x[p].copy()
            want[want == like.type(0)] = like.type(0.0)
            sbits = thrs.sort_keys(self.t(bits), method=self.method)
            self.check(f"adapter {name} {order} n={n} bits", sbits, bits[p])
            back = np_key_bits_inverse(host_bits(sbits), like,
                                       descending=desc)
            self.check(f"adapter {name} {order} n={n} keys",
                       torch.from_numpy(back), want)
            if i % 4 == 0:
                v = np.arange(n, dtype=np.uint32)
                sb, sv = self.pairs(bits, v)
                back = np_key_bits_inverse(host_bits(sb), like,
                                           descending=desc)
                self.check(f"adapter {name} {order} n={n} pair keys",
                           torch.from_numpy(back), want)
                self.check(f"adapter {name} {order} n={n} pair values", sv,
                           v[p])


def drive(dev="cuda", method: str = "auto", iters: int = 0,
          cap: int | None = None, max_n: int = MAX_N, out=print) -> Drive:
    """Every fixed check (sizes capped at ``cap``) and, with ``iters``, the
    density sweep (sizes below ``max_n``); returns the :class:`Drive`."""
    d = Drive(dev, method, out)
    d.fixed(sizes(cap))
    if iters:
        d.density(iters, max_n)
    out(f"drive: {d.checks} checks on {d.dev} (method={method}, "
        f"iters={iters}), FAILURES: {d.fails}")
    return d


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=0)
    ap.add_argument("--method", default="auto")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    d = drive(args.device, args.method, args.iters,
              out=lambda line: print(line, flush=True))
    return min(d.fails, 255)


if __name__ == "__main__":
    raise SystemExit(main())
