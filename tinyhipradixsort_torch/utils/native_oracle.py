"""ctypes bridge to the native C++ host oracle (``native/thrs_host.cpp``;
PyTorch port of ``tinyhipradixsort_tpu/utils/native_oracle.py``).

The reference checks its GPU sorts against a parallel CPU radix sort
(reference: main.cpp:195, unittest.cpp:526); numpy's stable argsort is far
slower, which makes checking 2**28 keys the slow part of a run. The oracle
is compiled at its first use (``g++ -O3 -fopenmp``) into the ignored
``tinyhipradixsort_torch/_build/``, under a name that carries the hash of
the source, through a temporary file and a rename, so processes that build
at once never load a half-written library. Without a toolchain every
function falls back to numpy; :func:`available` says which one runs. It is
an oracle on the host, not the device path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from .. import keybits

_PKG_DIR = Path(__file__).resolve().parent.parent
_SRC = _PKG_DIR.parent / "native" / "thrs_host.cpp"
_BUILD_DIR = _PKG_DIR / "_build"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> Path | None:
    if not _SRC.is_file():
        return None
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(_FLAGS).encode()).hexdigest()[:16]
    so = _BUILD_DIR / f"libthrs_host-{digest}.so"
    if so.is_file():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    for extra in (["-fopenmp"], []):
        cmd = ["g++", *_FLAGS, *extra, str(_SRC), "-o", str(tmp)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except (subprocess.SubprocessError, FileNotFoundError):
            continue
        os.replace(tmp, so)
        return so
    tmp.unlink(missing_ok=True)
    return None


def get_lib():
    """The loaded native library, or None if it cannot be built."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(str(so))
        i64, p = ctypes.c_int64, ctypes.POINTER
        lib.thrs_version.argtypes = []
        lib.thrs_version.restype = ctypes.c_int
        for name, word in (("thrs_radix_sort_u32", ctypes.c_uint32),
                           ("thrs_radix_sort_u64", ctypes.c_uint64)):
            fn = getattr(lib, name)
            fn.argtypes = [p(word), p(ctypes.c_uint64), i64, ctypes.c_int,
                           ctypes.c_int]
            fn.restype = None
        for name, it, ot in (
                ("thrs_key_bits_f32", ctypes.c_float, ctypes.c_uint32),
                ("thrs_key_bits_f64", ctypes.c_double, ctypes.c_uint64),
                ("thrs_key_bits_i32", ctypes.c_int32, ctypes.c_uint32),
                ("thrs_key_bits_i64", ctypes.c_int64, ctypes.c_uint64)):
            fn = getattr(lib, name)
            fn.argtypes = [p(it), p(ot), i64]
            fn.restype = None
        if lib.thrs_version() != 1:
            raise RuntimeError(f"{so}: unexpected thrs_version "
                               f"{lib.thrs_version()}")
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native library runs; False: the numpy fallback."""
    return get_lib() is not None


def _as_ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


_KEY_BITS = {
    np.dtype(np.float32): ("thrs_key_bits_f32", ctypes.c_float, np.uint32,
                           ctypes.c_uint32),
    np.dtype(np.float64): ("thrs_key_bits_f64", ctypes.c_double, np.uint64,
                           ctypes.c_uint64),
    np.dtype(np.int32): ("thrs_key_bits_i32", ctypes.c_int32, np.uint32,
                         ctypes.c_uint32),
    np.dtype(np.int64): ("thrs_key_bits_i64", ctypes.c_int64, np.uint64,
                         ctypes.c_uint64),
}


def native_key_bits(keys: np.ndarray) -> np.ndarray:
    """Order-preserving bits by the native transforms (numpy fallback, and
    numpy for unsigned and 16-bit keys)."""
    lib = get_lib()
    spec = _KEY_BITS.get(np.dtype(keys.dtype))
    if lib is None or spec is None:
        return keybits.np_key_bits(keys)
    name, it, out_dt, ot = spec
    keys = np.ascontiguousarray(keys)
    out = np.empty(keys.shape[0], out_dt)
    getattr(lib, name)(_as_ptr(keys, it), _as_ptr(out, ot), keys.shape[0])
    return out


def native_sort_bits(bits: np.ndarray, *, with_perm: bool = False):
    """Stable LSD radix sort of u32/u64 bits: the sorted bits (a copy), and
    the stable sorting permutation (u64) with ``with_perm``. numpy's stable
    argsort when the native library is unavailable."""
    dt = np.dtype(bits.dtype)
    if dt not in (np.uint32, np.uint64):
        raise TypeError(f"bits must be uint32/uint64, got {dt}")
    lib = get_lib()
    if lib is None:
        perm = np.argsort(bits, kind="stable")
        return (bits[perm], perm.astype(np.uint64)) if with_perm \
            else bits[perm]
    out = np.ascontiguousarray(bits).copy()
    n = out.shape[0]
    perm = np.arange(n, dtype=np.uint64) if with_perm else None
    perm_ptr = _as_ptr(perm, ctypes.c_uint64) if with_perm else None
    if dt == np.uint32:
        lib.thrs_radix_sort_u32(_as_ptr(out, ctypes.c_uint32), perm_ptr, n,
                                0, 4)
    else:
        lib.thrs_radix_sort_u64(_as_ptr(out, ctypes.c_uint64), perm_ptr, n,
                                0, 8)
    return (out, perm) if with_perm else out


def oracle_sort(keys: np.ndarray, *, descending: bool = False):
    """(sorted keys, stable permutation as int64) of host keys."""
    bits = native_key_bits(keys)
    if descending:
        bits = ~bits
    _, perm = native_sort_bits(bits, with_perm=True)
    perm = perm.astype(np.int64)
    return keys[perm], perm
