"""Build and load the port's CUDA sources.

No JAX counterpart: the JAX package's kernels (Pallas, e.g. in
``tinyhipradixsort_tpu/ops/bitonic_engine.py``) are compiled by JAX itself.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with a
plain C interface and loaded with ``ctypes``. Nothing is compiled at import:
:func:`load` builds at the first call that needs a kernel, and
:func:`build` builds several sources at once, one ``nvcc`` each, in
parallel. The library goes
to ``tinyhipradixsort_torch/_build/`` under a name that carries the hash of
the source and the flags, so an edited source is rebuilt and an unchanged one
is reused. The build writes a temporary file and renames it, so processes
that build at once do not see a half-written library. nvcc's output (ptxas
registers and spills per kernel function) is kept beside the library, in
``<library>.log``, and read back when the library is reused. While
:mod:`..tracing` records, a ``cuda_lib.build`` span covers each
:func:`build` and each library's first :func:`load`, so a kernel built
again shows.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from .. import tracing

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}
#: per library: {"path", "seconds" (0.0 when reused), "log" (nvcc's output,
#: from the build that made the library)}
BUILD_INFO: dict[str, dict] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for cand in candidates:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels are built from "
            f"{CSRC_DIR} at first use")
    return found


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names) -> None:
    """Build the libraries of ``csrc/<name>.cu`` for every name that is not
    built yet, one ``nvcc`` process per source, all started together.
    Records each in :data:`BUILD_INFO`; raises if any build fails."""
    with tracing.span("cuda_lib.build", n=len(names)):
        _build(names)


def _build(names) -> None:
    jobs = []
    for name in names:
        so = library_path(name)
        BUILD_INFO[name] = {"path": str(so), "seconds": 0.0, "log": ""}
        if so.is_file():
            log = so.with_name(f"{so.name}.log")
            BUILD_INFO[name]["log"] = log.read_text() if log.is_file() else ""
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, so, tmp, proc, time.perf_counter()))
    failed = []
    for name, so, tmp, proc, t0 in jobs:
        out, _ = proc.communicate()
        info = BUILD_INFO[name]
        info["seconds"] = time.perf_counter() - t0
        info["log"] = out.strip()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed ({proc.returncode}) building {name}:"
                          f"\n{info['log']}")
        else:
            log = so.with_name(f"{so.name}.log")
            tmp_log = log.with_name(f"{log.name}.{os.getpid()}.tmp")
            tmp_log.write_text(info["log"])
            os.replace(tmp_log, log)
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, building it if needed."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    with tracing.span("cuda_lib.build"):
        if name not in BUILD_INFO:
            build([name])
        lib = ctypes.CDLL(BUILD_INFO[name]["path"])
    _LOADED[name] = lib
    return lib
