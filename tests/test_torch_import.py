"""Importing the PyTorch port, its harness scripts included, loads neither
JAX, the JAX package nor Triton and builds nothing: each CUDA kernel is compiled only at its first use on a CUDA
tensor, and the native host oracle at its first call."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import sys
import tinyhipradixsort_torch
import tinyhipradixsort_torch.sort, tinyhipradixsort_torch.config
from tinyhipradixsort_torch.ops import bitonic_engine, cuda_lib, network_engine
from tinyhipradixsort_torch.ops import argsort_engine, counting_engine, histogram
from tinyhipradixsort_torch.ops import partition_engine
from tinyhipradixsort_torch.tools import gather_floor, partition_dma_floor
from tinyhipradixsort_torch.parallel import dryrun, multihost, psort
from tinyhipradixsort_torch.utils import native_oracle, prng, profiling
from tinyhipradixsort_torch import bench, entry, tracing
from tinyhipradixsort_torch.benchmarks import full, scaling
from tinyhipradixsort_torch.examples import helloworld, segmented, soak
from tinyhipradixsort_torch.tools import (baseline_scale, drive,
                                          nonpow2_sweep, verify_baseline)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "triton",
                                       "tinyhipradixsort_tpu"))
assert not loaded, loaded
assert not cuda_lib.BUILD_INFO
assert not native_oracle._tried
assert tracing._REC is None
for mod in (bitonic_engine, histogram, gather_floor, partition_dma_floor):
    assert mod.KERNEL_LAUNCHES == 0, mod
print("clean")
"""


def test_import_loads_no_jax_or_triton_and_builds_nothing():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_a_reused_library_keeps_its_build_log(tmp_path, monkeypatch):
    # a built library is reused without nvcc, and the output of the build
    # that made it (ptxas spills, which chip_smoke.py checks) is read back
    from tinyhipradixsort_torch.ops import cuda_lib
    monkeypatch.setattr(cuda_lib, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(cuda_lib, "BUILD_INFO", {})
    (tmp_path / "probe.cu").write_text("// a source\n")
    so = cuda_lib.library_path("probe")
    so.parent.mkdir()
    so.write_bytes(b"")
    text = "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
    so.with_name(f"{so.name}.log").write_text(text)
    cuda_lib.build(["probe"])
    assert cuda_lib.BUILD_INFO["probe"] == {"path": str(so), "seconds": 0.0,
                                            "log": text}


def test_port_sources_never_import_jax():
    pkg = ROOT / "tinyhipradixsort_torch"
    for path in [*pkg.rglob("*.py"), ROOT / "chip_smoke.py",
                 ROOT / "tests" / "_torch_psort_worker.py"]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert words[1].split(".")[0] not in (
                    "jax", "jaxlib", "tinyhipradixsort_tpu"), (path, line)
