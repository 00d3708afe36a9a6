"""Importing the PyTorch port loads neither JAX nor Triton and builds
nothing: each CUDA kernel is compiled only at its first use on a CUDA
tensor."""

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
from tinyhipradixsort_torch.tools import gather_floor, partition_dma_floor
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "triton"))
assert not loaded, loaded
assert not cuda_lib.BUILD_INFO
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


def test_port_sources_never_import_jax():
    pkg = ROOT / "tinyhipradixsort_torch"
    for path in [*pkg.rglob("*.py"), ROOT / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert words[1].split(".")[0] not in (
                    "jax", "jaxlib", "tinyhipradixsort_tpu"), (path, line)
