"""Measurement probes and on-card drives of the PyTorch port, each runnable
with ``python -m`` (ports of the JAX repo's ``tools/gather_floor.py``,
``tools/partition_dma_floor.py``, ``tools/drive_tpu.py``,
``tools/verify_baseline.py``, ``tools/nonpow2_sweep.py`` and the
counterpart of ``tools/trace_baseline_scale.py``), and the helpers the
harness scripts share: the card's name, CUDA-event timing, the device a
script runs on, and host <-> device copies by bit pattern."""

from __future__ import annotations

import statistics
import subprocess

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3 of an H100 SXM (NVIDIA's data sheet)

_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_UNSIGNED = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median device time of ``fn()`` in ms over ``reps`` runs after a
    warm-up run (CUDA events around each run)."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def require_cuda(tool: str) -> None:
    if not torch.cuda.is_available():
        raise SystemExit(f"{tool}: torch.cuda.is_available() is false; this "
                         "probe measures an NVIDIA GPU")


def device(name: str) -> torch.device:
    """The device a harness script runs on (its ``--device``): ``cuda``
    needs a CUDA device and raises without one; the CPU runs only when it
    is asked for."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: torch.cuda.is_available() is "
                           "false; pass --device cpu to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"--device {name}: expected cuda or cpu")
    return dev


def device_name(dev: torch.device) -> str:
    """What a result line names as its device."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``dev`` (same dtype and bits)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def host_bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's bit patterns on the host, as unsigned integers of its
    width (floats compare bit-exactly this way: NaN payloads, -0.0)."""
    word = t.detach().cpu().contiguous().view(_SIGNED[t.dtype.itemsize])
    return word.numpy().view(_UNSIGNED[t.dtype.itemsize])
