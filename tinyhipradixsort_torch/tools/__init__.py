"""Measurement probes of the PyTorch port, each runnable with ``python -m``
(ports of the JAX package's ``tools/gather_floor.py`` and
``tools/partition_dma_floor.py``), and the timing helpers they share."""

from __future__ import annotations

import statistics
import subprocess

import torch

H100_BYTES_PER_S = 3.35e12  # HBM3 of an H100 SXM (NVIDIA's data sheet)


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
