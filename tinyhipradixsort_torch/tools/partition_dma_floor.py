"""Ragged bucketed-scatter floor on Hopper (port of the JAX package's
``tools/partition_dma_floor.py``).

A 256-way partition pass moves each tile's per-digit runs to
digit-contiguous regions of device memory: one data-dependent destination
per (tile, digit). This probe measures that primitive: ``t`` tiles of 256
runs of ``r`` 32-bit words, run ``b`` of tile ``ti`` copied to run slot
``offs[ti, b]`` (a random permutation of the slots), by the hand-written
kernel ``csrc/partition_scatter.cu``, beside its plain PyTorch version
:func:`partition_scatter_reference` and one ``index_copy_`` of the
``(t * 256, r)`` view, against the card's 3.35 TB/s.

Usage (on a machine with an NVIDIA GPU):
    python -m tinyhipradixsort_torch.tools.partition_dma_floor [--r 1024]
        [--w 8] [--t 64] [--reps 5]

``--w`` is the TPU tool's window of outstanding DMAs. It has no meaning for
this plain copy kernel, which keeps every run of the grid in flight; it is
accepted, reported and unused.
"""

from __future__ import annotations

import argparse
import ctypes
import functools

import torch

from ..ops import common, cuda_lib
from . import H100_BYTES_PER_S, card, cuda_ms, require_cuda

B = 256  # buckets (8-bit digit)

#: launches of the CUDA partition-scatter kernel in this process (counted
#: only where the kernel is launched)
KERNEL_LAUNCHES = 0


def make_inputs(t: int, r: int, seed: int = 0, device="cuda"):
    """``offs``: a random permutation of the ``t * 256`` run slots as
    ``(t, 256)`` int32; ``src``: ``t * 256 * r`` random u32 words (int32
    holding the pattern); both made on ``device`` from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    src = torch.randint(-2**31, 2**31, (t * B * r,), generator=gen,
                        device=device, dtype=torch.int64).to(torch.int32)
    offs = torch.randperm(t * B, generator=gen, device=device).to(
        torch.int32).view(t, B)
    return offs, src


def partition_scatter_reference(offs: torch.Tensor, src: torch.Tensor,
                                r: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: one index assignment of the
    ``(t * 256, r)`` view. ``offs`` must be a permutation of the slots."""
    out = torch.empty_like(src)
    out.view(-1, r)[offs.reshape(-1).long()] = src.view(-1, r)
    return out


@functools.cache
def _scatter_fn():
    fn = cuda_lib.load("partition_scatter").thrs_partition_scatter
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_scatter(offs: torch.Tensor, src: torch.Tensor,
                    r: int) -> torch.Tensor:
    global KERNEL_LAUNCHES
    t = offs.shape[0]
    if offs.shape != (t, B) or offs.dtype != torch.int32:
        raise TypeError(f"offs must be (t, {B}) int32, got {offs.dtype} of "
                        f"shape {tuple(offs.shape)}")
    if src.dtype not in (torch.int32, torch.uint32) or src.ndim != 1 \
            or src.numel() != t * B * r:
        raise TypeError(f"src must be {t * B * r} 32-bit words, got "
                        f"{src.dtype} of shape {tuple(src.shape)}")
    if not (offs.is_cuda and src.device == offs.device):
        raise ValueError(f"offs on {offs.device}, src on {src.device}: both "
                         "must be on one CUDA device")
    offs, src = offs.contiguous(), src.contiguous()
    out = torch.empty_like(src)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = _scatter_fn()(src.data_ptr(), offs.data_ptr(), out.data_ptr(),
                           t, r, stream)
    if rc != 0:
        raise RuntimeError(f"partition scatter kernel launch failed: CUDA "
                           f"error {rc} (t={t} r={r})")
    KERNEL_LAUNCHES += 1
    return out


def partition_scatter(offs: torch.Tensor, src: torch.Tensor,
                      r: int) -> torch.Tensor:
    """The scatter: CUDA tensors through the kernel, CPU tensors through
    :func:`partition_scatter_reference`. ``offs`` must be a permutation of
    the ``t * 256`` run slots, so that every output word is written."""
    if common.on_cuda(src):
        return _launch_scatter(offs, src, r)
    if src.device.type != "cpu":
        raise ValueError(f"no partition-scatter implementation for "
                         f"{src.device}")
    return partition_scatter_reference(offs, src, r)


def measure(r: int = 1024, w: int = 8, t: int = 64, reps: int = 5,
            seed: int = 0) -> dict:
    """Kernel, plain version and ``index_copy_`` on the card (CUDA events,
    median of ``reps`` after a warm-up); raises unless the kernel's output
    equals the plain version's. ``w`` is unused (see the module
    docstring)."""
    offs, src = make_inputs(t, r, seed)
    got = partition_scatter(offs, src, r)
    want = partition_scatter_reference(offs, src, r)
    if not torch.equal(got, want):
        raise AssertionError(f"partition scatter kernel != plain version "
                             f"(t={t} r={r})")
    del got, want
    ms = cuda_ms(lambda: partition_scatter(offs, src, r), reps)
    plain_ms = cuda_ms(lambda: partition_scatter_reference(offs, src, r),
                       reps)
    slots = offs.reshape(-1).long()
    out = torch.empty_like(src)
    library_ms = cuda_ms(
        lambda: out.view(-1, r).index_copy_(0, slots, src.view(-1, r)), reps)
    moved = 2 * 4 * src.numel()
    return {"r": r, "w": w, "t": t, "n": src.numel(), "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bytes": moved,
            "tb_per_s": moved / ms / 1e9,
            "bound_ms": moved / H100_BYTES_PER_S * 1e3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--r", type=int, default=1024,
                    help="run length in u32 elements (4 KB at 1024)")
    ap.add_argument("--w", type=int, default=8,
                    help="the TPU tool's outstanding-DMA window; unused here")
    ap.add_argument("--t", type=int, default=64, help="tiles of 256 runs")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    require_cuda("partition_dma_floor")
    m = measure(args.r, args.w, args.t, args.reps)
    print(f"runs {B}x{m['t']} of {m['r'] * 4} B (w={m['w']}, unused): kernel "
          f"{m['ms']:.6f} ms -> {m['tb_per_s'] * 1e3:.1f} GB/s read+write "
          f"({100 * m['bound_ms'] / m['ms']:.1f}% of 3.35 TB/s, bound "
          f"{m['bound_ms']:.6f} ms); plain version {m['plain_ms']:.6f} ms; "
          f"index_copy_ {m['library_ms']:.6f} ms; card: {card()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
