"""A cell of more than one rank: one process a rank, as the traffic's
``ranks`` and ``backend`` say.

Each rank joins a ``torch.distributed`` group at ``tcp://localhost:<a
free port>`` and runs the cell's window on its own card (``nccl``: card
``rank``) or on the CPU (``gloo``, for tests). Rank 0 says when the
window closes, and prints the result line itself, after its own import
check; the launcher exits with the first non-zero exit code of a rank.
"""

from __future__ import annotations

import multiprocessing
import multiprocessing.connection
import socket
import sys
import time
from pathlib import Path

#: seconds a rank may take before the launcher ends it (a first run in a
#: checkout builds the kernels)
RANK_TIMEOUT_S = 1200


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(rank: int, world: int, port: int, backend: str, bench: dict,
          name: str, seed: int, seconds: float, trace: bool, device: str,
          root: str, start: float) -> None:
    import torch
    import torch.distributed as dist
    from sortbench import run
    if device == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    code = 0
    try:
        result = run.run_cell(bench, name, seed, seconds, trace, device,
                              Path(root), rank, world, start)
        if result is not None:
            code = run.emit(result)
    finally:
        dist.destroy_process_group()
    sys.exit(code)


def spawn(bench: dict, name: str, seed: int, seconds: float, trace: bool,
          device: str, root, ranks: int, backend: str, start: float) -> int:
    """Run the cell on ``ranks`` processes and wait for all of them."""
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_rank, args=(
        r, ranks, port, backend, bench, name, seed, seconds, trace, device,
        str(root), start)) for r in range(ranks)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:  # a rank that fails ends the others, which would wait for it
        while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
            multiprocessing.connection.wait(
                [p.sentinel for p in procs if p.is_alive()], timeout=1.0)
            if any(p.exitcode not in (None, 0) for p in procs):
                break
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    return next((c if c > 0 else 1 for c in codes if c != 0), 0)
