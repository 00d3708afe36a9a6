"""Process-group bootstrap for the distributed sort (PyTorch port of
``tinyhipradixsort_tpu/parallel/multihost.py``).

The JAX package runs on JAX's own process group and a device mesh; here
the group is ``torch.distributed``'s, and each process drives one device:

    from tinyhipradixsort_torch.parallel import multihost
    multihost.initialize()            # env-driven under torchrun
    out = thrs.psort_keys(my_piece)   # group=None: the default group

The counterpart of the JAX package's ``make_sort_mesh``/``global_sort_mesh``
is the ``group=`` argument of :mod:`.psort` (``None``: the default group);
a process's place on the mesh axis is ``dist.get_rank(group)``, and the
ring of the exchange follows the group's rank order.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def initialize(backend: str | None = None, init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None) -> None:
    """``dist.init_process_group`` with the defaults ``torchrun`` sets.

    ``backend``: ``"nccl"`` when CUDA is present, else ``"gloo"``.
    ``init_method``: ``"env://"`` (``MASTER_ADDR``/``MASTER_PORT``), or e.g.
    ``"file:///path"`` or ``"tcp://127.0.0.1:<port>"``. ``world_size`` and
    ``rank``: ``WORLD_SIZE`` and ``RANK``. With NCCL the process takes the
    CUDA device ``LOCAL_RANK`` (default: its rank modulo the device count),
    since NCCL allows one rank per device.
    """
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
