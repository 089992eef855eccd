"""Multi-process initialization and the mesh over every process's devices.

Counterpart of bayesian_optimization_tpu/parallel/distributed.py.
`initialize()` wraps `torch.distributed.init_process_group` (TCP rendezvous
at the coordinator's address; NCCL where the process has a GPU, Gloo on
the CPU); `population_mesh()` returns the `particles` mesh over every
process's devices, each process owning its own entries.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import ParticleMesh, make_particle_mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join the process group when running multi-process; a no-op (False)
    for a single process. The world size defaults to BO_TPU_WORLD, the rank
    to BO_TPU_RANK; without a coordinator address the rendezvous reads
    torch's MASTER_ADDR and MASTER_PORT."""
    num = num_processes if num_processes is not None else int(os.environ.get("BO_TPU_WORLD", "1"))
    if num <= 1 and coordinator_address is None:
        return False
    rank = process_id if process_id is not None else int(os.environ.get("BO_TPU_RANK", "0"))
    if torch.cuda.is_available():
        backend = "nccl"
        torch.cuda.set_device(_local_cuda_index(rank))
    else:
        backend = "gloo"
    init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    dist.init_process_group(backend, init_method=init, world_size=num, rank=rank)
    return True


def _local_cuda_index(rank: int) -> int:
    return int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count()


def population_mesh() -> ParticleMesh:
    """Particles mesh over every process's device (its card under NCCL, the
    CPU under Gloo), in rank order; a single process's is the default mesh."""
    if not dist.is_initialized():
        return make_particle_mesh()
    rank = dist.get_rank()
    mine = (f"cuda:{torch.cuda.current_device()}" if dist.get_backend() == "nccl" else "cpu")
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, mine)
    return ParticleMesh(names, owners=range(len(names)), rank=rank)


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0
