"""Multi-process distribution runtime, on ``torch.distributed``.

The port of ``emsar_tpu/parallel/dist.py`` (with ``init_distributed`` of
``emsar_tpu/parallel/mesh.py``).  Alignment shards are collapsed in each
process into SampleCounts, merged across processes, and every process
quantifies the identical merged counts.

The processes find each other through torch's own environment, as
``torchrun`` sets it, in place of the JAX package's variables:

    EMSAR_TPU_COORDINATOR=host:port  ->  MASTER_ADDR=host MASTER_PORT=port
    EMSAR_TPU_NUM_PROCS=n            ->  WORLD_SIZE=n
    EMSAR_TPU_PROCESS_ID=i           ->  RANK=i
    (each process's card)            ->  LOCAL_RANK=k: cuda:k (default 0)

Runbook (2 processes on one machine):

    torchrun --nproc_per_node 2 -m emsar_tpu_torch.cli.emsar \\
        -q -M --dist_merge_shards -I idx.rsh out s shards.list

or the four variables set by hand for each process.  ``shards.list``
lists alignment shards of ONE sample; process i ingests lines i, i+N,
... and the merged counts equal the single-process run's exactly, so the
outputs are identical (process 0 writes them).

The count merge and the barrier are host work on int64 tensors over a
gloo group (the JAX package gathers the arrays and sums them in NumPy):
the sums are exact, and several processes may share one card.  A world
of one makes no process group, and every function below reduces to the
single-process case.  A process group that fails to form raises; nothing
falls back to a single process.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch
import torch.distributed as dist

from ..ingest.collapse import SampleCounts


def init_distributed(master_addr: str, master_port: int, world_size: int,
                     rank: int) -> None:
    """Join the gloo process group of ``world_size`` processes at
    ``tcp://master_addr:master_port`` as ``rank`` (no-op when a group is
    already initialized).  Collectives on CUDA tensors take their own
    NCCL groups (``parallel.mesh.make_mesh``)."""
    if dist.is_initialized():
        return
    dist.init_process_group(
        "gloo", init_method=f"tcp://{master_addr}:{master_port}",
        world_size=world_size, rank=rank)


def maybe_init_from_env() -> bool:
    """Join the process group named by ``WORLD_SIZE``, ``RANK``,
    ``MASTER_ADDR`` and ``MASTER_PORT`` when ``WORLD_SIZE`` > 1; returns
    True when running multi-process."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    init_distributed(os.environ["MASTER_ADDR"],
                     int(os.environ["MASTER_PORT"]), world,
                     int(os.environ["RANK"]))
    return True


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    return process_index() == 0


def rank_device(device: torch.device) -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK`` for a CUDA device in a
    world of several processes (one card a rank; processes that share a
    card set the same LOCAL_RANK), else ``device``."""
    if device.type != "cuda" or process_count() == 1:
        return device
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    torch.cuda.set_device(dev)
    return dev


def shard_list(items: List[str]) -> List[str]:
    """This process's strided slice of a work list."""
    return list(items[process_index()::process_count()])


def allreduce_counts(counts: SampleCounts) -> SampleCounts:
    """Sum SampleCounts across processes: exact int64 sums over the gloo
    group, and every process returns the identical merged counts, so the
    quantification that follows gives the same bits in every process."""
    if process_count() == 1:
        return counts

    def reduce_one(arr) -> np.ndarray:
        t = torch.as_tensor(np.asarray(arr, dtype=np.int64)).clone()
        dist.all_reduce(t)
        return t.numpy()

    return SampleCounts(
        single_counts=reduce_one(counts.single_counts),
        multi_counts=reduce_one(counts.multi_counts),
        fraglength_counts=reduce_one(counts.fraglength_counts),
        total_read_count=int(reduce_one([counts.total_read_count])[0]))


def barrier() -> None:
    """Wait for every process."""
    if process_count() > 1:
        dist.barrier()
