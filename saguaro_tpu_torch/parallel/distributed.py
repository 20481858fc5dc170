"""Multi-process scaling over ``torch.distributed`` (port of
``saguaro_tpu/parallel/distributed.py``).

The reference scales across machines with an EC2 fleet driven over SSM and
object storage as the data plane (Feature_extraction_opt.py:73-145); the
port's equivalent is one process per host (or card) running the same
driver, with the embarrassingly parallel job grid (plates x timepoints)
partitioned by rank. The object store stays the data plane; no collective
runs. Nothing tells a program of a cluster here, so the caller gives
``maybe_initialize`` the coordinator's address, the process count and the
rank.
"""

from __future__ import annotations

import logging

import torch.distributed as dist

logger = logging.getLogger("saguaro_tpu_torch.distributed")

__all__ = ["maybe_initialize", "partition_jobs", "process_info"]


def maybe_initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize the default process group when a coordinator address
    (``host:port`` or a ``tcp://`` URL) or a process count is given; without
    an address, torch's ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``) names
    the coordinator.

    A no-op for one process (neither given) and when a group is already
    initialized. The job partition needs no collective, so the backend is
    ``gloo``, which runs on every host."""
    if coordinator_address is None and num_processes is None:
        return
    if dist.is_initialized():
        logger.warning("torch.distributed is already initialized; skipping")
        return
    url = coordinator_address or "env://"
    if "://" not in url:
        url = f"tcp://{url}"
    dist.init_process_group("gloo", init_method=url, world_size=num_processes or 1,
                            rank=process_id or 0)
    logger.info("torch.distributed: process %d/%d", dist.get_rank(), dist.get_world_size())


def process_info() -> tuple[int, int]:
    """(rank, world size) of the initialized process group, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def partition_jobs(jobs: list, process_id: int | None = None, num_processes: int | None = None) -> list:
    """Deterministic strided partition of a job list across processes: every
    process computes the same global order and takes the jobs where
    ``index % num_processes == process_id`` (no coordination; idempotent
    with manifest-based resume)."""
    rank, world = process_info()
    process_id = rank if process_id is None else process_id
    num_processes = world if num_processes is None else num_processes
    return [j for i, j in enumerate(jobs) if i % num_processes == process_id]
