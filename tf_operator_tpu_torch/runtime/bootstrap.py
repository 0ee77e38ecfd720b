"""Joining a job's world from the operator-injected ``TPUJOB_*``
environment (the port of ``tf_operator_tpu/runtime/bootstrap.py``, on
``torch.distributed``).

``initialize(device)`` is the first call of a training entry point:

- no operator environment, or a job of one process: nothing changes;
  the context (or None) is returned;
- more than one process: ``torch.distributed.init_process_group`` at
  ``tcp://<TPUJOB_COORDINATOR_ADDRESS>`` with ``rank`` = the process id
  and ``world_size`` = the process count, on the backend
  :func:`choose_backend` picks before the call, from the world and the
  visible GPUs:

  - ``gloo`` on the CPU;
  - ``nccl`` when every rank on the host has a CUDA device of its own;
  - ``gloo`` when ranks share a card (NCCL refuses two ranks on one GPU).

  The choice is made from what is known before the call, never by
  catching a failure; it is stored in the context and printed.  Each
  rank's device is ``cuda:(process_id % device_count)``.

  A gloo world is torn down (``destroy_process_group``) when the
  interpreter exits: left to the C++ static destructors, a rank that
  had finished its work aborted now and then (``terminate called
  without an active exception``: 2 to 3 rank exits in a hundred with
  six 4-rank worlds on 8 cores, ``tests/torch_teardown_stress.py``).

The ranks that share the host are ``LOCAL_WORLD_SIZE`` when it is set;
else every rank when the coordinator's address is a loopback one (the
operator's local backend runs the whole job on one host); else one (a
pod is a host).
"""

from __future__ import annotations

import atexit
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from tf_operator_tpu_torch.bootstrap.tpu_env import (
    ENV_COORDINATOR,
    ENV_JOB_NAME,
    ENV_NUM_PROCESSES,
    ENV_PROCESS_ID,
    ENV_REPLICA_INDEX,
    ENV_REPLICA_TYPE,
)

#: the ranks on this host, when a launcher states them (torchrun's name)
ENV_LOCAL_WORLD_SIZE = "LOCAL_WORLD_SIZE"

_LOOPBACK = ("localhost", "127.0.0.1", "::1", "[::1]")


@dataclass
class JobContext:
    job_name: str
    replica_type: str
    replica_index: int
    process_id: int
    num_processes: int
    coordinator_address: str
    #: the collective backend ``initialize`` joined ("" before it)
    backend: str = ""
    #: this rank's device, set by ``initialize``
    device: Optional[torch.device] = None

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0


def from_env(environ=None) -> Optional[JobContext]:
    """Parse the injected environment; None when not running under the
    operator."""

    e = environ if environ is not None else os.environ
    if ENV_COORDINATOR not in e:
        return None
    return JobContext(
        job_name=e.get(ENV_JOB_NAME, ""),
        replica_type=e.get(ENV_REPLICA_TYPE, ""),
        replica_index=int(e.get(ENV_REPLICA_INDEX, "0")),
        process_id=int(e.get(ENV_PROCESS_ID, "0")),
        num_processes=int(e.get(ENV_NUM_PROCESSES, "1")),
        coordinator_address=e[ENV_COORDINATOR],
    )


def ranks_on_host(ctx: JobContext, environ=None) -> int:
    """How many of the job's ranks share this host (module docstring)."""

    e = environ if environ is not None else os.environ
    if e.get(ENV_LOCAL_WORLD_SIZE):
        return int(e[ENV_LOCAL_WORLD_SIZE])
    host = ctx.coordinator_address.rsplit(":", 1)[0]
    return ctx.num_processes if host in _LOOPBACK else 1


def choose_backend(device_type: str, ranks_on_host: int, visible_gpus: int) -> str:
    """``gloo`` on the CPU; on CUDA ``nccl`` when the host's ranks each
    have a GPU of their own, else ``gloo`` (ranks that share a card)."""

    if device_type == "cpu":
        return "gloo"
    if device_type != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device_type!r}")
    return "nccl" if ranks_on_host <= visible_gpus else "gloo"


def rank_device(device_type: str, process_id: int) -> torch.device:
    """``cuda:(process_id % device_count)`` on CUDA (raises without a
    GPU), the CPU otherwise."""

    if device_type == "cpu":
        return torch.device("cpu")
    from tf_operator_tpu_torch.device import resolve_device

    resolve_device("cuda")
    return torch.device("cuda", process_id % torch.cuda.device_count())


def initialize(device: Optional[str] = None) -> Optional[JobContext]:
    """Join the job's world (module docstring).  ``device``: "cuda" (the
    default) or "cpu".  Call before any collective; a second call in a
    process that has joined returns the context again."""

    import torch.distributed as dist

    device_type = torch.device(device or "cuda").type
    ctx = from_env()
    if ctx is None or ctx.num_processes <= 1:
        return ctx
    ctx.device = rank_device(device_type, ctx.process_id)
    gpus = torch.cuda.device_count() if device_type == "cuda" else 0
    ctx.backend = choose_backend(device_type, ranks_on_host(ctx), gpus)
    if dist.is_initialized():
        return ctx
    if ctx.device.type == "cuda":
        torch.cuda.set_device(ctx.device)
    dist.init_process_group(
        ctx.backend,
        init_method=f"tcp://{ctx.coordinator_address}",
        rank=ctx.process_id,
        world_size=ctx.num_processes,
    )
    if ctx.backend == "gloo":
        atexit.register(_leave_world)
    print(f"process {ctx.process_id}/{ctx.num_processes}: joined a {ctx.backend} world at "
          f"{ctx.coordinator_address} on {ctx.device}", flush=True)
    return ctx


def _leave_world() -> None:
    """Destroy the joined world's process groups (module docstring)."""

    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def world() -> Tuple[int, int]:
    """(rank, world size) of the joined world; (0, 1) outside one."""

    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def entry_device(device: str, ctx: Optional[JobContext]) -> torch.device:
    """An entry point's device: the rank's in a joined world, else
    ``resolve_device(device)``."""

    from tf_operator_tpu_torch.device import resolve_device

    if ctx is not None and ctx.device is not None:
        return ctx.device
    return resolve_device(device)
