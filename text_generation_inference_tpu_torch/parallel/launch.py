"""One process per card: the ranks' env contract, their process groups,
and the spawn that `serve` uses (the reference's launcher and
utils/dist.py:70-96; the JAX package's multi-host contract).

The env is the JAX package's (its `server/main.py:37-58`, README
"Multi-host serving"), so one deployment serves either package:

  JAX_COORDINATOR_ADDRESS  host:port of rank 0's host, where the process
                           group meets (unset: one host, a free local port)
  JAX_NUM_PROCESSES        the number of hosts (default 1)
  JAX_PROCESS_ID           this host's index (default 0)
  TENSOR_PARALLEL          the ranks over every host (default: every local
                           card of every host, as the JAX package defaults
                           to every device; 1 on the CPU)

Each host starts TENSOR_PARALLEL / JAX_NUM_PROCESSES ranks, one a card,
and rank = host index * ranks a host + local index. The tensor-parallel
collectives go over the default group: NCCL on CUDA, gloo on the CPU (the
reference's choice). The op stream of `multihost.py` goes over a second,
gloo group on CPU tensors. The JAX package's MULTIHOST_STEP_PORT is gone:
the op stream uses the group.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import signal
import socket
from typing import Callable, Optional

import torch
import torch.distributed as dist

from .comm import TPGroup
from .multihost import OpChannel

# how long a collective, or a follower waiting for the next op, may wait
GROUP_TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where this host's ranks sit in the group."""

    world: int          # ranks over every host
    per_host: int       # ranks on this host
    host: int           # this host's index
    coordinator: str    # host:port where the group meets

    def rank(self, local: int) -> int:
        return self.host * self.per_host + local


def local_cards(device_type: str) -> int:
    """The ranks a host can start: its CUDA cards, or one on the CPU."""
    return torch.cuda.device_count() if device_type == "cuda" else 1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def layout(device_type: str, env=None) -> Layout:
    """This host's layout from the env contract above."""
    env = os.environ if env is None else env
    hosts = int(env.get("JAX_NUM_PROCESSES", "1"))
    host = int(env.get("JAX_PROCESS_ID", "0"))
    world = int(env.get("TENSOR_PARALLEL",
                        str(hosts * local_cards(device_type))))
    if world < 1 or world % hosts:
        raise ValueError(f"TENSOR_PARALLEL={world} is not a multiple of "
                         f"JAX_NUM_PROCESSES={hosts}")
    per_host = world // hosts
    if per_host > local_cards(device_type) and device_type == "cuda":
        raise ValueError(f"{per_host} ranks a host, {local_cards('cuda')} "
                         "CUDA cards here")
    coordinator = env.get("JAX_COORDINATOR_ADDRESS")
    if coordinator is None:
        if hosts > 1:
            raise ValueError("JAX_NUM_PROCESSES > 1 needs "
                             "JAX_COORDINATOR_ADDRESS")
        coordinator = f"localhost:{_free_port()}"
    return Layout(world=world, per_host=per_host, host=host,
                  coordinator=coordinator)


def init_rank(rank: int, world: int, coordinator: str, backend: str
              ) -> tuple[TPGroup, OpChannel]:
    """Join the group at `coordinator` as `rank`: the tensor-parallel group
    (the default group, on `backend`) and the op stream's gloo group."""
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            rank=rank, world_size=world,
                            timeout=GROUP_TIMEOUT)
    ops = dist.new_group(backend="gloo", timeout=GROUP_TIMEOUT)
    return TPGroup(rank, world), OpChannel(ops)


def spawn(fn: Callable, lay: Layout, *args) -> None:
    """Run fn(rank, local, lay, *args) in one process per rank of this
    host, and wait for them. SIGINT / SIGTERM go to the host's first rank
    (rank 0 on the first host stops serving and releases the followers).
    A rank that fails ends the others."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=fn, args=(lay.rank(i), i, lay, *args),
                         name=f"rank{lay.rank(i)}")
             for i in range(lay.per_host)]
    for p in procs:
        p.start()

    def forward(signum, _frame):
        if procs[0].pid is not None:
            os.kill(procs[0].pid, signum)

    previous = {s: signal.signal(s, forward)
                for s in (signal.SIGINT, signal.SIGTERM)}
    try:
        failed: Optional[multiprocessing.Process] = None
        while failed is None and any(p.is_alive() for p in procs):
            for p in procs:
                p.join(timeout=1.0)
                if p.exitcode not in (None, 0):
                    failed = p
                    break
        if failed is not None:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            raise RuntimeError(f"{failed.name} exited with {failed.exitcode}")
    finally:
        for s, handler in previous.items():
            signal.signal(s, handler)
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
