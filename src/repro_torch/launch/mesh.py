"""Process groups of the data-parallel world (the counterpart of
``repro.launch.mesh``).

The reference lays its workers out as a row-major ``("pod", "data")`` mesh:
device rank ``r`` sits in pod ``r // W_intra`` at intra-pod index ``r %
W_intra``.  Here the same layout is cut out of the ``torch.distributed``
world: one intra-pod group per pod (the fast link, NVLink inside a node) and
one cross-pod group per intra-pod index (the ranks that own the same shard,
across the network between nodes).

    python -m torch.distributed.run --nproc-per-node 4 -m repro_torch.launch.train \\
        --pods 2 --pod-interval 2 ...

starts one process per GPU; :func:`init_from_env` joins them into the
default group and :func:`build_groups` cuts it into pods.
"""
from __future__ import annotations

import dataclasses
import os
import socket

import torch
import torch.distributed as dist

from ..device import resolve_device


def pod_rank_lists(world: int, n_pods: int) -> tuple[list[list[int]], list[list[int]]]:
    """``(intra, cross)`` rank lists of a ``world`` cut into ``n_pods`` pods,
    row-major: ``intra[p]`` holds pod ``p``'s ranks, ``cross[i]`` the ranks
    at intra-pod index ``i`` of every pod.  Raises when the world does not
    split into ``n_pods`` equal pods."""
    if n_pods < 1 or world % n_pods:
        raise ValueError(f"a world of {world} ranks does not split into "
                         f"{n_pods} equal pods")
    k = world // n_pods
    intra = [list(range(p * k, (p + 1) * k)) for p in range(n_pods)]
    cross = [[p * k + i for p in range(n_pods)] for i in range(k)]
    return intra, cross


@dataclasses.dataclass(frozen=True)
class DPGroups:
    """This rank's groups: ``world`` (every data-parallel rank), ``intra``
    (its pod; the world itself with one pod) and ``cross`` (the ranks of
    the other pods at its intra-pod index; ``None`` with one pod)."""

    world: object
    intra: object
    cross: object | None
    n_pods: int
    rank: int
    world_size: int

    @property
    def intra_size(self) -> int:
        return self.world_size // self.n_pods

    @property
    def pod(self) -> int:
        return self.rank // self.intra_size


def build_groups(n_pods: int = 1) -> DPGroups:
    """Cut the default ``torch.distributed`` world into ``n_pods`` pods.
    Every rank creates every group, as ``dist.new_group`` requires."""
    if not dist.is_initialized():
        raise RuntimeError("build_groups needs an initialised default process group")
    world, rank = dist.get_world_size(), dist.get_rank()
    intra_lists, cross_lists = pod_rank_lists(world, n_pods)
    if n_pods == 1:
        return DPGroups(dist.group.WORLD, dist.group.WORLD, None, 1, rank, world)
    intra = cross = None
    for ranks in intra_lists:
        g = dist.new_group(ranks)
        if rank in ranks:
            intra = g
    for ranks in cross_lists:
        g = dist.new_group(ranks)
        if rank in ranks:
            cross = g
    return DPGroups(dist.group.WORLD, intra, cross, n_pods, rank, world)


def launched() -> bool:
    """True when the process was started by ``torch.distributed.run`` (its
    ``RANK`` / ``WORLD_SIZE`` environment is set)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_from_env(device: str = "cuda") -> torch.device:
    """Join the default process group from ``torch.distributed.run``'s
    environment: NCCL on ``cuda:LOCAL_RANK``, or gloo when ``device`` is
    the CPU.  Returns this rank's device.  Raises when CUDA is asked for
    and there is none: there is no move to the CPU on its own."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")
    return dev


def free_port() -> int:
    """A free TCP port on localhost, for a ``tcp://127.0.0.1`` rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(worker, world: int, device: str, out: str, *args) -> None:
    """``worker(rank, world, init, out, device, *args)`` on ``world``
    spawned ranks, which join with :func:`join_spawned`: gloo processes on
    the CPU (a ``file://`` rendezvous beside ``out``), one NCCL rank a card
    otherwise (raises when the host has fewer cards)."""
    if device != "cpu":
        resolve_device(device)
        if torch.cuda.device_count() < world:
            raise SystemExit(f"{world} ranks need {world} cards, this host has "
                             f"{torch.cuda.device_count()}; pass --device cpu for "
                             "gloo processes")
    init = (f"file://{os.path.join(os.path.dirname(out), 'init')}" if device == "cpu"
            else f"tcp://127.0.0.1:{free_port()}")
    torch.multiprocessing.spawn(worker, args=(world, init, out, device, *args),
                                nprocs=world, start_method="spawn")


def join_spawned(rank: int, world: int, init: str, device: str) -> str:
    """Join a rank of :func:`spawn_ranks` to the default group: gloo on one
    thread on the CPU, NCCL on ``cuda:<rank>`` otherwise.  -> its device."""
    if device == "cpu":
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
        return "cpu"
    device = f"cuda:{rank}"
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", init_method=init, world_size=world, rank=rank)
    return device
