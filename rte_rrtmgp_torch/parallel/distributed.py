"""Multi-process bootstrap for the radiation pipeline.

Counterpart of the JAX package's ``parallel/distributed.py``.  Every
process runs the same program: :func:`initialize` joins the process group,
:func:`make_global_mesh` lays the processes out on one (cols, gpt) mesh,
each process passes the column slab it loaded through
:func:`host_shard_columns`, and ``parallel.sharded.sharded_step`` runs the
flagship step.  Each process drives one device (``cuda:{local rank}``, or
the one it is given).

Columns are the zero-communication axis: with every process on ``cols``
(the default mesh) nothing crosses processes inside the step.  A ``gpt``
axis across processes sums the partial broadband fluxes with one
``all_reduce`` over each ``gpt`` group, after the processes of a group have
gathered their column slabs into the group's slab.

The transport: NCCL where each process has a card of its own, gloo on the
CPU and where processes share a card (NCCL refuses two ranks on one
device).  The processes tell each other their cards before the group is
made, so the choice holds on any number of hosts.  The tensors stay on their device either way: gloo all-reduces
CUDA tensors itself, and the slabs it cannot all-gather from a card pass
through the host.

Run each process with the same program::

    python -m rte_rrtmgp_torch.tools.multihost_smoke \\
        --coordinator HOST:PORT --num-processes N --process-id I
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional, Sequence

import numpy as np
import torch

from .. import config
from .mesh import Mesh, Placed, shard_atmosphere, tree_map

_STATE = {"device": None}
TIMEOUT_S = 300   # a collective waiting longer than this fails the process


def _local_device(device, process_id: int):
    """The device this process drives: ``device`` as given, and a bare
    ``cuda`` as ``cuda:{local rank}`` (``LOCAL_RANK``, else the process id,
    modulo the cards present)."""
    dev = config.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", process_id))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def _card_id(dev: torch.device) -> str:
    """Names the physical card ``dev`` is on (its UUID, else host and
    index); "" on the CPU."""
    if dev.type != "cuda":
        return ""
    uuid = getattr(torch.cuda.get_device_properties(dev), "uuid", None)
    return str(uuid) if uuid else f"{socket.gethostname()}/cuda:{dev.index}"


def default_backend(cards: Sequence[str]) -> str:
    """``nccl`` where each process has a card of its own (``cards``: every
    process's :func:`_card_id`, all set and all different), else ``gloo``
    (a process on the CPU, or processes sharing a card: NCCL refuses two
    ranks on one device)."""
    if all(cards) and len(set(cards)) == len(cards):
        return "nccl"
    return "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               device="cuda") -> torch.device:
    """Join the process group; returns this process's device.

    Arguments default to the ``RTE_RRTMGP_COORDINATOR`` / ``_NUM_PROCESSES``
    / ``_PROCESS_ID`` environment variables.  With no coordinator this is a
    single process and no group is made (as JAX runs one where no
    coordinator can be detected).  Otherwise the processes meet at the
    TCP store on ``coordinator_address`` (process 0 serves it), tell each
    other their cards, and ``init_process_group`` takes the backend of
    :func:`default_backend` on what they told; the choice is printed."""
    env = os.environ
    coordinator_address = coordinator_address or env.get(
        "RTE_RRTMGP_COORDINATOR")
    if num_processes is None and "RTE_RRTMGP_NUM_PROCESSES" in env:
        num_processes = int(env["RTE_RRTMGP_NUM_PROCESSES"])
    if process_id is None and "RTE_RRTMGP_PROCESS_ID" in env:
        process_id = int(env["RTE_RRTMGP_PROCESS_ID"])
    if coordinator_address is None:
        _STATE["device"] = _local_device(device, 0)
        return _STATE["device"]
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs num_processes and process_id")
    dev = _local_device(device, process_id)
    host, port = coordinator_address.rsplit(":", 1)
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    store = torch.distributed.TCPStore(host, int(port), num_processes,
                                       is_master=process_id == 0,
                                       timeout=timeout)
    store.set(f"card/{process_id}", _card_id(dev))
    backend = default_backend([store.get(f"card/{r}").decode()
                               for r in range(num_processes)])
    torch.distributed.init_process_group(
        backend, store=store, world_size=num_processes, rank=process_id,
        timeout=timeout)
    _STATE["device"] = dev
    print(f"[distributed] process {process_id} of {num_processes}: backend "
          f"{backend}, device {dev}", flush=True)
    return dev


def is_initialized() -> bool:
    return (torch.distributed.is_available()
            and torch.distributed.is_initialized())


def process_count() -> int:
    return torch.distributed.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return torch.distributed.get_rank() if is_initialized() else 0


def local_device() -> torch.device:
    """The device :func:`initialize` chose (``cuda`` when it was not
    called: raises without a card)."""
    return _STATE["device"] or config.resolve_device(None)


def shutdown() -> None:
    """Leave the process group (a barrier first, so no process leaves
    while another still reduces)."""
    if is_initialized():
        nccl = torch.distributed.get_backend() == "nccl"
        torch.distributed.barrier(
            device_ids=[_STATE["device"].index] if nccl else None)
        torch.distributed.destroy_process_group()
    _STATE["device"] = None


def make_global_mesh(shape: Optional[Sequence[int]] = None,
                     axis_names: Sequence[str] = ("cols", "gpt")) -> Mesh:
    """A mesh over all processes, one position (its device) a process.

    ``shape=None``: a 1-D ``cols`` mesh, the zero-communication layout.
    Processes fill the mesh in rank order, cols-major, so the processes of
    one ``gpt`` group have consecutive ranks and their column slabs make
    the group's slab.  Every process must call this, in the same order:
    it makes the ``torch.distributed`` groups of the mesh's lines."""
    n, rank = process_count(), process_index()
    shape = (n,) if shape is None else tuple(int(s) for s in shape)
    if int(np.prod(shape)) != n:
        raise ValueError(f"a {shape} mesh needs {int(np.prod(shape))} "
                         f"processes, there are {n}")
    ranks = np.arange(n).reshape(shape)
    devices = np.empty(n, dtype=object)
    devices[rank] = local_device()
    mesh = Mesh(devices.reshape(shape), tuple(axis_names)[:len(shape)],
                ranks=ranks, rank=rank)
    if n > 1:
        for ax, name in enumerate(mesh.axis_names):
            lines = np.moveaxis(ranks, ax, -1).reshape(-1, shape[ax])
            for line in lines:
                if len(line) < 2:
                    continue
                group = torch.distributed.new_group([int(r) for r in line])
                if rank in line:
                    mesh.groups[name] = group
    return mesh


def _all_gather_cols(a: torch.Tensor, group, size: int) -> torch.Tensor:
    """The slabs of a group's processes, concatenated in rank order (through
    the host under gloo, which cannot all-gather CUDA tensors)."""
    host = torch.distributed.get_backend(group) != "nccl"
    t = (a.cpu() if host else a).contiguous()
    parts = [torch.empty_like(t) for _ in range(size)]
    torch.distributed.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=0).to(a.device)


def host_shard_columns(mesh: Mesh, tree) -> Placed:
    """Place process-local column slabs on the global mesh.

    Each process passes the (ncol_local, ...) slab it loaded: global
    columns [rank*ncol_local, (rank+1)*ncol_local); the global column count
    is ncol_local times the number of processes.  Each process's slab stays
    on its device.  Where the ``gpt`` axis crosses processes, the processes
    of a ``gpt`` group first gather their slabs into the group's cols slab.
    In one process this is :func:`shard_atmosphere`."""
    if process_count() == 1:
        return shard_atmosphere(mesh, tree)
    group, size = mesh.groups.get("gpt"), mesh.size("gpt")
    dev = mesh.first_device

    def put(a):
        t = torch.as_tensor(a).to(dev)
        return t if group is None else _all_gather_cols(t, group, size)

    parts = np.empty((mesh.size("cols"), size), dtype=object)
    (pos, _), = mesh.local_positions()
    parts[pos] = tree_map(put, tree)
    return Placed(mesh, parts)
