"""Process groups, device meshes and rank launching (port of
`vislam_tpu/parallel/mesh.py`).

The reference runs one process over N devices (`shard_map` + `psum`). The
port runs one rank per shard (SPMD): every rank executes the same program
on its own shard, and `torch.distributed` collectives over a process group
do the reductions. A `DeviceMesh` names the axes: "map" (landmarks),
"seq" (sequences), ("host", "map") across processes of several machines.

The backend rule, the same everywhere (`backend_for`), printed by the
callers that start ranks; nothing moves to the CPU unless asked:
- NCCL when every rank has a card of its own (rank r on cuda:r);
- gloo when ranks must share a card: NCCL refuses two ranks on one GPU
  ("Duplicate GPU detected"), so rank r stays on cuda:(r % cards), which
  on a one-card machine is cuda:0 for every rank. Gloo takes CUDA tensors
  for all_reduce, broadcast and barrier only, staged through the host (so
  each such call waits for the stream);
- gloo on the CPU only when the caller asks for device "cpu".

`Ranks` (and `launch`, one call on fresh ranks) is how a single process
(the CLI, chip_smoke.py, the tests) starts N ranks: `torch.multiprocessing`
with the spawn start method, which CUDA needs. The callables it runs must
be top-level functions of an importable module, and their results come
back pickled: return host objects (numpy, CPU tensors, numbers).
"""

from __future__ import annotations

import os
import queue
import socket
import time
import traceback
from datetime import timedelta
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

# Seconds a rendezvous or a collective may wait before it raises.
DEFAULT_TIMEOUT_S = 300


def device_count() -> int:
    """The cards this process sees."""
    return torch.cuda.device_count()


def backend_for(device_type: str, world_size: int) -> str:
    """The backend of `world_size` ranks on `device_type` ("cuda" or
    "cpu"): NCCL when each rank can have a card of its own, else gloo."""
    if device_type == "cpu":
        return "gloo"
    if device_type != "cuda":
        raise ValueError(f"no backend rule for device type {device_type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was requested but CUDA is not available; pass "
                           "device='cpu' to run the ranks on the CPU")
    return "nccl" if device_count() >= world_size else "gloo"


def rank_device(device_type: str, rank: int) -> torch.device:
    """The device of `rank`: the CPU, or card (local rank % cards); the
    local rank is torchrun's LOCAL_RANK where it is set."""
    if device_type == "cpu":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % device_count())


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on `mesh`."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device(mesh.device_type, torch.cuda.current_device())


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device: Optional[str] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
    """Join the process group (idempotent); returns this process' rank.

    coordinator_address is "host:port" of rank 0's rendezvous; missing
    arguments come from VISLAM_COORDINATOR / VISLAM_NUM_PROCESSES /
    VISLAM_PROCESS_ID, else torchrun's MASTER_ADDR (+ MASTER_PORT) /
    WORLD_SIZE / RANK. device "cuda" (the default) or "cpu" picks the
    backend by `backend_for` unless one is given, and selects this rank's
    card before the group exists. A rendezvous or collective that waits
    longer than timeout_s raises.
    """
    if dist.is_initialized():
        return dist.get_rank()
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("VISLAM_COORDINATOR")
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None:
        num_processes = env.get("VISLAM_NUM_PROCESSES", env.get("WORLD_SIZE"))
    if process_id is None:
        process_id = env.get("VISLAM_PROCESS_ID", env.get("RANK"))
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("distributed_init needs a coordinator address, the number of "
                         "processes and this process' id (arguments, VISLAM_* or torchrun's "
                         "environment)")
    num_processes, process_id = int(num_processes), int(process_id)
    device_type = torch.device(device or "cuda").type
    backend = backend or backend_for(device_type, num_processes)
    if device_type == "cuda":
        # Before the group and any DeviceMesh: the mesh keeps a device
        # already selected.
        torch.cuda.set_device(rank_device(device_type, process_id))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=timedelta(seconds=timeout_s))
    return dist.get_rank()


def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("map",),
              shape: Optional[Sequence[int]] = None, device_type: str = "cuda") -> DeviceMesh:
    """A 1-D (default) or N-D mesh over the group's n_devices ranks (all of
    them by default). The single "map" axis shards landmarks; ("seq",
    "map") combines sequence-parallel batches with the sharded BA. Unlike
    the reference, which takes CPU devices when too few accelerators exist,
    a mesh larger than the group raises."""
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"a {n}-rank mesh needs a process group of {n} ranks; this one "
                         f"has {world} (start them with parallel.mesh.launch or torchrun)")
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("shape required for multi-axis meshes")
        shape = (n,)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} does not cover {n} ranks")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axis_names))


def make_global_mesh(axis_names: Sequence[str] = ("host", "map"),
                     local_axis_shape: Optional[Sequence[int]] = None,
                     device_type: str = "cuda") -> DeviceMesh:
    """A mesh over every rank of every machine: the leading "host" axis is
    the machine boundary, the trailing axes its ranks. local_axis_shape
    reshapes the ranks of one machine over the trailing axes (default: one
    axis of torchrun's LOCAL_WORLD_SIZE ranks, else of every rank)."""
    world = dist.get_world_size()
    if len(axis_names) == 1:
        return make_mesh(world, axis_names, device_type=device_type)
    if local_axis_shape is None:
        if len(axis_names) != 2:
            raise ValueError("local_axis_shape required for more than two axes")
        local_axis_shape = (int(os.environ.get("LOCAL_WORLD_SIZE", world)),)
    local = int(np.prod(local_axis_shape))
    if len(local_axis_shape) != len(axis_names) - 1 or world % local:
        raise ValueError(f"local_axis_shape {tuple(local_axis_shape)} must cover each "
                         f"machine's ranks over {len(axis_names) - 1} trailing axes")
    return make_mesh(world, axis_names, (world // local, *local_axis_shape), device_type)


def axis_groups(mesh: DeviceMesh, axis) -> tuple:
    """The process groups of a mesh axis name, or of a tuple of names (a
    sum over them all is a sum over each in turn)."""
    names = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
    return tuple(mesh.get_group(a) for a in names)


def axis_position(mesh: DeviceMesh, axis) -> tuple:
    """(index, size) of this rank along a mesh axis or tuple of axes, the
    leading axis major (the reference's sharding order over a tuple)."""
    names = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
    index, size = 0, 1
    for a in names:
        n = mesh.size(mesh.mesh_dim_names.index(a))
        index, size = index * n + mesh.get_local_rank(a), size * n
    return index, size


def process_shard_range(n_items: int, process_id: Optional[int] = None,
                        process_count: Optional[int] = None):
    """This process' contiguous [lo, hi) slice of n_items sequences or
    keyframes; the remainder goes to the leading processes."""
    live = dist.is_initialized()
    p = (dist.get_rank() if live else 0) if process_id is None else process_id
    c = (dist.get_world_size() if live else 1) if process_count is None else process_count
    base, rem = divmod(n_items, c)
    lo = p * base + min(p, rem)
    return lo, lo + base + (1 if p < rem else 0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve(rank, nprocs, address, backend, device, timeout_s, inbox, outbox):
    """A rank's life: join the group, then run each (fn, args, kwargs) its
    inbox gives it until None, each result or traceback to the outbox."""
    try:
        torch.set_num_threads(1)      # ranks share the host's cores
        distributed_init(address, nprocs, rank, backend=backend, device=device,
                         timeout_s=timeout_s)
        here = rank_device(torch.device(device).type, rank)
        outbox.put((rank, "ok", (dist.get_backend(), str(here))))
    except Exception:      # reported to the parent, which raises it
        outbox.put((rank, "error", traceback.format_exc()))
        return
    try:
        while (task := inbox.get()) is not None:
            fn, args, kwargs = task
            try:
                outbox.put((rank, "ok", fn(*args, **kwargs)))
            except Exception:      # reported to the parent, which raises it
                outbox.put((rank, "error", traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class Ranks:
    """`nprocs` spawned ranks in one process group, each running the
    callables `run` hands them; a context manager that stops them all.

    device "cuda" (the default) or "cpu"; the backend is `backend_for`'s.
    `backend` and `devices` (each rank's) say what was chosen. Any
    rank's failure, or no answer within timeout_s, raises in the caller
    and leaves the ranks unusable (close them).
    """

    def __init__(self, nprocs: int, device: str = "cuda",
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        device_type = torch.device(device).type
        self.backend = backend_for(device_type, nprocs)
        self.timeout_s = timeout_s
        ctx = mp.get_context("spawn")
        self._outbox = ctx.Queue()
        self._inboxes = [ctx.Queue() for _ in range(nprocs)]
        address = f"127.0.0.1:{_free_port()}"
        self._procs = [ctx.Process(target=_serve, daemon=True, args=(
            r, nprocs, address, self.backend, device_type, timeout_s,
            self._inboxes[r], self._outbox)) for r in range(nprocs)]
        self._broken = False
        for p in self._procs:
            p.start()
        try:
            ready = self._collect()
        except BaseException:
            self.close()
            raise
        self.devices = [d for _, d in ready]

    def describe(self) -> str:
        return (f"backend {self.backend}, {len(self._procs)} ranks on "
                f"{', '.join(self.devices)}")

    def run(self, fn, *args, **kwargs) -> list:
        """fn(*args, **kwargs) in every rank; the ranks' results in rank order."""
        if self._broken:
            raise RuntimeError("the ranks failed earlier; start new ones")
        for q in self._inboxes:
            q.put((fn, args, kwargs))
        return self._collect()

    def _collect(self) -> list:
        out, pending = [None] * len(self._procs), set(range(len(self._procs)))
        deadline = time.monotonic() + self.timeout_s
        while pending:
            try:
                rank, kind, value = self._outbox.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r in pending if self._procs[r].exitcode is not None]
                if dead or time.monotonic() > deadline:
                    self._broken = True
                    raise RuntimeError(
                        f"ranks {sorted(dead)} exited without an answer" if dead else
                        f"ranks {sorted(pending)} gave no answer within {self.timeout_s} s")
                continue
            if kind == "error":
                self._broken = True
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
            pending.discard(rank)
        return out

    def close(self) -> None:
        """Stop every rank: a clean exit where they are idle, else terminated."""
        if not self._broken:
            for q in self._inboxes:
                q.put(None)
        for p in self._procs:
            p.join(timeout=0 if self._broken else 30)
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def refine_window_rank(state, cfg, intrinsics, R_bc, device_type: str):
    """One rank's share of the CLI's --dist-ba N on `Ranks`' ranks: the
    state and R_bc arrive as CPU tensors and go to this rank's device, the
    launch counters are set to 0, and `engine/refine.py::
    refine_window_distributed` runs over a "map" mesh of every rank.
    Returns (the new state as CPU tensors, info with host numbers, the
    kernels this refine launched in this rank)."""
    from vislam_tpu_torch.engine.refine import refine_window_distributed
    from vislam_tpu_torch.engine.state import tree_to
    from vislam_tpu_torch.ops import launch_counts, reset_launch_counts

    mesh = make_mesh(device_type=device_type)
    dev = mesh_device(mesh)
    state, R_bc = tree_to(state, dev), tree_to(R_bc, dev)
    reset_launch_counts()
    new, info = refine_window_distributed(state, cfg, *intrinsics, mesh=mesh, R_bc=R_bc)
    launches = launch_counts()
    info = {k: (v.cpu().tolist() if isinstance(v, torch.Tensor) else v)
            for k, v in info.items()}
    return tree_to(new, "cpu"), info, launches


def launch(fn, nprocs: int, args=(), device: str = "cuda",
           timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """fn(*args) on `nprocs` fresh ranks (`Ranks`); their results in rank order."""
    with Ranks(nprocs, device, timeout_s) as ranks:
        return ranks.run(fn, *args)
