"""Process group and device mesh (port of
``qml_cutensornet_tpu/parallel/mesh.py``).

The reference drives every local device from one controller through a 1-D
``jax.sharding.Mesh``, and more hosts through ``jax.distributed``. The port
runs one process per device instead, the original MPI layout of the system
(one rank per GPU): each rank has its own host thread to feed its card,
which the port's host-bound routes need. The processes form a
``torch.distributed`` group, NCCL for CUDA tensors and gloo for CPU
tensors; a :class:`Mesh` is one rank's place in it, as a ring
(``parallel/gram.py``) or as a site mesh (``parallel/sharded_mps.py``).

Launch with ``torchrun --nproc-per-node N`` (one process per card), or
locally with :func:`launch`. The backend follows the device the caller
names, never what happens to be installed, and nothing falls back: a CUDA
mesh without a card, a failed init or a failed transfer raises.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import pickle
import socket
import tempfile
import time
from typing import ClassVar

import numpy as np
import torch
import torch.distributed as dist

from qml_cutensornet_tpu_torch.utils.device import resolve_device

AXIS = "dp"
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank of a mesh over the process group: ``dp`` rows of ``size``
    ranks, global rank ``rank = row * size + col``. A ring and a 1-D site
    mesh are one row (``dp`` 1, ``size`` the world size). On a 2-D ``(dp,
    sp)`` site mesh (``size`` is ``sp``) the ranks of a row hold the site
    blocks of one share of the batch and talk over ``group``; the ranks of
    a column hold the same sites of the other shares (``batch_group``).
    ``None`` is the default group. A mesh of one needs no process group:
    every transfer and gather on it is the identity. ``AXIS`` reads as the
    reference's mesh."""

    rank: int
    size: int
    device: torch.device
    group: object = None
    dp: int = 1
    batch_group: object = None
    AXIS: ClassVar[str] = AXIS

    @property
    def row(self) -> int:
        return self.rank // self.size

    @property
    def col(self) -> int:
        return self.rank % self.size

    def peer(self, col: int) -> int:
        """Global rank of column ``col`` (modulo ``size``) of this rank's row."""
        return self.row * self.size + col % self.size


def make_site_mesh(sp: int | None = None, dp: int = 1, device: str = "cuda") -> Mesh:
    """This rank's site mesh over the initialized process group: ``dp``
    rows of ``sp`` ranks (``sp`` None: the world size over ``dp``). Outside
    a process group only the mesh of one exists. A 2-D mesh makes one
    process group per row and per column; every rank creates all of them,
    in one order, as ``dist.new_group`` requires."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if dp * (sp or 1) != 1:
            raise RuntimeError(
                f"a ({dp}, {sp}) site mesh needs one process per device: run under torchrun "
                f"--nproc-per-node {dp * (sp or 1)}, or parallel.mesh.launch")
        return Mesh(rank=0, size=1, device=dev)
    _check_backend(dev)
    world, rank = dist.get_world_size(), dist.get_rank()
    sp = world // dp if sp is None else sp
    if dp * sp != world:
        raise ValueError(f"a ({dp}, {sp}) site mesh needs {dp * sp} ranks, but the process "
                         f"group has {world}")
    group = batch_group = None
    if dp > 1:
        for i in range(dp):
            g = dist.new_group([i * sp + j for j in range(sp)])
            if i == rank // sp:
                group = g
        for j in range(sp):
            g = dist.new_group([i * sp + j for i in range(dp)])
            if j == rank % sp:
                batch_group = g
    return Mesh(rank=rank, size=sp, device=dev, group=group, dp=dp, batch_group=batch_group)


def gather_along(t: torch.Tensor, dim: int, n: int, group=None) -> torch.Tensor:
    """The ``n`` ranks' ``t`` of a process group, concatenated along ``dim``
    in rank order on every rank (one ``all_gather``; complex tensors as
    ``view_as_real``). With ``n`` 1 it is ``t`` itself."""
    if n == 1:
        return t
    send = t.contiguous()
    if send.is_complex():
        send = torch.view_as_real(send)
    parts = [torch.empty_like(send) for _ in range(n)]
    dist.all_gather(parts, send, group=group)
    if t.is_complex():
        parts = [torch.view_as_complex(p) for p in parts]
    return torch.cat(parts, dim=dim)


def maybe_distributed_init(device: str = "cuda") -> bool:
    """Initialize the default process group from the ``torchrun``
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``); the counterpart of the reference's
    ``maybe_distributed_init``. ``device`` "cuda" binds ``cuda:LOCAL_RANK``
    and initializes NCCL, "cpu" initializes gloo. Returns whether a group is
    initialized: without ``WORLD_SIZE`` in the environment it does nothing
    and returns False. A failed init raises (the reference swallows it,
    which would hide the card)."""
    if dist.is_initialized():
        _check_backend(torch.device(device))
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    kind = torch.device(device).type
    if kind == "cuda":
        dev = resolve_device(f"cuda:{local}")
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", rank=rank, world_size=world, device_id=dev)
    elif kind == "cpu":
        dist.init_process_group("gloo", rank=rank, world_size=world)
    else:
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return True


def _check_backend(dev: torch.device) -> None:
    backend = dist.get_backend()
    if backend != BACKENDS.get(dev.type):
        raise ValueError(f"the process group runs {backend!r}, but device {dev.type!r} "
                         f"needs {BACKENDS.get(dev.type)!r}")


def make_mesh(n_devices: int | None = None, device: str = "cuda") -> Mesh:
    """This rank's :class:`Mesh` over the initialized process group.
    ``n_devices`` other than the world size raises ``ValueError``, as the
    reference raises when more devices are asked for than exist."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized process group: run one process per device, "
            "e.g. torchrun --nproc-per-node N -m qml_cutensornet_tpu_torch.cli.main ..., "
            "or parallel.mesh.launch")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"Requested {n_devices} devices but the process group has {world} "
                         "ranks (one device each).")
    _check_backend(dev)
    return Mesh(rank=dist.get_rank(), size=world, device=dev)


def process_index() -> int:
    """This process's rank (0 outside a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def to_host(part: torch.Tensor, mesh: Mesh) -> np.ndarray:
    """The full value of a tensor split over the ranks along its last axis
    (the column stripes of a Gram matrix, or per-row values), as numpy on
    every rank: one ``all_gather``, concatenated in rank order. The
    reference's contract (``to_host``): every process gets the whole
    matrix."""
    return np.array(gather_along(part, -1, mesh.size, mesh.group).cpu())  # a copy


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(local_rank: int, fn, world_size: int, device: str, port: int, out_dir: str,
           args: tuple) -> None:
    os.environ.update(RANK=str(local_rank), LOCAL_RANK=str(local_rank),
                      WORLD_SIZE=str(world_size), LOCAL_WORLD_SIZE=str(world_size),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    if "OMP_NUM_THREADS" not in os.environ:
        # The ranks share the host's cores (torchrun sets 1 thread a rank).
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    maybe_distributed_init(device)
    try:
        out = fn(*args)
        if local_rank == 0:
            path = pathlib.Path(out_dir) / "result.pkl"
            tmp = path.with_suffix(".tmp")
            tmp.write_bytes(pickle.dumps(out))
            tmp.replace(path)
    finally:
        dist.destroy_process_group()


def launch(fn, world_size: int, device: str, *args, timeout: float = 900.0):
    """Run ``fn(*args)`` in ``world_size`` local processes, one rank each
    (``torch.multiprocessing``, spawn), inside a process group initialized
    as under ``torchrun`` (the same environment, a free port on 127.0.0.1)
    on ``device`` ("cuda": NCCL, rank r on ``cuda:r``; "cpu": gloo). Returns
    rank 0's result. A rank that raises ends the others and raises here; so
    does ``timeout`` (seconds). ``fn`` must be importable by the spawned
    processes (a module-level function)."""
    port = _free_port()
    with tempfile.TemporaryDirectory(prefix="qmltpu_launch_") as out_dir:
        ctx = torch.multiprocessing.start_processes(
            _child, args=(fn, world_size, device, port, out_dir, args), nprocs=world_size,
            join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(0.1, min(5.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f"launch: {world_size} ranks on {device} did not finish "
                                   f"within {timeout} s")
        return pickle.loads((pathlib.Path(out_dir) / "result.pkl").read_bytes())
