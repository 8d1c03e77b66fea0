"""The device mesh of tensor-parallel serving, as a process group.

Counterpart of ``repro/launch/mesh.py``. JAX builds one ``Mesh`` over
the devices of one process and lets GSPMD place every array on it; the
port runs one process a rank (SPMD, Megatron-style) and joins them into
``torch.distributed`` groups. The mesh is ``(data=R, model=T)``: R x T
ranks ranked row-major (``Mesh.coord``), R replicas of one engine each
over T ranks. With R = 1 (``--tp T``) the T ranks are one group, every
rank serving the same requests on its 1/T of the heads, the MLP and the
vocabulary (``launch/sharding.py``). With R > 1 (``--dp R --tp T``) the
world group carries the router's exchange (``ReplicaSet(mesh=)``) and
each replica's T ranks have a model-axis subgroup of their own, which
its engine's collectives run over (``submeshes``).

* ``init_mesh(tp, device, dp=R)`` joins the groups this process belongs
  to and returns its ``Mesh`` (rank, group, device, backend, and under
  R > 1 its replica's subgroup). Every rank creates the R subgroups in
  the same order, then the payload group that KV packets move over
  between replicas (``Mesh.payload_group``). Under ``torchrun`` the rank,
  world size and rendezvous come from the environment; else the caller
  passes them (the spawn launcher does).
* ``launch(fn, tp, device, dp=R)`` runs ``fn(mesh, *args)`` on every
  rank: under ``torchrun`` on this process's rank alone, else on R x T
  ranks it spawns (``torch.multiprocessing``, start method ``spawn``),
  which meet at a ``file://`` rendezvous in a fresh temporary directory
  (several launchers at once, pytest-xdist's workers, never collide on a
  port). A rank that raises makes the launcher kill the others and raise
  with its traceback; a rank that dies, or a group that outlives the
  timeout, does too.
* The backend is chosen from the devices, never by catching an error
  (``choose_backend``): ``nccl`` when each rank owns a card of its own,
  ``gloo`` on the CPU and when ranks share one card (NCCL refuses two
  ranks on one device). With R > 1 that choice is the replicas'
  subgroups'; the world group, which carries host data only (the
  router's exchange), is gloo. A KV packet moving between two replicas
  goes rank t to rank t over the payload group: the world group itself
  under gloo (a CUDA payload staged through pinned host memory, since
  gloo's ``send`` / ``recv`` take CPU tensors only), a world-sized NCCL
  group when each rank owns a card. Every group gets an explicit
  timeout, so a rank that dies fails the others' collectives instead of
  hanging them.

``--tp T`` uses exactly T ranks, where JAX's ``make_local_mesh`` shards
one engine over all local devices as ``(n / T, T)``: a data axis above 1
inside one engine (FSDP, or JAX's slots sharded over ``data``) is not
ported (``sharding.layout_ctx`` raises naming the sub-item).
``submeshes`` cuts a mesh into its replicas' ``(1, T)`` submeshes;
``replica_cli_mesh`` gives the shape ``--dp R --tp T`` asks for.

Importing this module starts no process and touches no device.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Optional

import torch

from ..models.model import resolve_device

# ROADMAP queue 1, item 7 ("Multi-device"): what is left of its sharded
# part, named by the refusals of the options still to come
TP_FAMILIES = "the other families under TP"
SHARDED_TRAINING = "sharded training"

DEFAULT_TIMEOUT_S = 600.0


def not_ported(what: str, sub_item: str) -> NotImplementedError:
    """The refusal of an option of the multi-device item still to come,
    naming its sub-item."""
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1, item 7 "
        f"'multi-device', sub-item {sub_item!r})")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the ``(data, model)`` mesh.

    Attributes
    ----------
    shape : dict
        Axis name -> size, in axis order (JAX's ``mesh.shape``).
    rank : int
        This process's rank in ``group``, row-major over the axes
        (``coord``): on a ``(1, T)`` mesh its index on the model axis.
    group
        The ``torch.distributed`` process group of the mesh's ranks
        (None for a mesh that only describes a shape).
    device : torch.device
        This rank's device.
    backend : str
        ``"nccl"`` or ``"gloo"``: ``group``'s (``choose_backend``; gloo
        for the world group of a mesh whose data axis is above 1).
    model_group
        Under a data axis above 1: the model-axis subgroup of this rank's
        replica (its ``submeshes`` entry's group), else None.
    model_backend : str or None
        ``model_group``'s backend.
    payload_group
        The group KV packets move over between replicas (rank t of one
        replica to rank t of another): the world group under gloo, a
        world-sized NCCL group when each rank owns a card; under a data
        axis of 1 the mesh's group.
    payload_backend : str or None
        ``payload_group``'s backend.
    """

    shape: dict
    rank: int = 0
    group: Any = None
    device: torch.device = torch.device("cpu")
    backend: str = "gloo"
    model_group: Any = None
    model_backend: Optional[str] = None
    payload_group: Any = None
    payload_backend: Optional[str] = None

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= int(s)
        return n

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis`` (ranks row-major over the
        axes, the last varying fastest)."""
        stride = 1
        for name in reversed(self.axis_names):
            if name == axis:
                return (self.rank // stride) % int(self.shape[name])
            stride *= int(self.shape[name])
        raise ValueError(f"mesh has no {axis!r} axis: {self.axis_names}")


def choose_backend(device, tp: int) -> str:
    """``nccl`` when every one of the ``tp`` ranks can own a card of its
    own, else ``gloo`` (the CPU, and ranks sharing one card)."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= tp:
        return "nccl"
    return "gloo"


def _rank_device(device: torch.device, rank: int, backend: str):
    if device.type != "cuda":
        return device
    if backend == "nccl":
        return torch.device("cuda", rank)
    return torch.device("cuda", device.index or 0)


def in_torchrun() -> bool:
    """True in a process that ``torchrun`` started (it sets the rank and
    the rendezvous in the environment)."""
    return "TORCHELASTIC_RUN_ID" in os.environ and "RANK" in os.environ


def init_mesh(tp: int, device="cuda", *, dp: int = 1, rank=None,
              init_method=None, backend=None,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """Join this process's groups of a ``(data=dp, model=tp)`` mesh and
    return its ``Mesh``.

    Under ``torchrun`` the rank and the rendezvous come from the
    environment (its world size must be ``dp * tp``); otherwise pass
    ``rank`` and ``init_method``. ``backend`` None chooses by
    ``choose_backend`` over the ``dp * tp`` ranks: the group's with
    ``dp`` 1, else the replicas' model-axis subgroups' (the world group
    is gloo then, and the payload group the world group under gloo, a
    world-sized NCCL group under nccl). A CUDA device on a machine
    without one raises before any group is joined."""
    if tp < 1:
        raise ValueError(f"--tp {tp} must be >= 1")
    if dp < 1:
        raise ValueError(f"--dp {dp} must be >= 1")
    world = dp * tp
    device = resolve_device(device)
    if rank is None:
        if not in_torchrun():
            raise ValueError("init_mesh outside torchrun needs rank= and "
                             "init_method= (launch() passes them)")
        rank = int(os.environ["RANK"])
        if int(os.environ["WORLD_SIZE"]) != world:
            raise ValueError(f"torchrun started {os.environ['WORLD_SIZE']} "
                             f"ranks for --dp {dp} --tp {tp}")
        init_method = "env://"
    backend = backend or choose_backend(device, world)
    dev = _rank_device(device, rank, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=timeout_s)
    torch.distributed.init_process_group(
        backend if dp == 1 else "gloo", init_method=init_method, rank=rank,
        world_size=world, timeout=timeout)
    shape = {"data": dp, "model": tp}
    world_group = torch.distributed.group.WORLD
    if dp == 1:
        return Mesh(shape, rank, world_group, dev, backend,
                    payload_group=world_group, payload_backend=backend)
    own = None
    for r in range(dp):             # every rank, in the same order
        g = torch.distributed.new_group(list(range(r * tp, (r + 1) * tp)),
                                        timeout=timeout, backend=backend)
        if r == rank // tp:
            own = g
    payload = world_group if backend == "gloo" else \
        torch.distributed.new_group(list(range(world)), timeout=timeout,
                                    backend=backend)
    return Mesh(shape, rank, world_group, dev, "gloo", model_group=own,
                model_backend=backend, payload_group=payload,
                payload_backend=backend)


def _rank_main(fn, rank, tp, dp, device, backend, init_method, timeout_s,
               args, results):
    """A spawned rank: join the group, run ``fn``, send back
    ``(rank, ok, result or traceback)``, then leave the group (the
    result goes first: the launcher stops a rank that lingers after).
    The spawned ranks share this host, so NCCL's bootstrap goes over
    the loopback interface unless the environment names another."""
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    try:
        mesh = init_mesh(tp, device, dp=dp, rank=rank,
                         init_method=init_method, backend=backend,
                         timeout_s=timeout_s)
        out = fn(mesh, *args)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))
    torch.distributed.destroy_process_group()


def launch(fn, tp: int, device="cuda", *, dp: int = 1, args=(),
           backend=None, timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``fn(mesh, *args)`` on each rank of a ``(data=dp, model=tp)``
    mesh and return the results by rank.

    Under ``torchrun`` this process is one rank: ``fn`` runs here and the
    list holds its result alone. Otherwise dp x tp ranks are spawned; ``fn``
    (a module-level function) and ``args`` are pickled to them and each
    result pickled back. A rank that raises or dies makes the launcher
    terminate the others and raise RuntimeError with its traceback;
    ranks still running after ``timeout_s`` are terminated and
    TimeoutError raised."""
    device = resolve_device(device)
    if in_torchrun():
        mesh = init_mesh(tp, device, dp=dp, backend=backend,
                         timeout_s=timeout_s)
        out = fn(mesh, *args)
        torch.distributed.destroy_process_group()
        return [out]
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, name=f"tp-rank-{r}",
                             args=(fn, r, tp, dp, str(device), backend,
                                   init_method, timeout_s, args, results))
                 for r in range(dp * tp)]
        for p in procs:
            p.start()
        try:
            return _collect(procs, results, dp * tp, timeout_s)
        except BaseException:
            for p in procs:           # a rank failed: stop the others now
                if p.is_alive():
                    p.terminate()
            raise
        finally:
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()


def _collect(procs, results, tp, timeout_s):
    """Read every rank's message; raise on the first failure."""
    out = {}
    deadline = time.monotonic() + timeout_s
    while len(out) < tp:
        try:
            rank, ok, val = results.get(timeout=0.5)
        except queue.Empty:
            dead = [p for p in procs if p.exitcode not in (None, 0)]
            if dead:
                try:          # its traceback may still be in the pipe
                    rank, ok, val = results.get(timeout=2.0)
                except queue.Empty:
                    raise RuntimeError(
                        f"{dead[0].name} died with exit code "
                        f"{dead[0].exitcode}") from None
            elif time.monotonic() > deadline:
                raise TimeoutError(
                    f"tp ranks still running after {timeout_s} s "
                    f"(done: {sorted(out)})")
            else:
                continue
        if not ok:
            raise RuntimeError(f"tp rank {rank} raised:\n{val}")
        out[rank] = val
    return [out[r] for r in range(tp)]


def dp_axes_of(mesh) -> tuple:
    """All non-model axes, in mesh order."""
    return tuple(a for a in mesh.axis_names if a != "model")


def replica_cli_mesh(dp: int, tp: int):
    """The mesh shape a ``--dp R --tp T`` request means (a ``Mesh`` that
    only describes it; ``launch(fn, T, device, dp=R)`` builds the ranks):
    ``(data=R, model=T)``, each replica on a ``(1, T)`` submesh; ``--tp
    T`` alone ``(1, T)`` (exactly T ranks: see the module docstring);
    None for no parallelism and for replicas on one device (``tp`` 1:
    ``ReplicaSet(dp=R)`` in one process). Ranks may share a card (gloo,
    ``choose_backend``), so no device count limits the shape."""
    if tp < 1:
        raise ValueError(f"--tp {tp} must be >= 1")
    if dp < 1:
        raise ValueError(f"--dp {dp} must be >= 1")
    if tp == 1:
        return None
    return Mesh({"data": dp, "model": tp})


def submeshes(mesh, dp: int, axis: str = "data") -> list:
    """Split ``mesh`` into ``dp`` contiguous submeshes along ``axis``, as
    JAX's: each keeps every axis name, ``axis`` shrunk to size / dp, so
    replica r serves the r-th slice of the data axis on its own
    model-axis subgrid. Only this rank's submesh carries a group (its
    replica's model-axis subgroup, ``Mesh.model_group``; the mesh's own
    group when ``dp`` is 1) and its rank within it; the others describe
    a shape. Raises JAX's ValueError when ``axis`` is missing or ``dp``
    does not divide it."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no {axis!r} axis: {mesh.axis_names}")
    size = int(mesh.shape[axis])
    if dp < 1 or size % dp != 0:
        raise ValueError(
            f"--dp {dp} must be >= 1 and divide the {axis!r} axis "
            f"({size})")
    per = size // dp
    own = mesh.coord(axis) // per
    shape = dict(mesh.shape, **{axis: per})
    backend = mesh.model_backend or mesh.backend
    if dp == 1:
        group = mesh.group
    else:
        group = mesh.model_group if per == 1 else None
    rank = 0
    for a in mesh.axis_names:      # row-major within the submesh
        c = mesh.coord(a) - (own * per if a == axis else 0)
        rank = rank * int(shape[a]) + c
    return [Mesh(shape, rank, group, mesh.device, backend) if r == own
            else Mesh(dict(shape), backend=backend) for r in range(dp)]


def mesh_summary(mesh) -> dict:
    return {"axes": {a: int(s) for a, s in mesh.shape.items()},
            "n_devices": mesh.size, "rank": mesh.rank,
            "backend": mesh.backend, "device": str(mesh.device)}
