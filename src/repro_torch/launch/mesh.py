"""The device mesh of tensor-parallel serving, as a process group.

Counterpart of ``repro/launch/mesh.py``. JAX builds one ``Mesh`` over
the devices of one process and lets GSPMD place every array on it; the
port runs one process a rank (SPMD, Megatron-style) and joins them into
one ``torch.distributed`` group. The mesh is ``(data=1, model=T)``: T
ranks, one process group, every rank serving the same requests on its
1/T of the heads, the MLP and the vocabulary (``launch/sharding.py``).

* ``init_mesh(tp, device)`` joins the group this process belongs to and
  returns its ``Mesh`` (rank, group, device, backend). Under ``torchrun``
  the rank, world size and rendezvous come from the environment; else
  the caller passes them (the spawn launcher does).
* ``launch(fn, tp, device)`` runs ``fn(mesh, *args)`` on every rank:
  under ``torchrun`` on this process's rank alone, else on T ranks it
  spawns (``torch.multiprocessing``, start method ``spawn``), which meet
  at a ``file://`` rendezvous in a fresh temporary directory (several
  launchers at once, pytest-xdist's workers, never collide on a port).
  A rank that raises makes the launcher kill the others and raise with
  its traceback; a rank that dies, or a group that outlives the
  timeout, does too.
* The backend is chosen from the devices, never by catching an error
  (``choose_backend``): ``nccl`` when each rank owns a card of its own,
  ``gloo`` on the CPU and when the ranks share one card (NCCL refuses
  two ranks on one device). Every rank's group gets an explicit timeout,
  so a rank that dies fails the others' collectives instead of hanging
  them.

``--tp T`` uses exactly T ranks, where JAX's ``make_local_mesh`` shards
one engine over all local devices as ``(n / T, T)``: a data axis above 1
inside one engine (FSDP, or JAX's replicas on submeshes) is not ported
(``make_shard_ctx`` raises naming the sub-item). ``replica_cli_mesh`` and
``submeshes`` raise until that sub-item.

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
from typing import Any

import torch

from ..models.model import resolve_device

# ROADMAP queue 1, item 7 ("Multi-device"): what is left of its sharded
# part, named by the refusals of the options still to come
TP_FAMILIES = "the other families under TP"
SUBMESHES = "replicas on submeshes"
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
        This process's rank in ``group`` (its index on the model axis
        while the data axis is 1).
    group
        The ``torch.distributed`` process group of the mesh's ranks
        (None for a mesh that only describes a shape).
    device : torch.device
        This rank's device.
    backend : str
        ``"nccl"`` or ``"gloo"`` (``choose_backend``).
    """

    shape: dict
    rank: int = 0
    group: Any = None
    device: torch.device = torch.device("cpu")
    backend: str = "gloo"

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


def init_mesh(tp: int, device="cuda", *, rank=None, init_method=None,
              backend=None, timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """Join this process's ``tp``-rank group and return its ``Mesh``.

    Under ``torchrun`` the rank and the rendezvous come from the
    environment (its world size must be ``tp``); otherwise pass ``rank``
    and ``init_method``. ``backend`` None chooses by ``choose_backend``.
    A CUDA device on a machine without one raises before any group is
    joined."""
    if tp < 1:
        raise ValueError(f"--tp {tp} must be >= 1")
    device = resolve_device(device)
    if rank is None:
        if not in_torchrun():
            raise ValueError("init_mesh outside torchrun needs rank= and "
                             "init_method= (launch() passes them)")
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
        if world != tp:
            raise ValueError(f"torchrun started {world} ranks for --tp {tp}")
        init_method = "env://"
    backend = backend or choose_backend(device, tp)
    dev = _rank_device(device, rank, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.distributed.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=tp,
        timeout=datetime.timedelta(seconds=timeout_s))
    return Mesh({"data": 1, "model": tp}, rank,
                torch.distributed.group.WORLD, dev, backend)


def _rank_main(fn, rank, tp, device, backend, init_method, timeout_s, args,
               results):
    """A spawned rank: join the group, run ``fn``, send back
    ``(rank, ok, result or traceback)``, then leave the group (the
    result goes first: the launcher stops a rank that lingers after).
    The spawned ranks share this host, so NCCL's bootstrap goes over
    the loopback interface unless the environment names another."""
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    try:
        mesh = init_mesh(tp, device, rank=rank, init_method=init_method,
                         backend=backend, timeout_s=timeout_s)
        out = fn(mesh, *args)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))
    torch.distributed.destroy_process_group()


def launch(fn, tp: int, device="cuda", *, args=(), backend=None,
           timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``fn(mesh, *args)`` on each rank of a ``tp``-rank group and
    return the results by rank.

    Under ``torchrun`` this process is one rank: ``fn`` runs here and the
    list holds its result alone. Otherwise T ranks are spawned; ``fn``
    (a module-level function) and ``args`` are pickled to them and each
    result pickled back. A rank that raises or dies makes the launcher
    terminate the others and raise RuntimeError with its traceback;
    ranks still running after ``timeout_s`` are terminated and
    TimeoutError raised."""
    device = resolve_device(device)
    if in_torchrun():
        mesh = init_mesh(tp, device, backend=backend, timeout_s=timeout_s)
        out = fn(mesh, *args)
        torch.distributed.destroy_process_group()
        return [out]
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, name=f"tp-rank-{r}",
                             args=(fn, r, tp, str(device), backend,
                                   init_method, timeout_s, args, results))
                 for r in range(tp)]
        for p in procs:
            p.start()
        try:
            return _collect(procs, results, tp, timeout_s)
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
    """The mesh of a ``--dp R --tp T`` request: replicas on (1, T)
    submeshes. Not ported."""
    raise not_ported(f"--dp {dp} with --tp {tp} (replicas on submeshes)",
                     SUBMESHES)


def submeshes(mesh, dp: int, axis: str = "data") -> list:
    """Split ``mesh`` into ``dp`` submeshes along ``axis``. Not ported."""
    raise not_ported("submeshes of a mesh", SUBMESHES)


def mesh_summary(mesh) -> dict:
    return {"axes": {a: int(s) for a, s in mesh.shape.items()},
            "n_devices": mesh.size, "rank": mesh.rank,
            "backend": mesh.backend, "device": str(mesh.device)}
