"""Checkpointing: atomic, async, keep-k, in the JAX package's format.

Counterpart of ``repro/checkpoint/checkpoint.py``, and the same files
on disk, so a checkpoint either package writes restores in the other:

  * ``<dir>/step_<k>/`` holds one ``<i>.npy`` per leaf and
    ``manifest.json`` with ``keys`` (leaf ``i``'s ``/``-joined dict path,
    JAX's ``_flatten`` order: sorted keys, depth first), ``step``,
    ``metadata`` and ``time``;
  * atomicity: written to ``<dir>/tmp.<step>.<pid>``, the manifest
    fsynced, then renamed to ``step_<k>``; a crash mid-write never
    corrupts the latest checkpoint;
  * async: ``save`` copies the tree to host memory and a writer thread
    drains a depth-1 queue; ``wait`` blocks and re-raises a write error;
  * keep-k: only the latest ``keep`` checkpoints stay.

numpy has no bfloat16. JAX writes a bf16 leaf through ``ml_dtypes``,
whose ``.npy`` header reads ``descr '<V2'``: two raw bytes an element.
The port writes bf16 leaves the same way, the same bytes under the same
header, and reads a ``V2`` leaf back as bf16. Every other leaf is its
numpy dtype.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch

from .. import tree as tr

BF16_DESCR = "<V2"                 # what ml_dtypes' bfloat16 writes


def _flatten(tree):
    """``{"a/b/c": leaf}`` in JAX's ``_flatten`` order."""
    return {"/".join(map(str, path)): leaf for path, leaf in tr.flatten(tree)}


def _to_host(x):
    """A leaf as a numpy array on the host; a bf16 tensor as its raw
    2-byte payloads (dtype ``V2``)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.contiguous().view(torch.int16).numpy().view("V2")
        return x.numpy()
    return np.asarray(x)


def _save_npy(path, a):
    """``np.save``, but a ``V2`` (bf16) array gets JAX's ``'<V2'``
    header (numpy would write ``'|V2'``)."""
    if a.dtype.kind != "V":
        np.save(path, a)
        return
    a = np.ascontiguousarray(a)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": BF16_DESCR, "fortran_order": False,
                "shape": a.shape})
        a.tofile(f)


def _to_tensor(a, device):
    """A restored leaf on ``device``; a ``V2`` array as bf16."""
    a = np.require(a, requirements=["C"])      # keeps a 0-d leaf 0-d
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_write: bool = True):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._err: Optional[BaseException] = None
        self._thread = None
        if async_write:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    # -- public ----------------------------------------------------------

    def save(self, step: int, tree, metadata: Optional[dict] = None,
             block: bool = False):
        """Snapshot to host and enqueue (or write synchronously)."""
        host_tree = tr.map_tree(_to_host, tree)
        if self._thread is None or block:
            self._write(step, host_tree, metadata or {})
        else:
            self.wait()  # keep at most one in flight
            self._q.put((step, host_tree, metadata or {}))

    def wait(self):
        """Block until pending async writes complete; re-raise errors."""
        if self._thread is not None:
            self._q.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self):
        if not os.path.isdir(self.dir):
            return []
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                      if d.startswith("step_"))

    def restore(self, step: Optional[int] = None, template=None,
                shardings=None, device="cpu"):
        """Load a checkpoint. ``template`` (a tree of like-structured
        values) rebuilds the tree, its leaves as tensors on ``device``;
        without it a flat ``{path: numpy array}`` dict is returned (bf16
        leaves as ``V2``, as JAX returns them)."""
        if shardings is not None:
            raise NotImplementedError(
                "restore onto shardings places leaves across devices: it "
                "waits for queue-1 item Multi-device, sub-item 'sharded "
                "training'")
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        flat = {k: np.load(os.path.join(d, f"{i}.npy"))
                for i, k in enumerate(manifest["keys"])}
        meta = manifest.get("metadata", {})
        if template is None:
            return flat, meta
        tflat = _flatten(template)
        missing = [k for k in tflat if k not in flat]
        if missing:
            raise KeyError(f"checkpoint missing leaves: {missing[:5]}...")
        tree = tr.unflatten(template, [_to_tensor(flat[k], device)
                                       for k in tflat])
        return tree, meta

    # -- internals ---------------------------------------------------------

    def _worker(self):
        while True:
            step, tree, meta = self._q.get()
            try:
                self._write(step, tree, meta)
            except BaseException as e:  # surfaced on next wait()
                self._err = e
            finally:
                self._q.task_done()

    def _write(self, step: int, host_tree, metadata: dict):
        flat = _flatten(host_tree)
        tmp = os.path.join(self.dir, f"tmp.{step}.{os.getpid()}")
        os.makedirs(tmp, exist_ok=True)
        keys = list(flat.keys())
        for i, k in enumerate(keys):
            _save_npy(os.path.join(tmp, f"{i}.npy"), np.asarray(flat[k]))
        manifest = {"keys": keys, "step": step, "metadata": metadata,
                    "time": time.time()}
        mpath = os.path.join(tmp, "manifest.json")
        with open(mpath, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)
