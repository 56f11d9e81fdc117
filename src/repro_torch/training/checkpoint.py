"""Async, atomic checkpoints in the JAX package's on-disk format (the port
of ``repro.training.checkpoint``).

Layout on disk (one directory per step), as the reference writes it:
    step_00000100/
      manifest.msgpack     {"step", "leaves": [{"key", "file", "shape",
                           "dtype"}, ...]}
      leaf_00000.npy       one file per leaf (the whole array)

A leaf's key is its tree path as the reference's ``_flatten`` prints it
(dict keys sorted, a NamedTuple field as ``.name``, a tuple entry as its
index, ``None`` skipped: ``o/.m/cycles/s0_attn/attn/bk``).  bf16 leaves
are stored as a ``uint8`` view with dtype ``"bfloat16"`` in the manifest.
So either package restores the other's checkpoints.

  * **Async**: ``save()`` copies the leaves to host memory synchronously
    and writes the files on a background thread, one write in flight.
  * **Atomic**: a write goes to ``<dir>.tmp`` and is renamed; a crashed
    writer never corrupts the latest checkpoint, and ``latest_step()``
    scans only committed directories.  ``keep`` bounds how many stay.
  * **Restore** rebuilds a ``like`` tree (tensors; ``meta`` tensors carry
    only shapes and dtypes) on any device, checking each leaf's shape.
  * **Elastic** (as the reference's ``restore(step, like, shardings=)``):
    a tree of ``DTensor``s (the sharded train step's state) is saved whole,
    each leaf's ``full_tensor()`` (a collective: every rank of the mesh
    calls ``save``) written by rank 0 alone, in the same format; and
    ``restore(..., mesh=, shardings=)`` returns ``DTensor``s on any mesh,
    each rank reading its block of every leaf.  So a checkpoint written on
    one mesh restores onto another, or onto one device, and into and out
    of the JAX package.
"""
from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.relational.table import resolve_device
from repro_torch.training import msgpack_codec
from repro_torch.training.tree import flatten, flatten_up_to, unflatten

_MANIFEST = "manifest.msgpack"


def _key(path) -> str:
    return "/".join(path)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _to_storage(t: torch.Tensor) -> np.ndarray:
    """A host copy that ``np.save`` takes: bf16 as its bytes (``uint8``,
    the last axis twice as long), as the reference stores it."""
    t = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return (t.view(torch.uint8) if t.ndim else
                t.reshape(1).view(torch.uint8)).numpy()
    return t.numpy()


def _from_storage(raw: np.ndarray, dtype_str: str, shape) -> torch.Tensor:
    if dtype_str == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(raw)).view(
            torch.bfloat16).reshape(shape)
    return torch.from_numpy(raw.astype(np.dtype(dtype_str), copy=False)
                            .reshape(shape))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree, blocking: bool = False):
        """Snapshot now; write in the background (unless blocking).  A tree
        of ``DTensor``s is snapshot whole, one leaf at a time, on every
        rank of its mesh (each must call ``save``), and written by rank 0
        alone; ``blocking`` then ends in a barrier, so that every rank can
        restore it on return."""
        import torch.distributed as dist

        items = flatten(tree)
        sharded = any(_is_dtensor(leaf) for _, leaf in items)
        writer = not sharded or dist.get_rank() == 0
        host_items = []
        for path, leaf in items:
            if _is_dtensor(leaf):
                leaf = leaf.full_tensor()
            if writer:
                host_items.append((_key(path), _to_storage(leaf),
                                   _dtype_name(leaf.dtype),
                                   list(leaf.shape)))
            del leaf
        if writer:
            self.wait()  # one in-flight write at a time
            worker = threading.Thread(
                target=self._write, args=(step, host_items), daemon=True)
            worker.start()
            self._thread = worker
            if blocking:
                self.wait()
        if sharded and blocking:
            dist.barrier()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host_items):
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": []}
        for i, (key, arr, dtype, shape) in enumerate(host_items):
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"].append(
                {"key": key, "file": fname, "shape": shape, "dtype": dtype})
        with open(os.path.join(tmp, _MANIFEST), "wb") as f:
            f.write(msgpack_codec.packb(manifest))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like, device=None, mesh=None,
                shardings=None):
        """Rebuild the ``like``-structured tree from checkpoint ``step`` on
        ``device`` (``None`` means the CUDA card), each leaf cast to its
        ``like`` leaf's dtype.  A leaf missing from the checkpoint raises
        ``KeyError``, one of another shape ``ValueError``.

        ``shardings`` (a tree of placements with ``like``'s structure, as
        ``params_shardings`` gives them; ``()`` for a 0-d leaf) and
        ``mesh``: each leaf is a ``DTensor`` on ``mesh`` holding this
        rank's block, on ``device`` (``None``: the mesh's device type)."""
        if shardings is not None:
            if mesh is None:
                raise ValueError("restore: shardings need their mesh")
            if device is None:
                device = _mesh_device(mesh)
        device = resolve_device(device)
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, _MANIFEST), "rb") as f:
            manifest = msgpack_codec.unpackb(f.read())
        by_key: Dict[str, dict] = {leaf["key"]: leaf
                                   for leaf in manifest["leaves"]}
        specs = (flatten_up_to(like, shardings) if shardings is not None
                 else [None] * len(flatten(like)))
        out = []
        for (path, ref), spec in zip(flatten(like), specs):
            key = _key(path)
            if key not in by_key:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            leaf = by_key[key]
            shape = tuple(leaf["shape"])
            if shape != tuple(ref.shape):
                raise ValueError(
                    f"{key}: checkpoint shape {shape} != {tuple(ref.shape)}")
            raw = np.load(os.path.join(d, leaf["file"]))
            t = _from_storage(raw, leaf["dtype"], shape)
            if spec is not None:
                out.append(_block(t, spec, mesh, device, ref.dtype))
            else:
                out.append(t.to(device=device, dtype=ref.dtype))
        return unflatten(like, out)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _mesh_device(mesh) -> torch.device:
    """The device of this rank's blocks on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _block(whole: torch.Tensor, spec, mesh, device, dtype):
    """This rank's block of ``whole`` under ``spec``, as a ``DTensor`` on
    ``mesh`` (its own memory on ``device``)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.sharding import narrow_to, placements

    spec = tuple(spec) + (None,) * (whole.dim() - len(spec))
    block = narrow_to(whole, (None,) * whole.dim(), spec, mesh)
    block = block.to(device=device, dtype=dtype, copy=True).contiguous()
    return DTensor.from_local(block, mesh, placements(spec, mesh),
                              run_check=False)
