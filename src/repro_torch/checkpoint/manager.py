"""Atomic, async checkpointing with retention and auto-resume (from
``repro.checkpoint.manager``), on the reference's on-disk layout::

    <dir>/step_00000420/          # atomic: written as .tmp_, renamed when done
        manifest.json             # paths, shapes, dtypes
        leaf_00000.npy ...        # one file per tree leaf

Trees are nested dicts of tensors, flattened in sorted key order with
paths in JAX's ``keystr`` form (``['params']['layers']['attn']['wq']``),
the order in which ``jax.tree_util`` flattens the same dict, so leaf *i*
is the same leaf in both packages and each reads the other's checkpoints.
bfloat16 leaves are stored as float32 (a lossless upcast) and come back
in the manifest's dtype.  ``save_async`` copies every leaf to host memory
before it returns (the training step updates its tensors in place) and
writes on a background thread.  ``restore`` puts each leaf on the target
leaf's device, in its dtype, with its ``requires_grad``.

Checkpoints are mesh-agnostic, which is the elastic path: a DTensor leaf
is saved as its full logical array (``full_tensor``, so every rank of
its mesh calls ``save``; global rank 0 writes and the others wait at a
barrier), and ``restore`` takes a target tree of
``parallel.sharding.Sharding`` (or of DTensors) as well as of tensors, and
distributes each full array onto the target's mesh, which may have
another size or layout than the one that saved it.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, List, Optional

import numpy as np
import torch

from ..models.common import tree_paths, tree_unflatten

__all__ = ["CheckpointManager"]

_STEP_RE = re.compile(r"^step_(\d{8})$")
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16, "float64": torch.float64,
                 "int32": torch.int32, "int64": torch.int64,
                 "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool}
_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def _distributed(leaf) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(leaf, DTensor)


def _to_host(leaf) -> tuple:
    """(dtype name, numpy copy) of a tensor or array leaf; a DTensor's full
    logical array (a collective over its mesh)."""
    if _distributed(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        name = _NAMES[t.dtype]
        if t.dtype == torch.bfloat16:  # no portable npy form: store as f32
            t = t.float()
        return name, t.numpy()
    arr = np.array(leaf, copy=True)
    return str(arr.dtype), arr


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._barrier = False  # the pending save has DTensor leaves

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any) -> str:
        self.wait()
        host, writer = self._snapshot(tree)
        path = (self._write(step, host) if writer else
                os.path.join(self.dir, f"step_{step:08d}"))
        self.wait()
        return path

    def save_async(self, step: int, tree: Any) -> None:
        self.wait()
        host, writer = self._snapshot(tree)  # copied now; written later
        if writer:
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Until the last save is on disk (on every rank, for a tree with
        DTensor leaves)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            self._barrier = False
            torch.distributed.barrier()

    def _snapshot(self, tree: Any) -> tuple:
        """(host copies of the leaves, whether this rank writes them)."""
        paths = tree_paths(tree)
        self._barrier = any(_distributed(leaf) for _, leaf in paths)
        host = [(path,) + _to_host(leaf) for path, leaf in paths]
        return host, not self._barrier or torch.distributed.get_rank() == 0

    def _write(self, step: int, host: list) -> str:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp_"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {
            "step": step,
            "treedef": None,
            "paths": [path for path, _, _ in host],
            "n_leaves": len(host),
            "shapes": [list(arr.shape) for _, _, arr in host],
            "dtypes": [name for _, name, _ in host],
        }
        for i, (_, _, arr) in enumerate(host):
            np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        self._retain()
        return final

    def _retain(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target: Any) -> Any:
        """A tree shaped like ``target`` holding the checkpoint's leaves:
        for a tensor leaf on its device, in its dtype; for a ``Sharding``
        a DTensor on its mesh in the saved dtype; for a DTensor one with
        its mesh, placements and dtype."""
        from torch.distributed.tensor import distribute_tensor

        from ..parallel.sharding import Sharding

        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        targets = tree_paths(target)
        if manifest["n_leaves"] != len(targets):
            raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                             f"target {len(targets)}")
        out = []
        for i, (tpath, tgt) in enumerate(targets):
            arr = np.load(os.path.join(path, f"leaf_{i:05d}.npy"))
            saved = _TORCH_DTYPES[manifest["dtypes"][i]]
            if isinstance(tgt, Sharding):
                t = torch.from_numpy(arr).to(saved)
                out.append(tgt.distribute(t.to(
                    tgt.mesh.device_mesh.device_type)))
                continue
            if tuple(arr.shape) != tuple(tgt.shape):
                raise ValueError(f"leaf {i} {tpath}: checkpoint "
                                 f"{arr.shape} vs target {tuple(tgt.shape)}")
            t = torch.from_numpy(arr).to(saved)
            if _distributed(tgt):
                mesh = tgt.device_mesh
                t = distribute_tensor(t.to(device=mesh.device_type,
                                           dtype=tgt.dtype), mesh,
                                      tgt.placements, src_data_rank=None)
            else:
                t = t.to(device=tgt.device, dtype=tgt.dtype)
            out.append(t.requires_grad_(tgt.requires_grad))
        return tree_unflatten(target, out)
