"""Checkpointing: JSON manifest + per-leaf numpy, async writes, atomic commit.

Counterpart of ``repro.train.checkpoint``, with its layout (one directory
per step):

    ckpt_dir/step_00000100/
        manifest.json        # tree structure, shapes, dtypes, step metadata
        leaf_00000.npy ...   # one file per leaf, host copies
        COMMIT               # written last: restart-safe atomicity marker

The reference writes its manifest with msgpack; the port writes the same
keys as JSON (the machine with the card has no msgpack). A tree is nested
dicts, tuples and lists of tensors, arrays and numbers; its leaves are taken
in insertion order, so a training state ``(params, opt_state)`` is the
parameters in ``named_parameters()`` order, then ``mu``, ``nu`` and ``step``.
numpy has no bfloat16: a bf16 leaf is stored as its raw 16-bit pattern and
the manifest names its dtype.

A tree of ``DTensor``s (training on a mesh) is saved as its whole tensors,
the layout of one device, and restored into the placements of the tree it
is restored into.

Fault tolerance: ``latest_step`` only considers committed checkpoints, so
a crash mid-write is invisible on restart. ``CheckpointManager.save_async``
snapshots device tensors to the host, then writes on a worker thread,
keeping the training loop running.
"""
from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor


def _flatten(tree) -> Tuple[List[Any], str]:
    """Leaves in insertion order and a string of the structure."""
    if isinstance(tree, dict):
        parts = [(k, _flatten(v)) for k, v in tree.items()]
        leaves = [leaf for _, (sub, _) in parts for leaf in sub]
        return leaves, "{" + ", ".join(f"{k!r}: {d}" for k, (_, d) in parts) + "}"
    if isinstance(tree, (tuple, list)):
        parts = [_flatten(v) for v in tree]
        leaves = [leaf for sub, _ in parts for leaf in sub]
        body = ", ".join(d for _, d in parts)
        return leaves, f"({body})" if isinstance(tree, tuple) else f"[{body}]"
    return [tree], "*"


def _unflatten(tree_like, leaves):
    """``tree_like``'s structure with ``leaves`` (an iterator) in place of
    its leaves."""
    if isinstance(tree_like, dict):
        return {k: _unflatten(v, leaves) for k, v in tree_like.items()}
    if isinstance(tree_like, (tuple, list)):
        return type(tree_like)(_unflatten(v, leaves) for v in tree_like)
    return next(leaves)


def _host(leaf):
    """A host copy of a leaf: tensors leave the device (a snapshot). A
    ``DTensor`` is gathered whole first (a collective: every rank snapshots
    the same leaves in the same order)."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.asarray(leaf)


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(array to save, dtype name): bf16 tensors as their 16-bit pattern."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_checkpoint(path: str, tree, step: int, extra: Optional[Dict] = None):
    p = Path(path) / f"step_{step:08d}"
    tmp = p.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    leaves, treedef = _flatten(tree)
    arrays = [_to_numpy(leaf) for leaf in leaves]
    manifest = {
        "step": step,
        "n_leaves": len(leaves),
        "treedef": treedef,
        "shapes": [list(a.shape) for a, _ in arrays],
        "dtypes": [dt for _, dt in arrays],
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    for i, (arr, _) in enumerate(arrays):
        np.save(tmp / f"leaf_{i:05d}.npy", arr)
    (tmp / "COMMIT").write_text("ok")
    if p.exists():
        shutil.rmtree(p)
    tmp.rename(p)
    return str(p)


def latest_step(path: str) -> Optional[int]:
    p = Path(path)
    if not p.exists():
        return None
    steps = [int(d.name.split("_")[1]) for d in p.glob("step_*")
             if (d / "COMMIT").exists()]
    return max(steps) if steps else None


def _restore_leaf(arr: np.ndarray, dtype: str, ref):
    if dtype == "bfloat16":
        t = torch.from_numpy(arr).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if isinstance(ref, DTensor):   # the whole leaf, placed as ref is
        return distribute_tensor(t.to(device=ref.device, dtype=ref.dtype),
                                 ref.device_mesh, ref.placements,
                                 src_data_rank=None)
    if isinstance(ref, torch.Tensor):
        return t.to(device=ref.device, dtype=ref.dtype)
    if isinstance(ref, np.ndarray):
        return t.float().numpy().astype(ref.dtype) if dtype == "bfloat16" \
            else arr.astype(ref.dtype)
    return type(ref)(arr.item()) if np.ndim(arr) == 0 else arr


def restore_checkpoint(path: str, tree_like, step: Optional[int] = None):
    """Restore into the structure of ``tree_like`` (shapes validated; each
    leaf takes the device and dtype of ``tree_like``'s)."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {path}")
    p = Path(path) / f"step_{step:08d}"
    manifest = json.loads((p / "manifest.json").read_text())
    leaves, _ = _flatten(tree_like)
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"model has {len(leaves)}")
    out = []
    for i, ref in enumerate(leaves):
        arr = np.load(p / f"leaf_{i:05d}.npy")
        shape = list(ref.shape) if hasattr(ref, "shape") else list(np.shape(ref))
        if list(arr.shape) != shape:
            raise ValueError(f"leaf {i}: ckpt {list(arr.shape)} vs model {shape}")
        out.append(_restore_leaf(arr, manifest["dtypes"][i], ref))
    return _unflatten(tree_like, iter(out)), manifest


class CheckpointManager:
    """Async checkpointing with retention. ``timings`` holds (step, seconds
    of the synchronous snapshot to the host, seconds of the write on the
    thread) for every save.

    In a process group every rank snapshots (``DTensor`` leaves are gathered
    whole) and rank 0 alone writes, so the files are those of one device;
    ``wait`` returns on every rank once rank 0's write has landed."""

    def __init__(self, path: str, keep: int = 3):
        self.path = Path(path)
        self.keep = keep
        self.timings: List[Tuple[int, float, float]] = []
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.writer = not dist.is_initialized() or dist.get_rank() == 0

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if dist.is_initialized():
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("asynchronous checkpoint write failed") from err

    def save_async(self, tree, step: int, extra: Optional[Dict] = None):
        self.wait()
        # snapshot to the host synchronously; the write runs on the thread
        t0 = time.perf_counter()
        leaves, _ = _flatten(tree)
        host = _unflatten(tree, iter([_host(leaf) for leaf in leaves]))
        snapshot_s = time.perf_counter() - t0
        if not self.writer:
            return

        def work():
            try:
                t1 = time.perf_counter()
                save_checkpoint(str(self.path), host, step, extra)
                self.timings.append((step, snapshot_s, time.perf_counter() - t1))
                self._gc()
            except Exception as e:  # raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = sorted(d for d in self.path.glob("step_*")
                       if (d / "COMMIT").exists())
        for d in steps[:-self.keep]:
            shutil.rmtree(d, ignore_errors=True)
