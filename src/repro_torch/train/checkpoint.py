"""Checkpoints in the reference's on-disk format (``repro.train.checkpoint``).

  * ``<dir>/step_%08d/arrays.npz`` holds leaf ``i`` as ``leaf_i`` and
    ``manifest.json`` the step, every leaf's path, dtype name and shape.
    Leaves are numbered in JAX's flattening order (dict keys sorted,
    NamedTuple fields in order, lists by index) and their paths are JAX's
    strings, so either package reads what the other wrote.
  * numpy has no ``bfloat16``: such a leaf is stored as ``uint16``, viewed
    bit for bit, with ``"bfloat16"`` in the manifest.
  * atomic: writes go to ``<dir>/tmp.<step>`` and are renamed to
    ``step_<step>`` only when complete.
  * async: ``save_async`` copies every leaf to the host (the only
    synchronous part) and writes in a background thread.
  * retention: the newest ``keep`` checkpoints stay; GC is part of save.
  * sharded trees: a DTensor leaf is gathered to its full tensor on the
    calling thread (``_to_host``; the collectives cannot run in the writer
    thread), so every rank calls ``save``/``save_async``; rank 0 writes,
    and ``save`` and ``AsyncSave.wait`` end on a barrier, so every rank
    then sees the files.

``restore`` places leaves on ``like``'s devices (or on ``device``), and
checks the manifest's paths and shapes against ``like``'s. With ``place``
(``sharding.state.placer`` of a mesh and a plan) each leaf is laid out on
the mesh as it is read, so at most one full leaf is in memory: a state
written on one rank grid restores onto another.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.train import tree


def _to_host(leaf: Any) -> Tuple[np.ndarray, str]:
    """A copy of ``leaf`` in host memory as numpy, and its dtype name."""
    if not isinstance(leaf, torch.Tensor):
        a = np.array(leaf)
        return a, a.dtype.name
    if hasattr(leaf, "full_tensor"):       # a DTensor: every rank gathers
        leaf = leaf.full_tensor()
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:       # numpy has no bfloat16
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.dtype).removeprefix("torch.")


def _from_host(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16" and a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if a.dtype.name != dtype_name:
        raise ValueError(f"a leaf stored as {a.dtype.name} is labelled "
                         f"{dtype_name}")
    return torch.from_numpy(a)


def _snapshot(ckpt_tree: Any):
    """(arrays, dtype names, paths) on the writing rank. The other ranks
    take part in gathering each DTensor leaf and keep nothing (None)."""
    leaves, paths = tree.flatten_with_paths(ckpt_tree)
    if _ranks()[0] != 0:
        for x in leaves:
            if hasattr(x, "full_tensor"):
                x.full_tensor()
        return None
    host = [_to_host(x) for x in leaves]
    return [a for a, _ in host], [n for _, n in host], paths


def _write(ckpt_dir: str, step: int, arrays: List[np.ndarray],
           dtypes: List[str], paths: List[str], keep: int) -> str:
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"leaf_{i}": a for i, a in enumerate(arrays)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": int(step), "paths": paths, "dtypes": dtypes,
                   "shapes": [list(a.shape) for a in arrays]}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def _ranks() -> Tuple[int, bool]:
    """(this rank, whether a process group is up)."""
    import torch.distributed as dist

    up = dist.is_available() and dist.is_initialized()
    return (dist.get_rank() if up else 0), up


def _barrier() -> None:
    import torch.distributed as dist

    if _ranks()[1]:
        dist.barrier()


def save(ckpt_dir: str, step: int, ckpt_tree: Any, keep: int = 3) -> str:
    """Synchronous atomic save. Returns the final checkpoint path."""
    snap = _snapshot(ckpt_tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if snap is not None:
        _write(ckpt_dir, step, *snap, keep)
    _barrier()
    return final


class AsyncSave:
    def __init__(self, thread: threading.Thread, path: str):
        self._thread = thread
        self.path = path
        self.error: Optional[BaseException] = None

    def wait(self) -> str:
        """Join the writer; re-raise what it raised. Every rank calls it."""
        if self._thread is not None:
            self._thread.join()
        _barrier()
        if self.error is not None:
            raise self.error
        return self.path


def save_async(ckpt_dir: str, step: int, ckpt_tree: Any,
               keep: int = 3) -> AsyncSave:
    """Device->host snapshot now; disk write in a background thread."""
    snap = _snapshot(ckpt_tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")

    def run():
        try:
            _write(ckpt_dir, step, *snap, keep)
        except BaseException as exc:     # handed to wait(), which re-raises
            handle.error = exc

    handle = AsyncSave(threading.Thread(target=run, daemon=True)
                       if snap is not None else None, final)
    if snap is not None:
        handle._thread.start()
    return handle


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
             if (m := re.match(r"step_(\d+)$", d))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, like: Any, step: Optional[int] = None,
            device: Optional[torch.device] = None,
            place: Optional[Callable[[str, torch.Tensor], Any]] = None
            ) -> Tuple[Any, int]:
    """Restore into the structure of ``like``. Each leaf goes to ``device``,
    or else to the device of ``like``'s leaf (the CPU for a non-tensor);
    then, with ``place``, to ``place(path, leaf)``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves, paths = tree.flatten_with_paths(like)
    if manifest["paths"] != paths:
        raise ValueError(f"{path} holds leaves {manifest['paths']}, not the "
                         f"tree's {paths}")
    out = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, leaf in enumerate(leaves):
            t = _from_host(data[f"leaf_{i}"], manifest["dtypes"][i])
            if list(t.shape) != list(np.shape(leaf)):
                raise ValueError(f"leaf {paths[i]} has shape "
                                 f"{tuple(t.shape)} in {path}, not "
                                 f"{tuple(np.shape(leaf))}")
            dev = device if device is not None else (
                leaf.device if isinstance(leaf, torch.Tensor) else "cpu")
            t = t.to(dev)
            out.append(t if place is None else place(paths[i], t))
    return tree.unflatten(like, out), step


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(
        int(m.group(1)) for d in os.listdir(ckpt_dir)
        if (m := re.match(r"step_(\d+)$", d)))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
