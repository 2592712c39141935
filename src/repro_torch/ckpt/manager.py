"""Checkpoints: atomic, keep-k, async (``repro.ckpt.manager``).

The reference's layout, one directory a step::

    <root>/step_000000123/
        manifest.json        # step, leaf count, tree description, leaves
        leaf_00000.npy ...   # one .npy a leaf, in flatten order
    <root>/step_000000123.tmp/   # a write in flight, renamed when done

Leaves are flattened as ``jax.tree`` flattens them (dict keys sorted,
lists and tuples in order; ``optim.tree_leaves``), and restore reads only
the manifest's ``n_leaves`` and each leaf's shape, so a checkpoint either
package writes restores in the other.  The ``treedef`` field describes
the port's tree in its own words (``describe``).  A bfloat16 leaf is
written as float32, which holds it exactly (numpy has no bfloat16).

* ATOMIC: leaves land in ``<dir>.tmp``, the manifest last, then the
  directory is renamed; restore ignores a ``.tmp`` and a directory
  without a manifest, and the manager removes stale ``.tmp`` directories.
* KEEP-K: after a save, steps older than the newest ``keep`` go.
* ASYNC: ``CheckpointManager.save`` copies the tree to the host, then a
  writer thread serialises it while training goes on; at most one write
  is pending.
* One card: the ``shardings`` of a restore is a device (the reference
  takes the current mesh's shardings there).
"""
from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from ..optim import tree_leaves, tree_map


def describe(tree) -> str:
    """The tree's structure with its leaves as ``*``."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(describe(x) for x in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner},)"
    return "*"


def to_host(x) -> np.ndarray:
    """A leaf as a numpy array on the host (bfloat16 widened to float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def save_checkpoint(root, step: int, tree: Any, extra: Optional[dict] = None):
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step:09d}"
    tmp = root / f"step_{step:09d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    leaves = tree_leaves(tree)
    index = []
    for i, leaf in enumerate(leaves):
        arr = to_host(leaf)
        np.save(tmp / f"leaf_{i:05d}.npy", arr)
        index.append({"shape": list(arr.shape), "dtype": str(arr.dtype)})
    manifest = {"step": step, "n_leaves": len(leaves),
                "treedef": describe(tree), "leaves": index,
                "extra": extra or {}, "time": time.time()}
    # the manifest last: its presence marks the payload complete
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def restore_checkpoint(root, tree_like: Any, step: Optional[int] = None,
                       shardings: Any = None):
    """Restore into the structure of ``tree_like``: each leaf in the
    like leaf's dtype on its device, or, given ``shardings`` (a device),
    as stored on that device.  Returns (tree, step)."""
    root = Path(root)
    steps = available_steps(root)
    if not steps:
        raise FileNotFoundError(f"no complete checkpoints under {root}")
    step = step if step is not None else steps[-1]
    d = root / f"step_{step:09d}"
    manifest = json.loads((d / "manifest.json").read_text())

    leaves = tree_leaves(tree_like)
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"model expects {len(leaves)}")
    out = []
    for i, like in enumerate(leaves):
        arr = np.load(d / f"leaf_{i:05d}.npy")
        if list(arr.shape) != manifest["leaves"][i]["shape"]:
            raise ValueError(f"leaf {i} shape mismatch: {arr.shape}")
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"leaf {i}: checkpoint {arr.shape} vs model "
                             f"{tuple(like.shape)}")
        t = torch.from_numpy(arr)
        if shardings is not None:
            out.append(t.to(torch.device(shardings)))
        else:
            out.append(t.to(device=like.device, dtype=like.dtype))
    it = iter(out)
    return tree_map(lambda _: next(it), tree_like), step


def available_steps(root):
    root = Path(root)
    if not root.exists():
        return []
    return sorted(int(d.name.split("_")[1]) for d in root.iterdir()
                  if d.is_dir() and d.name.startswith("step_")
                  and not d.name.endswith(".tmp")
                  and (d / "manifest.json").exists())


class CheckpointManager:
    """keep-k + async around ``save_checkpoint`` / ``restore_checkpoint``.
    ``last_handoff_s`` is the last save's host copy (what the training
    loop waits for), ``last_write_s`` its serialisation."""

    def __init__(self, root, keep: int = 3, async_save: bool = True):
        self.root = Path(root)
        self.keep = keep
        self.async_save = async_save
        self._pending: Optional[threading.Thread] = None
        self.last_handoff_s = self.last_write_s = None

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        t0 = time.perf_counter()
        host_tree = tree_map(to_host, tree)
        self.last_handoff_s = time.perf_counter() - t0
        if self.async_save:
            self.wait()  # double-buffer: at most one write in flight
            t = threading.Thread(target=self._write,
                                 args=(step, host_tree, extra), daemon=True)
            t.start()
            self._pending = t
        else:
            self._write(step, host_tree, extra)

    def _write(self, step, host_tree, extra):
        t0 = time.perf_counter()
        save_checkpoint(self.root, step, host_tree, extra)
        self._gc()
        self.last_write_s = time.perf_counter() - t0

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self):
        steps = available_steps(self.root)
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.root / f"step_{s:09d}", ignore_errors=True)
        # stale tmp directories of crashed writers
        for d in self.root.glob("*.tmp"):
            shutil.rmtree(d, ignore_errors=True)

    def restore(self, tree_like, step=None, shardings=None):
        self.wait()
        return restore_checkpoint(self.root, tree_like, step, shardings)

    def latest_step(self) -> Optional[int]:
        steps = available_steps(self.root)
        return steps[-1] if steps else None
