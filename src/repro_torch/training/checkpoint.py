"""Fault-tolerant checkpointing: atomic, manifest-verified, async-capable.

Counterpart of ``src/repro/training/checkpoint.py``, in its layout, so that
a checkpoint written by either package restores in the other: ``<dir>/
step_<n>/`` holds one ``.npy`` per leaf under ``host_0/`` (bf16 stored as
uint16 views), ``manifest.json`` (paths, shapes, dtypes, step, extra, time)
and a ``COMMITTED`` marker written last, after an atomic directory rename,
so a crash mid-write never leaves a checkpoint ``latest_step`` would pick up.

Leaves are numbered and named in the reference's order: the state is walked
as ``jax.tree_util.tree_flatten_with_path`` walks the reference's pytree
(dict keys sorted, lists indexed; :mod:`.tree`), so the port's
``LM.param_tree()`` gives the same ``params/stacks/0/ffn/w_up`` paths and the
same files, byte for byte.  One process, one host directory: a sharded
``Trainer`` gathers its state into the global tree
(``distributed.context.gather_tree``) and the process at coordinate 0
writes it, the same files as an unsharded run's; a restore gives global
leaves, which the trainer cuts to its slices.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from .tree import flatten_with_path, leaves, map_tree, path_str, unflatten

_BF16 = "bfloat16"


def _host(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """A leaf as the numpy array to store and its dtype's name."""
    t = leaf.detach().cpu()
    dt = str(t.dtype).replace("torch.", "")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), dt
    return t.numpy(), dt


def save(ckpt_dir: str, step: int, tree, extra: Optional[dict] = None) -> str:
    """Synchronous atomic save; returns the committed directory."""
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}_{os.getpid()}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    os.makedirs(os.path.join(tmp, "host_0"), exist_ok=True)
    manifest: dict[str, Any] = {"step": step, "leaves": [],
                                "extra": extra or {}, "time": time.time()}
    for i, (path, leaf) in enumerate(flatten_with_path(tree)):
        arr, dt = _host(leaf)
        fn = f"host_0/leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fn), arr, allow_pickle=False)
        manifest["leaves"].append({"path": path_str(path), "file": fn,
                                   "dtype": dt, "shape": list(arr.shape)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic publish
    with open(os.path.join(final, "COMMITTED"), "w") as f:
        f.write(str(step))
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = latest_step_all(ckpt_dir)
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like, device=None):
    """Restore into the structure of ``like`` (a tree of tensors).  Each leaf
    comes back with its stored dtype, on ``device`` or else on the device of
    ``like``'s leaf at the same place.  Returns ``(tree, manifest)``."""
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves_meta = manifest["leaves"]
    like_leaves = leaves(like)
    assert len(like_leaves) == len(leaves_meta), \
        f"checkpoint has {len(leaves_meta)} leaves, expected {len(like_leaves)}"
    out = []
    for meta, ref in zip(leaves_meta, like_leaves):
        arr = np.load(os.path.join(d, meta["file"]), allow_pickle=False)
        if meta["dtype"] == _BF16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        out.append(t.to(device if device is not None else ref.device))
    return unflatten(like, out), manifest


class AsyncCheckpointer:
    """Background-thread writer: ``submit`` returns once the state is copied
    to host memory (a copy: the trainer updates its tensors in place); at
    most one write in flight (later submits queue behind a join)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.saved: list[int] = []

    def submit(self, step: int, tree, extra: Optional[dict] = None) -> None:
        host_tree = map_tree(lambda x: x.detach().to("cpu", copy=True), tree)
        self.wait()

        def work():
            save(self.ckpt_dir, step, host_tree, extra)
            self.saved.append(step)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(latest_step_all(self.ckpt_dir))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s}"),
                          ignore_errors=True)


def latest_step_all(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and os.path.exists(
                os.path.join(ckpt_dir, d, "COMMITTED")):
            try:
                out.append(int(d.split("_", 1)[1]))
            except ValueError:
                pass
    return out
