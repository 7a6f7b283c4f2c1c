"""Atomic, async checkpointing in the JAX package's on-disk format (the
port of ``repro/checkpoint/store.py``).

Layout, as JAX writes it (one file per leaf)::

    <dir>/step_<k>.tmp/          written first
        manifest.json            {"step", "leaves": [{"key", "file",
                                  "shape", "dtype", "stored_dtype"}],
                                  "extra"}
        <leaf-path>.npy          the whole leaf
    <dir>/step_<k>/              atomic rename when complete

A leaf's key is its path in the tree as ``jax.tree_util``'s
``tree_flatten_with_path`` names it (dict keys and tuple indices joined by
``/``: ``0/layers/attn/wq`` for a parameter of ``(params, opt_state)``,
``1/mu/embed``, ``1/step``), so a checkpoint either package writes, the
other restores.  numpy has no bf16: a bf16 leaf is stored as f32 with its
true dtype recorded, and cast back to ``torch.bfloat16`` on restore
(exact: every bf16 value is an f32 one).  ``restore`` places each leaf on
the device of the target tree's leaf; there is no mesh to reshard onto, so
JAX's ``shardings`` is not taken.

Properties kept: atomicity (a crash mid-write leaves only a ``.tmp``
directory, never a corrupt checkpoint; restore picks the newest complete
step), and async saves (``AsyncCheckpointer`` copies the tree to host
memory synchronously, then writes on a background thread).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tr


def _flatten_with_paths(tree):
    return [("/".join(str(k) for k in path), leaf)
            for path, leaf in tr.leaves_with_paths(tree)]


def save(ckpt_dir, step: int, tree: Any, extra: Optional[Dict] = None):
    """Synchronous atomic checkpoint of a tree of tensors (any device)."""
    ckpt_dir = Path(ckpt_dir)
    tmp = ckpt_dir / f"step_{step}.tmp"
    final = ckpt_dir / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for key, leaf in _flatten_with_paths(tree):
        orig_dtype = str(leaf.dtype).replace("torch.", "")
        t = leaf.detach().cpu()
        arr = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        fname = key.replace("/", "__") + ".npy"
        np.save(tmp / fname, arr)
        manifest["leaves"].append({
            "key": key, "file": fname, "shape": list(arr.shape),
            "dtype": orig_dtype, "stored_dtype": str(arr.dtype)})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


class AsyncCheckpointer:
    """Snapshot-to-host synchronously, write-to-disk asynchronously."""

    def __init__(self, ckpt_dir, keep: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None):
        # a copy even of a CPU tensor: the caller may write to its tensors
        host_tree = tr.tree_map(lambda x: x.detach().to("cpu", copy=True),
                                tree)
        self.wait()
        self._thread = threading.Thread(
            target=self._write, args=(step, host_tree, extra), daemon=True)
        self._thread.start()

    def _write(self, step, host_tree, extra):
        save(self.ckpt_dir, step, host_tree, extra)
        self._gc()

    def _gc(self):
        steps = sorted(all_steps(self.ckpt_dir))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.ckpt_dir / f"step_{s}", ignore_errors=True)

    def wait(self):
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()


def all_steps(ckpt_dir) -> list:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    steps = []
    for p in ckpt_dir.iterdir():
        if p.is_dir() and p.name.startswith("step_") and \
                not p.name.endswith(".tmp") and (p / "manifest.json").exists():
            steps.append(int(p.name.split("_")[1]))
    return sorted(steps)


def latest_step(ckpt_dir) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir, step: int, target_tree: Any) -> Tuple[Any, Dict]:
    """Restore into the structure of ``target_tree``, a tree of tensors
    (shapes validated): tensors of the recorded dtype, each on its target
    leaf's device."""
    final = Path(ckpt_dir) / f"step_{step}"
    manifest = json.loads((final / "manifest.json").read_text())
    by_key = {l["key"]: l for l in manifest["leaves"]}
    out = []
    for key, leaf in _flatten_with_paths(target_tree):
        meta = by_key[key]
        arr = np.load(final / meta["file"])
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs "
                             f"{tuple(leaf.shape)}")
        out.append(torch.from_numpy(arr).to(getattr(torch, meta["dtype"]))
                   .to(leaf.device))
    return tr.unflatten(target_tree, out), manifest["extra"]
