"""Checkpointing (``repro/checkpoint/checkpointer.py``): blocking or
threaded save, atomic publish, retention, restore.

Layout, the reference's own, so a checkpoint the JAX package wrote
restores here and the other way round:

    <dir>/step_<N>/
        manifest.json          {step, leaves: {path: {file, shape, dtype}}}
        <leaf-path>.npy        one file per leaf

A leaf's path is the one ``models.params.flatten_with_paths`` gives it,
as ``jax.tree_util.tree_flatten_with_path`` names it
(``params::layers::attn::w_q``, ``opt::step``). A save writes
``step_<N>.tmp`` and renames it, so ``latest_step`` only sees published
steps. The host copy is taken before a threaded save returns: the trainer
updates its tensors in place, and a save must not see a later step.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.models.params import (flatten_with_paths, params_to_numpy,
                                       unflatten_with_paths)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree, blocking: bool = True) -> None:
        host = params_to_numpy(flatten_with_paths(tree))
        if blocking:
            self._write(step, host)
        else:
            self.wait()  # one in-flight save at a time
            self._thread = threading.Thread(target=self._write, args=(step, host),
                                            daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: dict) -> None:
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": {}}
        for key, arr in host.items():
            fname = re.sub(r"[^A-Za-z0-9_.:-]", "_", key) + ".npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape),
                                       "dtype": str(arr.dtype)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"))

    # -- restore ------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target_tree, device=None):
        """Restore into the structure of ``target_tree`` (any leaves: only
        the paths are read). Each leaf keeps the dtype it was saved with and
        lands on ``device`` (default: the CPU)."""
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = {}
        for key in flatten_with_paths(target_tree):
            arr = np.load(os.path.join(d, manifest["leaves"][key]["file"]))
            t = torch.from_numpy(arr)
            leaves[key] = t if device is None else t.to(device)
        return unflatten_with_paths(target_tree, leaves)
