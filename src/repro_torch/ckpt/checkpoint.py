"""Fault-tolerant checkpointing: atomic, elastic, optionally asynchronous.

The counterpart of ``repro/ckpt/checkpoint.py``, with its on-disk layout:

* **Atomicity**: a save writes ``<dir>/tmp.<step>/`` (one ``leaf_XXXXX.npy``
  a leaf, then ``manifest.json`` with each leaf's path, file, dtype and
  shape, fsync'd) and renames it to ``<dir>/step_<step:010d>``; a crash
  mid-save never corrupts the newest complete checkpoint, and a directory
  without its manifest is never read.
* **Elasticity**: leaves are stored host-complete, so a checkpoint written
  from a mesh restores on one device and the reverse: ``restore`` takes
  target shardings (``dist.sharding.Sharding``, one a leaf) and cuts each
  rank's block.  A sharded state is gathered first
  (``dist.sharding.collect``, every rank) and saved by one rank.
* **Async**: ``save(..., blocking=False)`` copies the leaves to the host,
  then writes on a background thread; ``wait()`` joins it.
* **Retention**: the ``keep`` newest checkpoints stay; older ones are
  removed after a successful save.

A state is a tree of tensors (``repro_torch.tree``: dicts, lists, tuples,
a ``Transformer`` standing for its named parameters); a leaf's path is the
dot-joined keys, as the reference's.  bfloat16 leaves are stored as their
uint16 bits, with ``"bfloat16"`` as the manifest's dtype (numpy has no
bfloat16).  :meth:`CheckpointManager.read` returns the stored tree as numpy
arrays, which ``repro_torch.convert`` turns into the port's modules and
states (a checkpoint of the JAX package's trees restores that way).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.tree import leaves_with_paths, path_str


def _to_host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.uint16).numpy().copy()
        return x.numpy().copy()
    return np.asarray(x)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr))
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def _nest(entries):
    """A tree of dicts (lists where every key is an index) from (path string, value) pairs."""
    root: dict = {}
    for path, value in entries:
        keys = path.split(".") if path else []
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        if keys:
            node[keys[-1]] = value
        else:
            return value

    def fix(node):
        if not isinstance(node, dict):
            return node
        out = {k: fix(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out

    return fix(root)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state: Any, blocking: bool = True) -> None:
        """``state``: a tree of host-complete tensors (params, optimizer state, metadata)."""
        self.wait()  # one save in flight at a time
        host = []
        for p, x in leaves_with_paths(state):
            arr = _to_host(x)
            bf16 = isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16
            host.append((path_str(p), "bfloat16" if bf16 else str(arr.dtype), arr))

        def write():
            tmp = os.path.join(self.directory, f"tmp.{step}")
            final = os.path.join(self.directory, f"step_{step:010d}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            names = []
            for i, (pstr, dtype, arr) in enumerate(host):
                fname = f"leaf_{i:05d}.npy"
                np.save(os.path.join(tmp, fname), arr)
                names.append({"path": pstr, "file": fname, "dtype": dtype, "shape": list(arr.shape)})
            manifest = {"step": step, "leaves": names}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._cleanup()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _cleanup(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"), ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def all_steps(self):
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.directory, name, "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _manifest(self, step: Optional[int]):
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            return step, d, json.load(f)

    def read(self, step: Optional[int] = None) -> Tuple[int, Any]:
        """(step, the stored tree): nested dicts (lists where the keys are indices) of numpy arrays."""
        step, d, manifest = self._manifest(step)
        return step, _nest((e["path"], np.load(os.path.join(d, e["file"]))) for e in manifest["leaves"])

    def restore(self, template: Any, step: Optional[int] = None, shardings: Any = None) -> Tuple[int, Any]:
        """(step, the state) in the structure of ``template``.

        Each leaf takes its template leaf's device and dtype; with
        ``shardings`` (a tree of ``dist.sharding.Sharding`` beside the
        template's leaves) each rank gets its block of the stored leaf,
        whatever mesh wrote it.  A module in the template is filled in place
        (``copy_`` under ``no_grad``) and returned; other leaves are new
        tensors.
        """
        step, d, manifest = self._manifest(step)
        leaves = leaves_with_paths(template)
        if len(leaves) != len(manifest["leaves"]):
            raise ValueError(
                f"checkpoint has {len(manifest['leaves'])} leaves, template {len(leaves)}: structure mismatch"
            )
        by_path = {e["path"]: e for e in manifest["leaves"]}
        shard_of = dict((path_str(p), s) for p, s in leaves_with_paths(shardings)) if shardings is not None else {}
        values = {}
        for p, tmpl in leaves:
            key = path_str(p)
            entry = by_path.get(key)
            if entry is None:
                raise KeyError(f"leaf {key} missing from checkpoint")
            t = _from_host(np.load(os.path.join(d, entry["file"])), entry["dtype"])
            sh = shard_of.get(key)
            want = sh.block_shape(t.shape) if sh is not None else tuple(t.shape)
            if want != tuple(getattr(tmpl, "shape", ())):
                raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)} does not give the template's "
                                 f"{tuple(getattr(tmpl, 'shape', ()))}")
            if isinstance(tmpl, torch.Tensor):
                t = t.to(device=tmpl.device, dtype=tmpl.dtype)
            values[key] = sh.block(t) if sh is not None else t
        return step, _fill(template, (), values)


def _fill(node, path, values):
    if isinstance(node, nn.Module):
        with torch.no_grad():
            for name, p in node.named_parameters():
                p.copy_(values[path_str(path + (name,))])
        return node
    if isinstance(node, dict):
        return {k: _fill(v, path + (k,), values) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_fill(v, path + (i,), values) for i, v in enumerate(node))
    return values[path_str(path)]
