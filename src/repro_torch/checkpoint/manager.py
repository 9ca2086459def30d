"""Checkpointing with async commit, keep-N GC and damage fallback.

Torch counterpart of ``repro.checkpoint.manager``, with the same layout
(one directory per step) and guarantees:

    <root>/step_000100.tmp/...      (being written)
    <root>/step_000100/
        index.json                  leaf keys, shapes, true dtypes
        shard_00000.npz             flattened leaves (path-keyed)
    <root>/LATEST                   text file with the newest step

* atomic commit: every file is written to a ``.part``, fsync'd and
  renamed; the ``.tmp`` directory is renamed only after the shard and the
  index are in place, so a crash mid-save never corrupts LATEST;
* async: the copy to host happens on the caller's thread, synchronously
  (no ``non_blocking``), so the host arrays are whole before ``save``
  returns and before the next step can touch the params; file IO runs on
  a background thread off the training loop;
* fault tolerance: ``restore`` validates the index and falls back to the
  previous step if the newest directory is damaged; a leaf the template
  has and the checkpoint lacks raises ``KeyError`` (and so falls back).

npz cannot store bfloat16, and the card machine has no ``ml_dtypes``:
such a leaf is stored as its ``int16`` view (``Tensor.view``) with its
true dtype recorded in the index.  ``restore`` places every leaf on the
template leaf's device (a meta template leaf: the host), in its recorded
dtype, or by ``shardings``.  Trees are the port's nested dicts and lists
of tensors (``repro_torch.tree``).

Multi-rank (``Trainer(mesh=...)``): a tree with DTensor leaves is saved
collectively.  Every rank calls ``save`` with its shards of the same
tree; each leaf is gathered (``full_tensor``, a collective, in the same
leaf order on every rank), rank 0 writes the checkpoint, and all ranks
meet at a barrier in ``wait`` (which the next ``save`` and every restore
path of the trainer call) once rank 0's write has committed.  The files
hold global arrays, so ``restore(..., shardings=...)`` places them under
any mesh, or none: the elastic resume.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.sharding.partition import is_dtensor, place_tree
from repro_torch.tree import SEP, leaves, path_key, unflatten

# tensors npz cannot hold, stored as the same-width integer view
_VIEW_FOR = {torch.bfloat16: torch.int16}
_TORCH_DTYPES = {"bfloat16": torch.bfloat16}


def _fsync_dir(path: str) -> None:
    """fsync a directory so renames within it survive a crash (POSIX
    requires syncing the directory entry, not just file contents)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _encode(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A tensor as a host numpy array npz can hold, and its true dtype's
    name.  The copy to host is synchronous and always a copy (a CPU
    tensor too), so later writes to ``t`` do not reach it."""
    t = t.detach()
    if is_dtensor(t):
        t = t.full_tensor()
    name = str(t.dtype).replace("torch.", "")
    if t.dtype in _VIEW_FOR:
        t = t.view(_VIEW_FOR[t.dtype])
    return t.to("cpu", copy=True).numpy(), name


def _decode(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    t = torch.from_numpy(arr)     # npz hands each leaf its own array
    if dtype_name in _TORCH_DTYPES:
        t = t.view(_TORCH_DTYPES[dtype_name])
    return t


def _flatten(tree) -> Dict[str, Any]:
    return {path_key(path): leaf for path, leaf in leaves(tree)}


def _unflatten_like(template, flat: Dict[str, torch.Tensor]):
    out = []
    for path, like in leaves(template):
        key = path_key(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        t = flat[key]
        out.append(t.to(like.device)
                   if isinstance(like, torch.Tensor)
                   and like.device.type != "meta" else t)
    return unflatten(template, out)


class CheckpointManager:
    """Step-directory checkpoint store: atomic commit via .tmp rename,
    optional async save thread, keep-N garbage collection, and restore
    with fallback to an older step (see the module docstring)."""

    def __init__(self, root: str, keep: int = 3, async_save: bool = True):
        self.root = root
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._collective = False          # a multi-rank save to wait for
        os.makedirs(root, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree, extra: Optional[Dict] = None) -> None:
        """Snapshot ``tree`` at ``step``.  Blocks only for the copy to
        host; a previous save still being written is waited for first.
        Collective when ``tree`` has DTensor leaves (module docstring):
        only rank 0 writes."""
        self.wait()
        flat = _flatten(tree)
        collective = any(is_dtensor(v) for v in flat.values())
        host, dtypes = {}, {}
        for k, v in flat.items():
            host[k], dtypes[k] = _encode(torch.as_tensor(v))
        meta = {
            "step": step,
            "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                       for k, v in host.items()},
            "extra": extra or {},
        }
        self._collective = collective
        if collective and torch.distributed.get_rank() != 0:
            return
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, meta), daemon=True)
            self._thread.start()
        else:
            self._write(step, host, meta)

    def _write(self, step: int, host: Dict[str, np.ndarray], meta) -> None:
        name = f"step_{step:08d}"
        tmp = os.path.join(self.root, name + ".tmp")
        final = os.path.join(self.root, name)
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        # every file commits atomically: bytes to a .part, fsync, then
        # rename within the same directory -- a crash mid-write leaves at
        # most an orphaned .part, never a torn shard a restore could
        # half-load
        self._commit_file(
            os.path.join(tmp, "shard_00000.npz"),
            # npz keys cannot contain '/' reliably across loaders
            lambda f: np.savez(f, **{k.replace(SEP, "::"): v
                                     for k, v in host.items()}))
        self._commit_file(
            os.path.join(tmp, "index.json"),
            lambda f: f.write(json.dumps(meta).encode()))
        _fsync_dir(tmp)        # file renames inside tmp are durable
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        with open(os.path.join(self.root, "LATEST.tmp"), "w") as f:
            f.write(name)
            f.flush()
            os.fsync(f.fileno())
        os.rename(os.path.join(self.root, "LATEST.tmp"),
                  os.path.join(self.root, "LATEST"))
        _fsync_dir(self.root)  # both directory renames are durable
        self._gc()

    @staticmethod
    def _commit_file(path: str, write_fn) -> None:
        """Atomic file commit: write ``path + '.part'``, fsync the bytes,
        rename onto ``path``.  ``write_fn`` receives the open binary file
        object."""
        part = path + ".part"
        with open(part, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.rename(part, path)

    def wait(self) -> None:
        """Block until the in-flight async save (if any) commits; after a
        collective save, every rank waits at a barrier for rank 0's."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._collective:
            self._collective = False
            torch.distributed.barrier()

    def _gc(self) -> None:
        steps = self.list_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def list_steps(self) -> List[int]:
        """Committed checkpoint steps under root, ascending."""
        out = []
        for d in os.listdir(self.root):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def _load_step(self, step: int) -> Tuple[Dict[str, torch.Tensor], Dict]:
        d = os.path.join(self.root, f"step_{step:08d}")
        with open(os.path.join(d, "index.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(d, "shard_00000.npz")) as data:
            host = {k.replace("::", SEP): data[k] for k in data.files}
        out = {}
        for k, info in meta["leaves"].items():
            if k not in host or list(host[k].shape) != info["shape"]:
                raise IOError(f"corrupt checkpoint {d}: leaf {k}")
            out[k] = _decode(host[k], info["dtype"])
        return out, meta

    def restore(self, template, step: Optional[int] = None,
                shardings=None) -> Tuple[Any, Dict]:
        """Restore into ``template``'s structure, each leaf on the device
        of the template's leaf, or placed by ``shardings`` (a matching tree
        of ``NamedSharding``s, None leaves left on the host; the elastic
        resume onto another mesh); the newest step unless ``step`` is
        given, falling back to older ones past a damaged directory."""
        steps = self.list_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        candidates = [step] if step is not None else steps[::-1]
        err: Optional[Exception] = None
        for s in candidates:
            try:
                host, meta = self._load_step(s)
                tree = _unflatten_like(template, host)
                if shardings is not None:
                    tree = place_tree(tree, shardings)
                return tree, meta
            except (IOError, KeyError) as e:      # damaged -> fall back
                err = e
                continue
        raise IOError(f"all checkpoints damaged under {self.root}: {err}")

    def latest_step(self) -> Optional[int]:
        """Newest committed step, or None when the store is empty."""
        steps = self.list_steps()
        return steps[-1] if steps else None
