"""Build and load the hand-written CUDA kernels (plain C interface, ctypes).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``)
into ``build/kernels/lib<name>-<hash>.so`` at the repository root, the
first time a wrapper needs it; the hash of the source and of every local
header it includes names the file, so an edited source or header never
loads a stale library.  Nothing happens at
import: the module imports where there is no ``nvcc`` and no GPU (the
CPU tests), and only a call on a CUDA tensor builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of repro_torch are built at first "
        "use on a machine with the CUDA toolkit")


def sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and the ``csrc`` headers it includes
    (``#include "..."``), transitively."""
    todo, seen = [CSRC / f"{name}.cu"], []
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        todo += [CSRC / inc for inc in re.findall(
            r'^\s*#\s*include\s+"([^"]+)"', path.read_text(), re.M)]
    return seen


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless a library built from the same
    source exists.  The output is written to a temporary file and renamed,
    so a concurrent build never loads a half-written library.  Returns
    the compiler's log (with ``ptxas``'s registers and spills per kernel),
    empty when nothing was built."""
    out = library_path(name)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    res = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"kernel build failed: {out.name}: nvcc exited "
                           f"{res.returncode}\n{res.stdout}")
    os.replace(tmp, out)
    return res.stdout


def build_all(names: Sequence[str]) -> Dict[str, str]:
    """``build`` every library at once, one ``nvcc`` each, all started
    together; returns each one's log.  Raises if any build fails."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
