"""Build a kernel's CUDA sources into a C-ABI shared library with ``nvcc``.

Each kernel folder keeps its sources under ``csrc/``; the first call that
needs a kernel compiles them for Hopper (``sm_90a``) into the repository's
``build/kernels/`` directory, under a file name that carries a digest of the
sources and flags — an edited source gets a fresh library, an unchanged one
is reused.  Each source of a library compiles with an ``nvcc -c`` of its
own, all started together, and one ``nvcc -shared`` links them.  The library is
loaded with ``ctypes`` by the kernel's ``ops.py`` through a
``LibraryLoader``.  Nothing here runs at import time.

Several threads of one process may reach a kernel's first use at once (the
serving layer's worker threads share one card): a library is built under a
lock of its own name, into a temporary file named by process and thread,
and loaded once.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, Sequence

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
# the compile step of one source, and the link of a library's objects
COMPILE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_LOCKS: Dict[str, threading.RLock] = {}
_LOCKS_GUARD = threading.Lock()


def build_lock(name: str) -> threading.RLock:
    """The in-process lock of library ``name``: distinct kernels still
    build at once, one kernel builds once."""
    with _LOCKS_GUARD:
        return _LOCKS.setdefault(name, threading.RLock())


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``nvcc`` on PATH,
    then ``/usr/local/cuda/bin/nvcc``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's kernels "
                       "are compiled from their csrc/ sources at first use")


def library_path(name: str, sources: Sequence[Path]) -> Path:
    """Where ``name``'s library for these exact sources and flags lives."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in sources:
        h.update(Path(src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _run(cmd, name: str) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {name} "
                           f"(exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def build_library(name: str, sources: Sequence[Path]) -> Path:
    """Compile ``sources`` into ``lib<name>-<digest>.so`` unless that file
    already exists; returns its path.  The sources compile in an ``nvcc
    -c`` each, all at once, and one ``nvcc -shared`` links them.  Raises with the compiler's output when ``nvcc`` fails.  The ``-Xptxas
    -v`` report (registers, shared memory, spills per kernel) is kept
    beside the library as ``.log``."""
    out = library_path(name, sources)
    with build_lock(name):
        if out.exists():
            return out
        out.parent.mkdir(parents=True, exist_ok=True)
        tag = f"tmp{os.getpid()}.{threading.get_ident()}"
        tmp = out.with_name(f".{out.name}.{tag}")
        objs = [out.with_name(f".{out.stem}.{i}.{tag}.o")
                for i in range(len(sources))]
        nvcc = nvcc_path()
        try:
            with ThreadPoolExecutor(len(sources)) as pool:
                logs = list(pool.map(
                    lambda so: _run([nvcc, *COMPILE_FLAGS, "-o", str(so[1]),
                                     str(so[0])], name),
                    zip(sources, objs)))
            logs.append(_run([nvcc, *LINK_FLAGS, "-o", str(tmp),
                              *map(str, objs)], name))
            out.with_suffix(".log").write_text("".join(logs))
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
            for o in objs:
                o.unlink(missing_ok=True)
        return out


class LibraryLoader:
    """``load()`` run once per process, under ``name``'s build lock: the
    threads that reach a kernel's first use together wait for one build and
    one load, and every later call returns the cached value.  ``loads``
    counts the loads (1 once loaded)."""

    def __init__(self, name: str, load: Callable):
        self.name = name
        self._load = load
        self._value = None
        self.loads = 0

    def __call__(self):
        value = self._value
        if value is None:
            with build_lock(self.name):
                if self._value is None:
                    self._value = self._load()
                    self.loads += 1
                value = self._value
        return value


def library_loader(name: str):
    """Decorator: ``fn`` becomes the ``LibraryLoader`` of library ``name``."""
    return lambda fn: LibraryLoader(name, fn)
