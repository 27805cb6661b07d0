"""Build CUDA sources with nvcc and load them via ctypes.

Each library is compiled at first use into `build/` at the repository
root, keyed by a hash of its source, the headers under `csrc/` and the
flags, for Hopper only (`sm_90a`). A source is a file under `csrc/`
(`load`) or a generated text (`load_source`, written to `build/` under its
hash first). The sources expose a plain C interface, so a build is one
`nvcc` call that links nothing of PyTorch. Builds of different libraries
may run in parallel threads (one nvcc each). Nothing here runs at import
time: CPU-only hosts import every module of the port.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Callable

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_NAME_LOCKS: dict = {}
_LIBS: dict = {}
BUILD_SECONDS: dict = {}  # library name -> seconds its nvcc call took
PTXAS_LOG: dict = {}  # library name -> ptxas's -v report (registers, spills)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def _name_lock(name: str) -> threading.Lock:
    with _LOCK:
        return _NAME_LOCKS.setdefault(name, threading.Lock())


def _build(name: str, src: str, digest: str) -> ctypes.CDLL:
    so = os.path.join(BUILD_DIR, f"lib{name}-{digest[:16]}.so")
    if not os.path.exists(so):
        t0 = time.perf_counter()
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc()] + NVCC_FLAGS + ["-I", CSRC, "-o", tmp, src]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} ({src}):\n"
                               f"{res.stderr[-8000:]}")
        os.replace(tmp, so)
        BUILD_SECONDS[name] = time.perf_counter() - t0
        PTXAS_LOG[name] = res.stderr
    return ctypes.CDLL(so)


def _digest(text: bytes) -> "hashlib._Hash":
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(text)
    return h


def load(name: str, source: str) -> ctypes.CDLL:
    """Compile `csrc/<source>` (if its hash is new) and load the library."""
    with _name_lock(name):
        if name not in _LIBS:
            src = os.path.join(CSRC, source)
            with open(src, "rb") as f:
                digest = _digest(f.read()).hexdigest()
            os.makedirs(BUILD_DIR, exist_ok=True)
            _LIBS[name] = _build(name, src, digest)
        return _LIBS[name]


def load_source(name: str, make_text: Callable[[], str]) -> ctypes.CDLL:
    """Compile a generated CUDA source (if its hash is new) and load it.
    `make_text()` is called only the first time `name` is loaded in the
    process (printing a large source costs tens of ms); the text is kept as
    `build/<name>-<hash>.cu` beside its library."""
    with _name_lock(name):
        if name not in _LIBS:
            text = make_text()
            digest = _digest(text.encode()).hexdigest()
            os.makedirs(BUILD_DIR, exist_ok=True)
            src = os.path.join(BUILD_DIR, f"{name}-{digest[:16]}.cu")
            if not os.path.exists(src):
                tmp = f"{src}.{os.getpid()}.tmp"
                with open(tmp, "w") as f:
                    f.write(text)
                os.replace(tmp, src)
            _LIBS[name] = _build(name, src, digest)
        return _LIBS[name]
