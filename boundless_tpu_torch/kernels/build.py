"""Build the CUDA sources under `csrc/` with nvcc and load them via ctypes.

Each library is compiled at first use into `build/` at the repository
root, keyed by a hash of its sources, headers and flags, for Hopper only
(`sm_90a`). The sources expose a plain C interface, so the build is one
`nvcc` call of a few seconds and links nothing of PyTorch. Nothing here
runs at import time: CPU-only hosts import every module of the port.
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

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIBS: dict = {}
BUILD_SECONDS: dict = {}  # library name -> seconds its nvcc call took


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def load(name: str, source: str) -> ctypes.CDLL:
    """Compile `csrc/<source>` (if its hash is new) and load the library."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        src = os.path.join(CSRC, source)
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
            with open(path, "rb") as f:
                h.update(f.read())
        os.makedirs(BUILD_DIR, exist_ok=True)
        so = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
        if not os.path.exists(so):
            t0 = time.perf_counter()
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [_nvcc()] + NVCC_FLAGS + ["-I", CSRC, "-o", tmp, src]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed for {source}:\n{res.stderr}")
            os.replace(tmp, so)
            BUILD_SECONDS[name] = time.perf_counter() - t0
        _LIBS[name] = ctypes.CDLL(so)
        return _LIBS[name]
