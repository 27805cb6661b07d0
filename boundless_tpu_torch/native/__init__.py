"""Native (C++) host components of the port, loaded via ctypes.

The port's own copy of the JAX package's loader (`boundless_tpu/native`)
and of its `executor.cpp` (the exec-only interpreter and the per-segment
cycle loop), `witness_gen.cpp` (the witness cycle loop) and
`rec_eval.cpp` (the recursion VM's evaluator: the data trace of a
recursion proof). Each library is compiled with g++ at first use into
`build/` at the repository root
(gitignored, the same directory the CUDA kernels build into), keyed by a
hash of its source, and bound with ctypes. Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build")
_LOCK = threading.Lock()
_LIBS: dict = {}


def load(name: str, sources):
    """Compile (if its hash is new) and load lib<name>.so from `sources`."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        srcs = [os.path.join(_DIR, s) for s in sources]
        h = hashlib.sha256()
        for s in srcs:
            with open(s, "rb") as f:
                h.update(f.read())
        os.makedirs(BUILD_DIR, exist_ok=True)
        so_path = os.path.join(BUILD_DIR,
                               f"lib{name}-{h.hexdigest()[:16]}.so")
        if not os.path.exists(so_path):
            tmp = f"{so_path}.{os.getpid()}.tmp"
            cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                   "-o", tmp] + srcs
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(so_path)
        _LIBS[name] = lib
        return lib


def witness_lib():
    return load("bt_witness", ["witness_gen.cpp"])


def executor_lib():
    return load("bt_executor", ["executor.cpp"])


def rec_eval_lib():
    lib = load("bt_rec_eval", ["rec_eval.cpp"])
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.bt_rec_eval.argtypes = [vp] * 6 + [i64, vp, i64, vp, vp, vp, vp,
                                           ctypes.c_char_p, ctypes.c_int]
    lib.bt_rec_eval.restype = ctypes.c_int
    return lib
