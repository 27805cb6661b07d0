"""Build a CUDA source of the port with g++ against `tests/cuda_emu.h`.

`build(source, out_dir)` rewrites `boundless_tpu_torch/csrc/<source>` for
the CPU emulation of threads and warps (the `<<<grid, block, shared,
stream>>>` launches become `emu_launch` calls) and returns the shared
library, so a test can call the source's C interface on host memory.
"""

import ctypes
import os
import re
import subprocess

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "boundless_tpu_torch", "csrc")


def build(source: str, out_dir, text: str = None) -> ctypes.CDLL:
    """`text`, when given, is the source's text in place of the file's
    (a probe written by a test; its includes still resolve in csrc/)."""
    if text is None:
        with open(os.path.join(CSRC, source)) as f:
            text = f.read()
    src = text
    src = src.replace("#include <cuda_runtime.h>", '#include "cuda_emu.h"')
    src, launches = re.subn(
        r"([\w<>]+)<<<([^,]+), ([^,]+), ([^,]+), ([^>]+)>>>\(",
        r"emu_launch(\2, \3, \4, \1, ", src)
    assert launches > 0, f"no kernel launch found in {source}"
    stem = os.path.splitext(source)[0]
    cpp = os.path.join(str(out_dir), f"{stem}_emu.cpp")
    so = os.path.join(str(out_dir), f"lib{stem}_emu.so")
    with open(cpp, "w") as f:
        f.write(src)
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-pthread", "-w", "-I", HERE, "-I", CSRC, "-o", so, cpp],
                   check=True)
    return ctypes.CDLL(so)
