"""The instruction mix nvcc emits for the port's kernels on sm_90a.

    python3 tools/sass_mix.py

Builds the three kernel libraries as the port does at first use (into
`build/`), plus a probe of 64-long chains of each Baby Bear operation of
`csrc/babybear.cuh` (`bb::mul`, `bb::add`, `bb::sub`), disassembles them
with `cuobjdump -sass` and prints, by instruction class (FMA pipe: IMAD*,
IMUL*; ALU only: ISETP, SEL, LOP3, SHF, LEA, PLOP3, PRMT, IMNMX, VIMNMX,
VIADDMNMX; adds nvcc
places on either pipe: IADD3, VIADD; memory: LD*, ST*; other; NOPs left
out):

1. `[mix]` the instructions of one operation of each chain (the chain's
   count less an empty kernel's, over 64): the per-operation mix that
   `chip_smoke.py`'s bounds use (`MUL_MIX`, `ADD_MIX`);
2. `[lib]` the static count of every function of each library;
3. `[cons]` for the generated fused constraint kernels, whose chunk
   functions are straight-line code run once per row, the instructions
   of one row in all of them (the tile's staging loop counted once, not
   per trip), beside the bound's model applied to the traced program
   (each live node once), to the chunks (each chunk's cone, nodes two
   chunks share counted in both) and to the α-combine as the kernel does
   it (`kernels/cons.combine_counts`).

Needs the CUDA toolkit (nvcc, cuobjdump) and a host with torch; no card is
used.
"""

from __future__ import annotations

import collections
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from boundless_tpu_torch.air import cons_eval as CE  # noqa: E402
from boundless_tpu_torch.kernels import build  # noqa: E402
from boundless_tpu_torch.kernels import cons as CK  # noqa: E402
from boundless_tpu_torch.kernels import ntt as NK  # noqa: E402
from boundless_tpu_torch.kernels import poseidon2 as P2K  # noqa: E402
from boundless_tpu_torch.zkvm import prove  # noqa: E402
from chip_smoke import ADD_MIX, MUL_MIX  # noqa: E402

CHAIN = 64
CLASSES = ("fma", "alu", "either", "mem", "other")
ALU = {"ISETP", "SEL", "LOP3", "SHF", "LEA", "PLOP3", "PRMT", "IMNMX",
       "VIMNMX", "VIADDMNMX"}
EITHER = {"IADD3", "VIADD"}
INSTR = re.compile(r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")


def probe_source() -> str:
    ops = {"none": "", "mul": "a = bb::mul(a, b);", "add": "a = bb::add(a, b);",
           "sub": "a = bb::sub(a, b);"}
    lines = ['#include <stdint.h>', '#include "babybear.cuh"']
    for name, op in ops.items():
        body = " ".join([op] * (CHAIN if op else 0))
        lines.append(
            f'extern "C" __global__ void chain_{name}(uint32_t* x, unsigned n)'
            " { unsigned i = blockIdx.x * blockDim.x + threadIdx.x;"
            " if (i >= n) return; uint32_t a = x[i], b = x[i + n]; "
            f"{body} x[i] = a ^ b; }}")
    return "\n".join(lines) + "\n"


def klass(opcode: str) -> str:
    if opcode.startswith(("IMAD", "IMUL")):
        return "fma"
    if opcode in ALU:
        return "alu"
    if opcode in EITHER:
        return "either"
    if opcode.startswith(("LD", "ST")):
        return "mem"
    return "other"


def sass(path: str) -> dict:
    """{function: Counter of classes} of one library or object file."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True, check=True).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), collections.Counter())
            continue
        m = INSTR.match(line)
        if m and cur is not None and m.group(1) != "NOP":
            cur[klass(m.group(1))] += 1
    return funcs


def model(muls: int, adds: int) -> dict:
    fma, alu, either = (muls * m + adds * a for m, a in zip(MUL_MIX, ADD_MIX))
    return {"fma": fma, "alu": alu, "either": either}


def fmt(counts) -> str:
    return " ".join(f"{k}={counts.get(k, 0)}" for k in CLASSES) + \
        f" total={sum(counts.values())}"


def main():
    version = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                             text=True, check=True).stdout.strip()
    print(f"[nvcc] {version.splitlines()[-1]}", flush=True)
    libs = {"bt_poseidon2": P2K._lib(), "bt_ntt": NK._lib()}
    for variant, air in prove._AIRS.items():
        libs[f"bt_cons_{variant}"] = CK.build_kernels(air)
    libs["bt_sass_probe"] = build.load_source("bt_sass_probe", probe_source)

    probe = {name.split("_", 1)[1]: c for name, c in
             sass(libs["bt_sass_probe"]._name).items()}
    for op in ("mul", "add", "sub"):
        per = {k: (probe[op][k] - probe["none"][k]) / CHAIN for k in CLASSES}
        print(f"[mix] op={op} " + " ".join(f"{k}={v:.3f}" for k, v in
                                           per.items()), flush=True)

    for lib, handle in libs.items():
        for func, c in sass(handle._name).items():
            print(f"[lib] library={lib} function={func} {fmt(c)}", flush=True)

    for variant, air in prove._AIRS.items():
        prog = CE.trace(air)
        row = sum(sass(libs[f"bt_cons_{variant}"]._name).values(),
                  collections.Counter())
        chunk_ops = collections.Counter()
        for _, _, steps in CK.schedule(prog):
            chunk_ops.update(prog.nodes[st[1]][0] for st in steps
                             if st[0] == "node")
        chunked = model(chunk_ops[CE.MUL], chunk_ops[CE.ADD]
                        + chunk_ops[CE.SUB] + chunk_ops[CE.NEG])
        print(f"[cons] variant={variant} sass_per_row: {fmt(row)}", flush=True)
        print(f"[cons] variant={variant} model_live: "
              f"{fmt(model(*CK.field_ops(prog)))}", flush=True)
        print(f"[cons] variant={variant} model_chunks: {fmt(chunked)}",
              flush=True)
        comb = CK.combine_counts(prog)
        fma, alu, either = model(comb["reductions"], 0).values()
        print(f"[cons] variant={variant} model_combine: "
              f"{fmt({'fma': comb['products'] + comb['folds'] + fma, 'alu': alu, 'either': comb['folds'] + either})}",
              flush=True)


if __name__ == "__main__":
    main()
