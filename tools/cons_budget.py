"""The fused constraint kernel at several chunk budgets and warps a block,
and a read-modify-write design, on one CUDA card.

    python3 tools/cons_budget.py [--variant rv32i] [--po2 17]
                                 [--configs 1500x2,1500xrmw,1000xrmw]

A configuration BUDGETxWARPS is the port's generated kernel
(`kernels/cons.cuda_source`; `OP_BUDGET` and `WARPS` are what the port
builds): one launch, the whole tile staged once, the chunks as device
functions. BUDGETxrmw is the other design, printed here from the same
schedule: one launch per chunk, each staging only the columns its chunk
reads (4-byte `cp.async`, odd row stride) into a tile of TR + INV_RATE
rows, one warp a block, and adding into an (8, M) 64-bit accumulator in
device memory (read, add, write per chunk), then one launch that reduces
the accumulators to the class columns. All builds run in parallel (nvcc),
then every configuration runs on the same random 4N grid of 4 * 2^po2
rows (random evaluations, publics and weights: the arithmetic does not
depend on the values), two classes. Prints per configuration: chunks,
operations with recomputation, registers, spill bytes, blocks per SM (the
smallest over a design's kernels) and CUDA-event milliseconds, and checks
that all give the same words. Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
import threading

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from boundless_tpu_torch.air import cons_eval as CE  # noqa: E402
from boundless_tpu_torch.core import field as F  # noqa: E402
from boundless_tpu_torch.kernels import build  # noqa: E402
from boundless_tpu_torch.kernels import cons as CK  # noqa: E402
from boundless_tpu_torch.zkvm import prove  # noqa: E402


def rmw_source(prog, name: str, budget: int) -> str:
    """CUDA C of the read-modify-write design (see the module note); the
    constants and helpers are those of the port's source."""
    base = CK.cuda_source(prog, name, budget, 1)
    head = base[:base.index("__device__ __noinline__ Acc cons_0")]
    offs, _ = CK._tile_layout(prog)
    bounds = [o + c for o, c in zip(offs, prog.cols)]
    parts = CK.schedule(prog, budget)
    lines = [head]
    for i, (_, _, steps) in enumerate(parts):
        used = sorted({offs[prog.nodes[s[1]][1] // 2] + prog.nodes[s[1]][2]
                       for s in steps if s[0] == "node"
                       and prog.nodes[s[1]][0] == CE.COL})
        at = {t: k for k, t in enumerate(used)}
        stride = max(1, len(used)) | 1
        text = "\n".join(CK._function(prog, i, steps))
        text = text.replace(f"Acc cons_{i}(", f"Acc rcons_{i}(", 1)
        text = re.sub(r"lds\((now|nxt) \+ (\d+)u\)",
                      lambda mt: f"lds({mt[1]} + {4 * at[int(mt[2]) // 4]}u)",
                      text)
        lines += [text, "",
                  f"__device__ const unsigned short cols_{i}[] = "
                  f"{{{', '.join(map(str, used or [0]))}}};",
                  f"constexpr unsigned NCOL_{i} = {len(used)}, "
                  f"STRIDE_{i} = {stride};",
                  f"constexpr unsigned SMEM_{i} = "
                  f"(TR + NEXT) * STRIDE_{i} * 4;",
                  "",
                  f"__global__ void __launch_bounds__(TR) rmw_{i}(",
                  "    const uint32_t* __restrict__ ctrl, "
                  "const uint32_t* __restrict__ data,",
                  "    const uint32_t* __restrict__ accum, "
                  "uint64_t* __restrict__ acc, unsigned m, int first) {",
                  "  extern __shared__ uint32_t smem[];",
                  "  const unsigned tile = "
                  "(unsigned)__cvta_generic_to_shared(smem);",
                  "  const unsigned r0 = blockIdx.x * TR;",
                  "  for (unsigned t = 0; t < TR + NEXT; ++t) {",
                  "    unsigned row = r0 + t;",
                  "    while (row >= m) row -= m;",
                  f"    for (unsigned k = threadIdx.x; k < NCOL_{i}; "
                  "k += TR) {",
                  f"      const unsigned o = cols_{i}[k];",
                  f"      const uint32_t* src = o < {bounds[0]}u ? "
                  f"ctrl + (size_t)row * {prog.cols[0]}u + o",
                  f"          : o < {bounds[1]}u ? data + (size_t)row * "
                  f"{prog.cols[1]}u + (o - {offs[1]}u)",
                  f"          : accum + (size_t)row * {prog.cols[2]}u + "
                  f"(o - {offs[2]}u);",
                  '      asm volatile('
                  '"cp.async.ca.shared.global [%0], [%1], 4;"',
                  f'                   :: "r"(tile + 4u * (t * STRIDE_{i} + k)),'
                  ' "l"(src));',
                  "    }",
                  "  }",
                  '  asm volatile("cp.async.wait_all;" ::: "memory");',
                  "  __syncthreads();",
                  "  const unsigned r = r0 + threadIdx.x;",
                  "  if (r >= m) return;",
                  f"  const unsigned now = tile + 4u * threadIdx.x * "
                  f"STRIDE_{i};",
                  f"  const unsigned nxt = now + 4u * NEXT * STRIDE_{i};",
                  "  Acc a = {};",
                  "  if (!first)",
                  "#pragma unroll",
                  "    for (int s = 0; s < 8; ++s) "
                  "a.v[s] = acc[(size_t)s * m + r];",
                  f"  a = rcons_{i}(now, nxt, a);",
                  "#pragma unroll",
                  "  for (int s = 0; s < 8; ++s) "
                  "acc[(size_t)s * m + r] = a.v[s];",
                  "}", ""]
    lines += [
        "__global__ void rmw_final(const uint64_t* __restrict__ acc, "
        "uint32_t* __restrict__ out,",
        "                          unsigned m, unsigned sel0, unsigned sel1) {",
        "  const unsigned r = blockIdx.x * blockDim.x + threadIdx.x;",
        "  if (r >= m) return;",
        "  uint32_t red[8];",
        "#pragma unroll",
        "  for (int s = 0; s < 8; ++s)",
        "    red[s] = redc(fold(acc[(size_t)s * m + r]));",
        "  const unsigned sel[2] = {sel0, sel1};",
        "  for (int o = 0; o < 2; ++o) {",
        "    if (sel[o] == 0) break;",
        "    uint32_t y[4];",
        "#pragma unroll",
        "    for (int c = 0; c < 4; ++c)",
        "      y[c] = bb::add(sel[o] & 1u ? red[c] : 0u, "
        "sel[o] & 2u ? red[4 + c] : 0u);",
        "    *reinterpret_cast<uint4*>(out + ((size_t)o * m + r) * 4) =",
        "        make_uint4(y[0], y[1], y[2], y[3]);",
        "  }",
        "}",
        "",
        "}  // namespace",
        "",
        'extern "C" {',
        "",
        "int bt_cons_blocks_per_sm() {",
        "  int least = 1 << 30;",
    ]
    for i in range(len(parts)):
        lines += [
            "  {",
            f"    cudaError_t e = cudaFuncSetAttribute(rmw_{i}, "
            f"cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_{i});",
            "    if (e != cudaSuccess) return -(int)e;",
            "    int blocks = 0;",
            f"    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, "
            f"rmw_{i}, TR, SMEM_{i});",
            "    if (e != cudaSuccess) return -(int)e;",
            "    if (blocks < least) least = blocks;",
            "  }",
        ]
    lines += [
        "  return least;",
        "}",
        "",
        "int bt_cons_rmw(const uint32_t* ctrl, const uint32_t* data,",
        "                const uint32_t* accum, const uint32_t* pub,",
        "                const uint32_t* w, uint64_t* acc, uint32_t* out,",
        "                unsigned m, unsigned sel0, unsigned sel1,",
        "                void* stream) {",
        "  const cudaStream_t s = (cudaStream_t)stream;",
        f"  cudaError_t e = cudaMemcpyToSymbolAsync(cpub, pub, "
        f"{4 * prog.pub_words}, 0, cudaMemcpyDeviceToDevice, s);",
        "  if (e != cudaSuccess) return (int)e;",
        "  e = cudaMemcpyToSymbolAsync(cw, w, sizeof(cw), 0, "
        "cudaMemcpyDeviceToDevice, s);",
        "  if (e != cudaSuccess) return (int)e;",
        "  const unsigned blocks = (m + TR - 1) / TR;",
    ]
    for i in range(len(parts)):
        lines += [
            f"  e = cudaFuncSetAttribute(rmw_{i}, "
            f"cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_{i});",
            "  if (e != cudaSuccess) return (int)e;",
            f"  rmw_{i}<<<blocks, TR, SMEM_{i}, s>>>(ctrl, data, accum, acc, "
            f"m, {int(i == 0)});",
        ]
    lines += [
        "  rmw_final<<<(m + 127) / 128, 128, 0, s>>>(acc, out, m, sel0, sel1);",
        "  return (int)cudaGetLastError();",
        "}",
        "",
        '}  // extern "C"',
        "",
    ]
    return "\n".join(lines)


def load(air, prog, budget, warps):
    """(name, lib) of one configuration; warps is an int or "rmw"."""
    name = f"bt_cons_{air.name}_b{budget}_w{warps}"
    vp, u = ctypes.c_void_p, ctypes.c_uint
    if warps == "rmw":
        lib = build.load_source(name, lambda: rmw_source(prog, air.name,
                                                         budget))
        lib.bt_cons_rmw.argtypes = [vp, vp, vp, vp, vp, vp, vp, u, u, u, vp]
        lib.bt_cons_rmw.restype = ctypes.c_int
    else:
        lib = build.load_source(
            name, lambda: CK.cuda_source(prog, air.name, budget, warps))
        lib.bt_cons_fused.argtypes = [vp, vp, vp, vp, vp, vp, u, u, u, vp]
        lib.bt_cons_fused.restype = ctypes.c_int
    lib.bt_cons_blocks_per_sm.argtypes = []
    lib.bt_cons_blocks_per_sm.restype = ctypes.c_int
    return name, lib


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", default="rv32i")
    ap.add_argument("--po2", type=int, default=17)
    ap.add_argument("--configs", default="1500x2,1500xrmw,1000xrmw")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("cons_budget: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    air = prove._AIRS[args.variant]
    prog = CE.trace(air)
    budgets = list(dict.fromkeys(
        (int(b), w if w == "rmw" else int(w))
        for b, w in (c.split("x") for c in args.configs.split(","))))
    libs, errors = {}, {}

    def build_one(b):
        try:
            libs[b] = load(air, prog, *b)
        except Exception as e:  # reported after every build
            errors[b] = e

    threads = [threading.Thread(target=build_one, args=(b,))
               for b in budgets]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        b, err = next(iter(errors.items()))
        raise SystemExit(f"build of {b} failed: {err}")

    rng = np.random.default_rng(7)
    m = 4 << args.po2

    def words(shape):
        return torch.from_numpy(rng.integers(0, F.P, size=shape).astype(
            np.int32)).to(dev)

    groups = [words((m, c)) for c in prog.cols]
    pub, w = words((prog.pub_words,)), words((len(prog.outputs), 4))
    acc = torch.empty((8, m), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    first = None
    for b in budgets:
        name, lib = libs[b]
        out = torch.empty((2, m, 4), dtype=torch.int32, device=dev)
        ptrs = [g.data_ptr() for g in groups] + [pub.data_ptr(), w.data_ptr()]

        def run():
            if b[1] == "rmw":
                rc = lib.bt_cons_rmw(*ptrs, acc.data_ptr(), out.data_ptr(), m,
                                     1, 2, stream)
            else:
                rc = lib.bt_cons_fused(*ptrs, out.data_ptr(), m, 1, 2, stream)
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")

        run()
        torch.cuda.synchronize()
        if first is None:
            first = out.clone()
        elif not torch.equal(out, first):
            raise SystemExit(f"{b} differs from {budgets[0]}")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            run()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 5
        log = build.PTXAS_LOG.get(name, "")
        parts = CK.schedule(prog, b[0])
        ops = sum(prog.nodes[s[1]][0] in CE.ARITH
                  for _, _, st in parts for s in st if s[0] == "node")
        print(f"[budget] variant={air.name} budget={b[0]} warps={b[1]} "
              f"chunks={len(parts)} "
              f"ops_with_recomputation={ops} "
              f"registers={re.findall(r'Used (\d+) registers', log)} "
              f"spill_store_bytes="
              f"{sum(int(x) for x in re.findall(r'(\d+) bytes spill stores', log))} "
              f"blocks_per_sm={lib.bt_cons_blocks_per_sm()} "
              f"nvcc_seconds={build.BUILD_SECONDS.get(name, 0.0):.3f} "
              f"grid_rows={m} ms={ms:.4f}", flush=True)


if __name__ == "__main__":
    main()
