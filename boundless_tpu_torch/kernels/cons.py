"""Fused AIR constraint evaluation: generated CUDA kernels.

Replaces the TPU Pallas kernel `boundless_tpu/air/pallas_eval.py`
`_cons_kernel` (:380), launched by `combined_eval` (:419, call :474). For
every row r of the M-row 4N coset grid it evaluates the stacked constraint
values of `air.constraints` on `now` = row r and `nxt` = row
(r + INV_RATE) mod M of the ctrl, data and accum evaluations and writes the
(K, M) int32 rows in the order of the program's `kinds` (a vec item gives
G rows, an ext item 4, a base item 1).

The kernel source is generated: `air/cons_eval.trace` records the AIR's
constraints once per layout as an SSA program, and `cuda_source` prints it
as CUDA C, one `uint32_t` per value and `bb::` Montgomery arithmetic from
`csrc/babybear.cuh`, one thread per row. Column reads index the row-major
(M, C) evaluation tensors at rows r and r + INV_RATE in the kernel (no
pre-rolled copies); each output row is one coalesced store into (K, M).
The K outputs are cut into chunks of at most `OP_BUDGET` arithmetic nodes,
each its own `__global__` function holding only the nodes its rows need
(a node two chunks share is computed in both); all chunks sit in one
source, built by one nvcc call into `build/` under the hash of the text,
and one C call launches them in sequence. The budget keeps every function
inside what nvcc's front end and register allocator handle (a fully
unrolled Poseidon2 crashed cicc, csrc/poseidon2.cu).

What bounds it on this card: the rv32i program is 3,345 Montgomery
products and 4,082 adds or subtracts per row (`field_ops`), ~32,000
32-bit instructions a row, which the SMs issue at 128 a clock; the ~1.9 KB
read (480 columns) and ~3 KB written (773 rows) a row take longer at the
memory's rate, so bytes set the bound at the main path's grid
(`chip_smoke.py` computes both). The design keeps every value in
registers; the reads are uncoalesced (a warp's 32 rows are C words
apart), which later work can fix by staging row tiles through shared
memory.

On a CPU tensor `evaluate` runs `evaluate_plain` (the eager `constraints`
under `dsl.BaseAlg` on the same grid, stacked to (K, M)); on a CUDA tensor
it launches the kernels or raises. `LAUNCHES` counts kernel launches (one
per chunk).
"""

from __future__ import annotations

import ctypes

import torch

from ..air import cons_eval as CE
from ..air.dsl import BaseAlg, Columns
from ..core import field as F
from ..core.ntt import INV_RATE
from . import build

LAUNCHES = 0
OP_BUDGET = 1500  # arithmetic nodes per generated __global__ function
THREADS = 128


def field_ops(prog: CE.Program) -> tuple:
    """(products, additive operations) one row of the program needs: its
    live `bb::mul` nodes, and its live `bb::add`/`bb::sub` nodes (a
    negation is a subtract)."""
    kinds = [prog.nodes[i][0] for i in prog.live()]
    return (kinds.count(CE.MUL),
            sum(kinds.count(k) for k in (CE.ADD, CE.SUB, CE.NEG)))


def chunks(prog: CE.Program, budget: int = OP_BUDGET):
    """[(first output, last output + 1, sorted node ids), ...]: runs of
    consecutive outputs whose combined cones stay within `budget`
    arithmetic nodes (a single larger cone makes a chunk of its own)."""
    nodes = prog.nodes
    out = []
    start, cur, ops = 0, set(), 0

    def cone(root, have):
        new, stack = set(), [root]
        while stack:
            i = stack.pop()
            if i in have or i in new:
                continue
            new.add(i)
            op, a, b = nodes[i]
            if op in CE.ARITH:
                stack.append(a)
                if b is not None:
                    stack.append(b)
        return new

    for k, root in enumerate(prog.outputs):
        new = cone(root, cur)
        add = sum(nodes[i][0] in CE.ARITH for i in new)
        if k > start and ops + add > budget:
            out.append((start, k, sorted(cur)))
            start, cur, ops = k, set(), 0
            new = cone(root, cur)
            add = sum(nodes[i][0] in CE.ARITH for i in new)
        cur |= new
        ops += add
    out.append((start, len(prog.outputs), sorted(cur)))
    return out


def _expr(nodes, i) -> str:
    op, a, _ = nodes[i]
    return f"{a}u" if op == CE.LIT else f"v{i}"


def _function(prog, index, lo, hi, ids) -> list:
    nodes = prog.nodes
    lines = [
        f"__global__ void __launch_bounds__({THREADS})",
        f"cons_{index}(const uint32_t* __restrict__ ctrl, "
        "const uint32_t* __restrict__ data,",
        "       const uint32_t* __restrict__ accum, "
        "const uint32_t* __restrict__ pub,",
        "       uint32_t* __restrict__ out, unsigned m) {",
        "  const unsigned r = blockIdx.x * blockDim.x + threadIdx.x;",
        "  if (r >= m) return;",
        "  const unsigned rn = r + NEXT < m ? r + NEXT : r + NEXT - m;",
    ]
    for g, name in enumerate(CE.GROUPS):
        c = prog.cols[g]
        lines.append(f"  const uint32_t* g{2 * g} = {name} + (size_t)r * {c};")
        lines.append(f"  const uint32_t* g{2 * g + 1} = {name} + "
                     f"(size_t)rn * {c};")
    ops = {CE.ADD: "bb::add", CE.SUB: "bb::sub", CE.MUL: "bb::mul"}
    for i in ids:
        op, a, b = nodes[i]
        if op == CE.LIT:
            continue
        if op == CE.COL:
            rhs = f"g{a}[{b}]"
        elif op == CE.PUB:
            rhs = f"pub[{a}]"
        elif op == CE.NEG:
            rhs = f"bb::sub(0u, {_expr(nodes, a)})"
        else:
            rhs = f"{ops[op]}({_expr(nodes, a)}, {_expr(nodes, b)})"
        lines.append(f"  const uint32_t v{i} = {rhs};")
    for k in range(lo, hi):
        lines.append(f"  out[(size_t){k} * m + r] = "
                     f"{_expr(nodes, prog.outputs[k])};")
    lines.append("}")
    return lines


def cuda_source(prog: CE.Program, name: str, budget: int = OP_BUDGET) -> str:
    """The CUDA C of `prog`: one `__global__` function per chunk and the C
    entry points `bt_cons_rows`, `bt_cons_chunks` and `bt_cons_eval`."""
    parts = chunks(prog, budget)
    lines = [
        f"// Generated by boundless_tpu_torch/kernels/cons.py from the "
        f"{name} constraints",
        f"// ({len(prog.outputs)} rows, {len(parts)} chunks of at most "
        f"{budget} operations). Do not edit.",
        "#include <cuda_runtime.h>",
        "#include <stdint.h>",
        "",
        '#include "babybear.cuh"',
        "",
        "namespace {",
        "",
        f"constexpr unsigned NEXT = {INV_RATE};",
        "",
    ]
    for index, (lo, hi, ids) in enumerate(parts):
        lines += _function(prog, index, lo, hi, ids) + [""]
    lines += [
        "}  // namespace",
        "",
        'extern "C" {',
        "",
        f"int bt_cons_rows() {{ return {len(prog.outputs)}; }}",
        f"int bt_cons_chunks() {{ return {len(parts)}; }}",
        "",
        "// Evaluates every chunk over the m rows of the contiguous row-major",
        "// (m, C) ctrl/data/accum evaluations and the packed public vector;",
        "// writes the contiguous (K, m) output. Returns cudaGetLastError()",
        "// after the first launch that failed, else after the last one.",
        "int bt_cons_eval(const uint32_t* ctrl, const uint32_t* data,",
        "                 const uint32_t* accum, const uint32_t* pub,",
        "                 uint32_t* out, unsigned m, void* stream) {",
        f"  const unsigned blocks = (m + {THREADS - 1}) / {THREADS};",
        "  const cudaStream_t s = (cudaStream_t)stream;",
        "  cudaError_t e = cudaSuccess;",
    ]
    for index in range(len(parts)):
        lines += [
            f"  cons_{index}<<<blocks, {THREADS}, 0, s>>>(ctrl, data, accum, "
            "pub, out, m);",
            "  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;",
        ]
    lines += ["  return (int)e;", "}", "", '}  // extern "C"', ""]
    return "\n".join(lines)


def _lib(air, prog):
    name = f"bt_cons_{air.name}"
    lib = build.load_source(name, lambda: cuda_source(prog, air.name))
    if not getattr(lib, "_bt_typed", False):
        vp = ctypes.c_void_p
        lib.bt_cons_eval.argtypes = [vp, vp, vp, vp, vp, ctypes.c_uint, vp]
        lib.bt_cons_eval.restype = ctypes.c_int
        for fn in (lib.bt_cons_rows, lib.bt_cons_chunks):
            fn.argtypes, fn.restype = [], ctypes.c_int
        if lib.bt_cons_rows() != len(prog.outputs):
            raise RuntimeError(f"{name}: the built kernel has "
                               f"{lib.bt_cons_rows()} rows, the program "
                               f"{len(prog.outputs)}")
        lib._bt_typed = True
    return lib


def build_kernels(air):
    """Build (or load) the AIR's constraint kernels; returns the library."""
    return _lib(air, CE.trace(air))


def evaluate_plain(air, ctrl_evals, data_evals, accum_evals, globals_, pub):
    """Plain torch version: the eager `constraints` over the grid, stacked
    to the kernel's (K, M) rows."""
    from ..prover.stark import ExtVal, VecVal, _ColAccessor

    m = data_evals.shape[0]
    evals = (ctrl_evals, data_evals, accum_evals)
    now = Columns(*(_ColAccessor(e) for e in evals))
    nxt = Columns(*(_ColAccessor(torch.roll(e, -INV_RATE, 0)) for e in evals))
    cons = air.constraints(BaseAlg(data_evals.device), now, nxt, globals_,
                           pub)
    rows = []
    for c in cons:
        if isinstance(c, (VecVal, ExtVal)):
            v = c.v
            rows.append(v.expand(m, v.shape[-1]).T)
        else:
            rows.append(c.expand(m)[None])
    return torch.cat(rows, 0)


def _check(x: torch.Tensor, name: str, m: int, cols: int):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be an int32 CUDA tensor, got {x!r}")
    if x.device.type != "cuda" or x.dtype != torch.int32:
        raise TypeError(f"{name} must be an int32 CUDA tensor, got "
                        f"{x.dtype} on {x.device}")
    if tuple(x.shape) != (m, cols) or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous ({m}, {cols}) tensor, "
                         f"got {tuple(x.shape)}")


def evaluate(air, ctrl_evals, data_evals, accum_evals, globals_, pub):
    """(K, M) constraint rows of `air` over the M-row grid: the generated
    kernels on a CUDA tensor, `evaluate_plain` on a CPU tensor."""
    if data_evals.device.type == "cpu":
        return evaluate_plain(air, ctrl_evals, data_evals, accum_evals,
                              globals_, pub)
    return launch(air, ctrl_evals, data_evals, accum_evals,
                  air.cons_pub_pack(pub, globals_))


def launch(air, ctrl_evals, data_evals, accum_evals, pubvec):
    """The kernels alone, on CUDA tensors and the packed public vector
    (`air.cons_pub_pack`) -> (K, M) rows."""
    global LAUNCHES
    prog = CE.trace(air)
    m = data_evals.shape[0]
    if m < INV_RATE or m >= 1 << 31:
        raise ValueError(f"grid of {m} rows out of the kernel's range")
    for x, name, cols in zip((ctrl_evals, data_evals, accum_evals),
                             CE.GROUPS, prog.cols):
        _check(x, name, m, cols)
    _check(pubvec[None], "public vector", 1, prog.pub_words)
    lib = _lib(air, prog)
    out = torch.empty((len(prog.outputs), m), dtype=F.I32,
                      device=data_evals.device)
    with torch.cuda.device(data_evals.device):
        stream = torch.cuda.current_stream(data_evals.device).cuda_stream
        rc = lib.bt_cons_eval(ctrl_evals.data_ptr(), data_evals.data_ptr(),
                              accum_evals.data_ptr(), pubvec.data_ptr(),
                              out.data_ptr(), m, stream)
    if rc != 0:
        raise RuntimeError(f"constraint kernel launch failed: CUDA error {rc}")
    LAUNCHES += lib.bt_cons_chunks()
    return out
