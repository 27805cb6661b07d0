"""Fused AIR constraint evaluation and α-combine: generated CUDA kernel.

Replaces the TPU Pallas kernel `boundless_tpu/air/pallas_eval.py`
`_cons_kernel` (:380), launched by `combined_eval` (:419, call :474), and
the α-combine that follows it there (:488-505). For every row r of the
M-row 4N coset grid it evaluates the stacked constraint values of
`air.constraints` on `now` = row r and `nxt` = row (r + INV_RATE) mod M of
the ctrl, data and accum evaluations, and folds each value C_k into its
divisor class at once: the kernel returns Σ_k α^k C_k per class as
(M, 4) ext columns, the list `cons_eval.combine_rows` computes from the
(K, M) rows. The rows never reach device memory.

The kernel source is generated: `air/cons_eval.trace` records the AIR's
constraints once per layout as an SSA program, and `cuda_source` prints
it as CUDA C (`bb::` Montgomery arithmetic from `csrc/babybear.cuh`), one
thread per row. The schedule (`schedule`) is shared by the printer and
the CPU tests:

  * the outputs are cut into chunks of consecutive rows whose cones stay
    within `OP_BUDGET` arithmetic nodes; each chunk is one `__noinline__`
    device function (a node two chunks share is computed in both, and no
    value lives across chunks), all called in turn by one kernel;
  * inside a chunk the nodes are emitted in the program's creation
    order, and each output is consumed as soon as it exists: 4 unreduced
    64-bit products C_k * w_k[c] (IMAD.WIDE) added to the accumulator of
    its class (the program's `zclass`: 0 = trans, 1 = point) and
    component, with a fold
    hi * (2^32 mod P) + lo before every fourth term, so no accumulator
    passes 2^64; one Montgomery reduction per accumulator at the end;
  * the weights `cons_eval.alpha_weight_rows` (K, 4) and the packed public
    vector are data, copied to `__constant__` memory on the stream before
    the launch (uniform operands of the IMADs): one compiled kernel serves
    every α, every publics value and both class layouts. The launches of
    one library must therefore share a stream.

Reads: a block of TR = 32 rows stages rows r0 .. r0 + TR + INV_RATE - 1 of
all three groups (contiguous runs of the row-major evaluations, the last
tile wrapping to rows 0..) into shared memory with coalesced `cp.async`,
once for all chunks, at an odd row stride so that the warp's 32 rows hit
32 banks. The tile of every column bounds the blocks per SM (the C entry
`bt_cons_blocks_per_sm` reports it), so `WARPS` warps share one tile:
each runs its share of the chunks (`warp_shares`, balanced by nodes) on
the same 32 rows, and their accumulators are summed through shared
memory at the end.

What bounds it on this card: the rv32i program is 3,345 Montgomery
products and 4,082 adds or subtracts per row (`field_ops`) plus the
combine's 2,884 64-bit products and 972 folds (`combine_counts`; 52 rows
are constant zero); it reads ~1.9 KB a row and writes 16 bytes per class,
so operations set the bound at the main path's grid (`chip_smoke.py`
computes both). In practice the straight-line code is bound by latency:
the tile (~69 KB for rv32i) lets 3 blocks onto an SM, so at 2 warps a
block each scheduler holds one or two warps (`tools/cons_budget.py`
measures budgets and warps).

On a CPU tensor `evaluate_combined` runs its plain version,
`cons_eval.combine_rows` over `evaluate_plain` (the eager `constraints`
under `dsl.BaseAlg`, stacked to (K, M) rows); on a CUDA tensor it launches
the kernel or raises. `LAUNCHES` counts kernel launches.
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
OP_BUDGET = 1500  # arithmetic nodes per generated device function
TR = 32  # grid rows a block
WARPS = 2  # warps a block: each computes a share of the chunks on the tile
FOLD_EVERY = 3  # unreduced products an accumulator takes between folds
CLASSES = 2  # accumulators per component: trans (0) and point (1)


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


def row_classes(prog: CE.Program) -> list:
    """Class of each stacked row: 0 for a trans item (divides by Z_H), 1
    for a point item; every row of an item shares its class."""
    out = []
    for idx, (kind, g) in enumerate(prog.kinds):
        trans = prog.zclass[idx] if idx < len(prog.zclass) else True
        out += [0 if trans else 1] * CE.rows_of(((kind, g),))
    return out


def schedule(prog: CE.Program, budget: int = OP_BUDGET) -> list:
    """The kernel's work, chunk by chunk: [(lo, hi, steps), ...] with steps
    ("node", i) (compute node i), ("acc", k, slot) (add row k's value times
    its weight component slot % 4 to accumulator slot = 4 * class + c)
    and ("fold", slot). Nodes come in the program's creation order; an
    output's products follow its last node. A chunk starts and ends with
    every accumulator it touches folded (or zero)."""
    cls = row_classes(prog)
    out = []
    for lo, hi, ids in chunks(prog, budget):
        steps, terms = [], {}
        ready = {}  # node id -> outputs whose last node it is
        for k in range(lo, hi):
            ready.setdefault(prog.outputs[k], []).append(k)
        for i in ids:
            steps.append(("node", i))
            for k in ready.get(i, []):
                op, a, _ = prog.nodes[prog.outputs[k]]
                if op == CE.LIT and a == 0:
                    continue
                for c in range(F.EXT_DEGREE):
                    slot = 4 * cls[k] + c
                    if terms.get(slot, 0) == FOLD_EVERY:
                        steps.append(("fold", slot))
                        terms[slot] = 0
                    steps.append(("acc", k, slot))
                    terms[slot] = terms.get(slot, 0) + 1
        steps += [("fold", s) for s in sorted(terms) if terms[s]]
        out.append((lo, hi, steps))
    return out


def combine_counts(prog: CE.Program, budget: int = OP_BUDGET) -> dict:
    """Per row: the combine's unreduced products, folds and final
    reductions, as the kernel does them."""
    steps = [s for _, _, st in schedule(prog, budget) for s in st]
    return {"products": sum(s[0] == "acc" for s in steps),
            "folds": sum(s[0] == "fold" for s in steps),
            "reductions": CLASSES * F.EXT_DEGREE}


def warp_shares(parts, warps: int) -> list:
    """Chunk indices per warp: the largest chunk (by nodes) first, each to
    the warp with the least work so far."""
    shares = [[] for _ in range(warps)]
    load = [0] * warps
    sizes = [sum(st[0] == "node" for st in steps) for _, _, steps in parts]
    for i in sorted(range(len(parts)), key=lambda i: -sizes[i]):
        w = load.index(min(load))
        shares[w].append(i)
        load[w] += sizes[i]
    return [sorted(sh) for sh in shares]


def _tile_layout(prog: CE.Program):
    """(column offset of each group in a tile row, odd row stride)."""
    offs, o = [], 0
    for c in prog.cols:
        offs.append(o)
        o += c
    return offs, o | 1


def _expr(nodes, i) -> str:
    op, a, _ = nodes[i]
    return f"{a}u" if op == CE.LIT else f"v{i}"


def _function(prog, index, steps) -> list:
    nodes = prog.nodes
    offs, _ = _tile_layout(prog)
    lines = [f"__device__ __noinline__ Acc cons_{index}(unsigned now, "
             "unsigned nxt, Acc a) {"]
    ops = {CE.ADD: "bb::add", CE.SUB: "bb::sub", CE.MUL: "bb::mul"}
    for step in steps:
        if step[0] == "fold":
            lines.append(f"  a.v[{step[1]}] = fold(a.v[{step[1]}]);")
            continue
        if step[0] == "acc":
            _, k, slot = step
            lines.append(f"  a.v[{slot}] += (uint64_t)"
                         f"{_expr(nodes, prog.outputs[k])} * cw[{k}][{slot % 4}];")
            continue
        i = step[1]
        op, a, b = nodes[i]
        if op == CE.LIT:
            continue
        if op == CE.COL:
            base = "nxt" if a % 2 else "now"
            rhs = f"lds({base} + {4 * (offs[a // 2] + b)}u)"
        elif op == CE.PUB:
            rhs = f"cpub[{a}]"
        elif op == CE.NEG:
            rhs = f"bb::sub(0u, {_expr(nodes, a)})"
        else:
            rhs = f"{ops[op]}({_expr(nodes, a)}, {_expr(nodes, b)})"
        lines.append(f"  const uint32_t v{i} = {rhs};")
    lines += ["  return a;", "}"]
    return lines


def cuda_source(prog: CE.Program, name: str, budget: int = OP_BUDGET,
                warps: int = WARPS) -> str:
    """The CUDA C of `prog`: one device function per chunk, the fused
    kernel (`warps` warps sharing a tile of TR rows, each running its
    share of the chunks) and the C entry points."""
    parts = schedule(prog, budget)
    shares = warp_shares(parts, warps)
    offs, stride = _tile_layout(prog)
    k = len(prog.outputs)
    lines = [
        f"// Generated by boundless_tpu_torch/kernels/cons.py from the "
        f"{name} constraints",
        f"// ({k} rows, {len(parts)} chunks of at most {budget} operations, "
        f"alpha-combined per class, {warps} warps a block). Do not edit.",
        "#include <cuda_runtime.h>",
        "#include <stdint.h>",
        "",
        '#include "babybear.cuh"',
        "",
        "namespace {",
        "",
        f"constexpr unsigned NEXT = {INV_RATE};",
        f"constexpr unsigned TR = {TR};",
        f"constexpr unsigned NW = {warps};  // warps a block",
        f"constexpr unsigned STRIDE = {stride};  // words a tile row (odd)",
        f"constexpr unsigned SMEM = (TR + NEXT) * STRIDE * 4;",
        f"constexpr uint64_t FOLD = {(1 << 32) % F.P}ull;  // 2^32 mod P",
        "",
        f"__constant__ uint32_t cpub[{max(1, prog.pub_words)}];",
        f"__constant__ uint32_t cw[{k}][4];",
        "",
        f"struct Acc {{ uint64_t v[{CLASSES * F.EXT_DEGREE}]; }};",
        "",
        "__device__ __forceinline__ uint32_t lds(unsigned addr) {",
        "  uint32_t v;",
        '  asm("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr));',
        "  return v;",
        "}",
        "",
        "// t < 2^64 -> a value < 2^60 congruent to t mod P.",
        "__device__ __forceinline__ uint64_t fold(uint64_t t) {",
        "  return (uint64_t)(uint32_t)(t >> 32) * FOLD + (uint32_t)t;",
        "}",
        "",
        "// Montgomery reduction of t < P * 2^32: t * 2^-32 mod P.",
        "__device__ __forceinline__ uint32_t redc(uint64_t t) {",
        "  const uint32_t q = (uint32_t)t * bb::NP;",
        "  const uint32_t r = (uint32_t)((t + (uint64_t)q * bb::P) >> 32);",
        "  return r >= bb::P ? r - bb::P : r;",
        "}",
        "",
    ]
    for index, (_, _, steps) in enumerate(parts):
        lines += _function(prog, index, steps) + [""]
    lines += [
        "// Rows r0 .. r0 + TR + NEXT - 1 (mod m) of one (m, cols) group into",
        "// the tile at column `off`, one coalesced 4-byte cp.async a word.",
        "template <unsigned COLS, unsigned OFF>",
        "__device__ __forceinline__ void stage(unsigned tile, "
        "const uint32_t* __restrict__ g,",
        "                                      unsigned r0, unsigned m) {",
        "  for (unsigned t = 0; t < TR + NEXT; ++t) {",
        "    unsigned row = r0 + t;",
        "    while (row >= m) row -= m;",
        "    const uint32_t* src = g + (size_t)row * COLS;",
        "    const unsigned dst = tile + 4u * (t * STRIDE + OFF);",
        "    for (unsigned c = threadIdx.x; c < COLS; c += TR * NW)",
        '      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"',
        '                   :: "r"(dst + 4u * c), "l"(src + c));',
        "  }",
        "}",
        "",
        "__global__ void __launch_bounds__(TR * NW)",
        "cons_fused(const uint32_t* __restrict__ ctrl, "
        "const uint32_t* __restrict__ data,",
        "           const uint32_t* __restrict__ accum, "
        "uint32_t* __restrict__ out,",
        "           unsigned m, unsigned sel0, unsigned sel1) {",
        "  extern __shared__ uint32_t smem[];",
        "  const unsigned tile = (unsigned)__cvta_generic_to_shared(smem);",
        "  const unsigned r0 = blockIdx.x * TR;",
    ]
    for g, name_ in enumerate(CE.GROUPS):
        if prog.cols[g]:
            lines.append(f"  stage<{prog.cols[g]}u, {offs[g]}u>(tile, {name_}, "
                         "r0, m);")
    lines += [
        '  asm volatile("cp.async.wait_all;" ::: "memory");',
        "  __syncthreads();",
        "  const unsigned lane = threadIdx.x % TR, warp = threadIdx.x / TR;",
        "  const unsigned now = tile + 4u * lane * STRIDE;",
        "  const unsigned nxt = now + 4u * NEXT * STRIDE;",
        "  Acc a = {};",
        "  switch (warp) {",
    ]
    for w, share in enumerate(shares):
        lines.append(f"    case {w}:")
        lines += [f"      a = cons_{index}(now, nxt, a);" for index in share]
        lines.append("      break;")
    lines += [
        "  }",
        "  // The other warps' accumulators (each < 2^60) into warp 0's,",
        "  // through the tile's memory.",
        "  __syncthreads();",
        "  uint64_t* part = reinterpret_cast<uint64_t*>(smem);",
        "  if (warp > 0)",
        "#pragma unroll",
        "    for (int i = 0; i < 8; ++i) part[((warp - 1) * 8 + i) * TR + lane] = "
        "a.v[i];",
        "  __syncthreads();",
        "  const unsigned r = r0 + lane;",
        "  if (warp > 0 || r >= m) return;",
        "  for (unsigned w = 1; w < NW; ++w)",
        "#pragma unroll",
        "    for (int i = 0; i < 8; ++i) a.v[i] += part[((w - 1) * 8 + i) * TR + lane];",
        "  uint32_t red[8];",
        "#pragma unroll",
        "  for (int i = 0; i < 8; ++i) red[i] = redc(fold(a.v[i]));",
        "  const unsigned sel[2] = {sel0, sel1};",
        "#pragma unroll",
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
        f"int bt_cons_rows() {{ return {k}; }}",
        f"int bt_cons_chunks() {{ return {len(parts)}; }}",
        "",
        "// Blocks of the kernel that fit on one SM, or a negative CUDA error.",
        "int bt_cons_blocks_per_sm() {",
        "  cudaError_t e = cudaFuncSetAttribute(",
        "      cons_fused, cudaFuncAttributeMaxDynamicSharedMemorySize, "
        "(int)SMEM);",
        "  if (e != cudaSuccess) return -(int)e;",
        "  int blocks = 0;",
        "  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, "
        "cons_fused, TR * NW, SMEM);",
        "  return e == cudaSuccess ? blocks : -(int)e;",
        "}",
        "",
        "// Copies the packed public vector and the (K, 4) weights (device",
        "// pointers) to constant memory on the stream, then evaluates the m",
        "// rows of the contiguous row-major (m, C) ctrl/data/accum",
        "// evaluations; output o < (sel1 ? 2 : 1) is the contiguous (m, 4)",
        "// block o of `out`, the sum of the class accumulators whose bits",
        "// are set in sel_o (1: trans, 2: point). Returns the first CUDA",
        "// error, else cudaGetLastError() after the launch.",
        "int bt_cons_fused(const uint32_t* ctrl, const uint32_t* data,",
        "                  const uint32_t* accum, const uint32_t* pub,",
        "                  const uint32_t* w, uint32_t* out, unsigned m,",
        "                  unsigned sel0, unsigned sel1, void* stream) {",
        "  const cudaStream_t s = (cudaStream_t)stream;",
        "  cudaError_t e = cudaMemcpyToSymbolAsync(cpub, pub, "
        f"{4 * prog.pub_words}, 0,",
        "                                          "
        "cudaMemcpyDeviceToDevice, s);",
        "  if (e != cudaSuccess) return (int)e;",
        "  e = cudaMemcpyToSymbolAsync(cw, w, sizeof(cw), 0, "
        "cudaMemcpyDeviceToDevice, s);",
        "  if (e != cudaSuccess) return (int)e;",
        "  e = cudaFuncSetAttribute(cons_fused, "
        "cudaFuncAttributeMaxDynamicSharedMemorySize,",
        "                           (int)SMEM);",
        "  if (e != cudaSuccess) return (int)e;",
        "  cons_fused<<<(m + TR - 1) / TR, TR * NW, SMEM, s>>>(ctrl, data, "
        "accum, out, m,",
        "                                                    sel0, sel1);",
        "  return (int)cudaGetLastError();",
        "}",
        "",
        '}  // extern "C"',
        "",
    ]
    return "\n".join(lines)


def _lib(air, prog):
    name = f"bt_cons_{air.name}"
    lib = build.load_source(name, lambda: cuda_source(prog, air.name))
    if not getattr(lib, "_bt_typed", False):
        vp, u = ctypes.c_void_p, ctypes.c_uint
        lib.bt_cons_fused.argtypes = [vp, vp, vp, vp, vp, vp, u, u, u, vp]
        lib.bt_cons_fused.restype = ctypes.c_int
        for fn in (lib.bt_cons_rows, lib.bt_cons_chunks,
                   lib.bt_cons_blocks_per_sm):
            fn.argtypes, fn.restype = [], ctypes.c_int
        if lib.bt_cons_rows() != len(prog.outputs):
            raise RuntimeError(f"{name}: the built kernel has "
                               f"{lib.bt_cons_rows()} rows, the program "
                               f"{len(prog.outputs)}")
        lib._bt_typed = True
    return lib


def build_kernels(air):
    """Build (or load) the AIR's constraint kernel; returns the library."""
    return _lib(air, CE.trace(air))


def blocks_per_sm(air) -> int:
    """Blocks of the AIR's kernel that fit on one SM of the card."""
    n = build_kernels(air).bt_cons_blocks_per_sm()
    if n < 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {-n}")
    return n


def evaluate_plain(air, ctrl_evals, data_evals, accum_evals, globals_, pub):
    """Plain torch rows: the eager `constraints` over the grid, stacked to
    (K, M) in the order of the program's `kinds`."""
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


def evaluate(air, ctrl_evals, data_evals, accum_evals, globals_, pub):
    """(K, M) constraint rows of `air` over the M-row grid, on the CPU
    (`evaluate_plain`). The card computes only their α-combination
    (`evaluate_combined`); a CUDA tensor raises."""
    if data_evals.device.type != "cpu":
        raise ValueError("the constraint rows are computed on the CPU only; "
                         "the card's kernel returns evaluate_combined")
    return evaluate_plain(air, ctrl_evals, data_evals, accum_evals, globals_,
                          pub)


def selectors(prog: CE.Program, masks) -> list:
    """The kernel's output selectors for per-item keep-masks (None keeps
    all): bit 1 takes the trans accumulator, bit 2 the point one. A mask
    must be a union of the program's classes; anything else raises."""
    cls = [0 if (prog.zclass[i] if i < len(prog.zclass) else True) else 1
           for i in range(len(prog.kinds))]
    if not 1 <= len(masks) <= 2:
        raise ValueError(f"the kernel returns 1 or 2 columns, not "
                         f"{len(masks)}")
    out = []
    for mask in masks:
        keep = [True] * len(cls) if mask is None else [bool(k) for k in mask]
        if len(keep) != len(cls):
            raise ValueError(f"mask of {len(keep)} items for {len(cls)}")
        sel = 0
        for c in (0, 1):
            kept = {k for k, cc in zip(keep, cls) if cc == c}
            if len(kept) > 1:
                raise ValueError("a keep-mask splits a divisor class")
            if kept == {True}:
                sel |= 1 << c
        out.append(sel)
    return out


def _check(x: torch.Tensor, name: str, m: int, cols: int):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be an int32 CUDA tensor, got {x!r}")
    if x.device.type != "cuda" or x.dtype != torch.int32:
        raise TypeError(f"{name} must be an int32 CUDA tensor, got "
                        f"{x.dtype} on {x.device}")
    if tuple(x.shape) != (m, cols) or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous ({m}, {cols}) tensor, "
                         f"got {tuple(x.shape)}")


def evaluate_combined(air, ctrl_evals, data_evals, accum_evals, globals_,
                      pub, alpha, masks):
    """Σ_k α^k C_k over the M-row grid, once per item keep-mask -> [(M, 4),
    ...]: the generated kernel on a CUDA tensor, `combine_rows` of
    `evaluate_plain` on a CPU tensor."""
    prog = CE.trace(air)
    if data_evals.device.type == "cpu":
        rows = evaluate_plain(air, ctrl_evals, data_evals, accum_evals,
                              globals_, pub)
        return CE.combine_rows(prog.kinds, rows, alpha, masks)
    return launch(air, ctrl_evals, data_evals, accum_evals,
                  air.cons_pub_pack(pub, globals_),
                  CE.alpha_weight_rows(prog.kinds, alpha),
                  selectors(prog, masks))


def launch(air, ctrl_evals, data_evals, accum_evals, pubvec, weights, sels):
    """The kernel alone, on CUDA tensors, the packed public vector
    (`air.cons_pub_pack`), the (K, 4) weights and the output selectors ->
    [(M, 4), ...]."""
    global LAUNCHES
    prog = CE.trace(air)
    m = data_evals.shape[0]
    if m < INV_RATE or m >= 1 << 31:
        raise ValueError(f"grid of {m} rows out of the kernel's range")
    for x, name, cols in zip((ctrl_evals, data_evals, accum_evals),
                             CE.GROUPS, prog.cols):
        _check(x, name, m, cols)
    _check(pubvec[None], "public vector", 1, prog.pub_words)
    _check(weights, "weights", len(prog.outputs), F.EXT_DEGREE)
    if not 1 <= len(sels) <= 2 or not all(0 < s < 4 for s in sels):
        raise ValueError(f"bad output selectors {sels}")
    lib = _lib(air, prog)
    out = torch.empty((len(sels), m, F.EXT_DEGREE), dtype=F.I32,
                      device=data_evals.device)
    with torch.cuda.device(data_evals.device):
        stream = torch.cuda.current_stream(data_evals.device).cuda_stream
        rc = lib.bt_cons_fused(ctrl_evals.data_ptr(), data_evals.data_ptr(),
                               accum_evals.data_ptr(), pubvec.data_ptr(),
                               weights.data_ptr(), out.data_ptr(), m,
                               sels[0], sels[1] if len(sels) > 1 else 0,
                               stream)
    if rc != 0:
        raise RuntimeError(f"constraint kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return list(out.unbind(0))
