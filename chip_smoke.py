"""GPU smoke run of the PyTorch/CUDA port's main path (one NVIDIA card).

    python3 chip_smoke.py

Phases, one line each (or a few); any failure raises and exits non-zero:
  1. device   a CUDA card is required (nothing runs on the CPU); prints
              `nvidia-smi --query-gpu=name,power.limit` and the card's
              int32 issue rate (SMs x 128 per clock x the maximum SM
              clock; each bound also holds the FMA and ALU pipes to 64).
  2. build    compiles the three kernel libraries with nvcc for sm_90a, one
              nvcc per library, all started together: the Poseidon2 sponge
              (csrc/poseidon2.cu), the NTT sub-transform (csrc/ntt.cu) and
              the generated fused constraint kernels of both AIR variants
              (kernels/cons.py), plus the issue-rate probe; prints nvcc
              seconds, registers, spills and blocks per SM.
  3. probe    independent chains of bb::mul and of bb::add on every SM:
              achieved operations and 32-bit instructions per second beside
              the published issue rate the bounds use.
  4. kernel   each kernel against its plain torch version on the card, bit
              for bit (tolerance 0: field words). Sponge: N in {1, 1000,
              1024, 2^18} x C in {0, 7, 16, 384}, the main path's sponge
              shapes, pairs at 2^17 and transcript permutations. NTT: the
              sub-transform at M in {2, 64, 512, 1024} x L in {1, 7, 128,
              392}, both directions, with the four-step store; the whole
              four-step at the main path's
              transforms; the LDE glue the kernel folds in (coset_evaluate's
              zero-skip shifted load, intt's and coset_interpolate's scaled
              stores) at the main path's shapes. Times the sponge at the
              leaf shape, the NTT at 2^19 x 392 (and each of its two
              launches) and the data LDE with CUDA events.
  5. golden   the port's po2-8 TEST_PS proofs on the card equal the JAX
              reference proofs stored in tests/data/torch_golden_po2_8.npz;
              every kernel launched in them; the fused constraint kernel's
              columns on both golden grids equal the plain version's.
  6. main     the loop guest at po2 17 (as bench.py): executor -> witness
              (the native C++ generator) -> prove_segment (100 queries,
              rate 1/2, rv32i) on the card, verify_segment accepts it and
              rejects a tampered claim. The launch counts are zeroed just
              before the executor and read right after the proof: sponge,
              NTT and constraint kernels must each be > 0 (the verifier's
              sponge launches are counted apart), and the eager α-combine
              (`cons_eval.combine_rows`) must not have run. Then the fused
              constraint kernel against its plain version on the proof's
              own 4N grid, bit for bit, and both timed.
  7. recursion the sponge at 2^21 x 64 and the NTT at 2^22 x 64 forward
              (three launches) bit for bit against their plain versions and
              timed; the port's production ROMs (rv32i lift of po2-17
              DEFAULT_PS segments, rec_po2-20 q50 join and resolve) equal
              the JAX package's sha256 digests in
              tests/data/torch_rec_golden.npz; then the chain: the main
              path's loop session (two po2-17 segments), prove_segment of
              both on the
              card, segment_pre_chains, SuccinctSystem at rec_po2 20
              (50 queries, rate 1/2, rv32i), lift both, join, finalize and
              verify_session. Every receipt verifies; a join receipt with
              one proof word bumped and a claim with post_pc changed are
              rejected. Launch counts are zeroed just before each proof and
              read right after: sponge and NTT > 0 in every proof, the
              constraint kernel > 0 in the segment proofs and 0 in the
              recursion proofs (RecursionAir takes the degree-split
              route); every recursion data trace came from the native
              rec_eval. Prints the host seconds of each stage, the
              quotient stage's seconds and the peak device memory of each
              recursion proof.
  8. coproc   the sponge at 2^11 x 4048 and the NTT at 2^11 x 4048 (with
              the LDE glue at the KeccakAir trace's 2^10 x 4048) bit for bit
              against their plain versions and timed; the keccak guest's
              po2-17 rv32im segment proof (DEFAULT_PS) with the fused
              constraint kernel checked on its 4N grid; the production ROMs
              of both lattices at rec_po2 21 (rv32im lift, join, resolve,
              lift_keccak at kec_po2 10 q50, union, and resolve_coproc built
              with the golden's placeholder constants) equal the JAX sha256
              digests of tests/data/torch_keccak_golden.npz, and the keccak
              circuit id equals JAX's; then the guest's batch as a KeccakAir
              proof -> lift_keccak, the segment -> lift, resolve_coproc ->
              finalize_session -> verify_session; then two chained random
              batches (42 + 17 permutations) -> lift_keccak each -> union
              over 0 -> 59. Tampers rejected: a bumped public state limb, a
              lift_keccak proof with one word bumped, a resolve_coproc claim
              with post_coproc changed; finalize_session on the undischarged
              lift raises, and so does a union in the wrong order. Launch
              counts are zeroed before each proof and read after: sponge and
              NTT > 0 in every proof, the constraint kernel > 0 only in the
              segment proof; every recursion data trace came from rec_eval.
The last two lines are the kernel table (each kernel's launches on the
main path, in the recursion proofs and in the coproc phase, max abs
error, ms, plain ms and bound ms) and the contract line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20260
KERNEL_SHAPES_N = (1, 1000, 1024, 1 << 18)
KERNEL_SHAPES_C = (0, 7, 16, 384)
LEAF_SHAPE = (1 << 18, 392)  # rv32i data group on the po2-17 commit domain
# Sponge inputs of the po2-17 rv32i main path: ctrl / data / accum / check
# leaves on the 2^18-row commit domain, a FRI group matrix, the DEEP-tap
# transcript absorb, and opened rows at 100 queries.
MAIN_PATH_SHAPES = ((1 << 18, 40), LEAF_SHAPE, (1 << 18, 48), (1 << 18, 16),
                    (1 << 14, 64), (1, 3904), (100, 392))
NTT_SUB_M = (2, 64, 512, 1024)
NTT_SUB_L = (1, 7, 128, 392)
# (rows, columns, forward) of the po2-17 rv32i proof's transforms: trace
# interpolation of ctrl/data/accum, their 4N LDEs and the check LDE's
# 2^19 x 16 evaluate, and the quotient's 4N coset interpolation.
NTT_MAIN_SHAPES = ((1 << 17, 40, False), (1 << 17, 392, False),
                   (1 << 17, 48, False), (1 << 19, 40, True),
                   (1 << 19, 392, True), (1 << 19, 48, True),
                   (1 << 19, 16, True), (1 << 19, 4, False))
NTT_TIME_SHAPE = (1 << 19, 392)  # the data group's 4N evaluate
# (glue, rows in, columns, expand) of the po2-17 rv32i proof: trace
# interpolation (intt), the 4N LDEs, the check LDE at rate 1/2 and the
# quotient's coset interpolation, with the kernel's folded loads/stores.
NTT_GLUE_SHAPES = (("intt", 1 << 17, 392, 1),
                   ("coset_evaluate", 1 << 17, 40, 4),
                   ("coset_evaluate", 1 << 17, 392, 4),
                   ("coset_evaluate", 1 << 17, 48, 4),
                   ("coset_evaluate", 1 << 17, 16, 2),
                   ("coset_interpolate", 1 << 19, 4, 1))
MAIN_PO2 = 17
REC_PO2 = 20  # the recursion proofs' rows (the lift is 1,035,939 wire rows)
# The recursion proofs' system: 50 queries at rate 1/2 (the JAX package's
# production sizing, docs/ROUND5.md; the segments use DEFAULT_PS).
REC_PS_ARGS = dict(queries=50, fri_min_degree=256, commit_expand=2)
REC_SPONGE_SHAPE = (1 << 21, 64)  # the data group on the rec commit domain
REC_NTT_SHAPE = (1 << 22, 64)  # the data group's 4N evaluate
REC_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_rec_golden.npz")
# The keccak coprocessor phase: KeccakAir batches at kec_po2 10 (42
# permutations, 4048 data columns) under the recursion's q50 system, and
# both lattices at rec_po2 21 (the rv32im lift of a po2-17 DEFAULT_PS
# segment is 1,175,747 wire rows, lift_keccak 1,779,976).
KEC_PO2 = 10
COPROC_REC_PO2 = 21
KEC_TRACE_SHAPE = (1 << 10, 4048)  # the data trace (interpolation, LDE)
KEC_SPONGE_SHAPE = (1 << 11, 4048)  # the data leaves on the commit domain
KEC_NTT_SHAPE = (1 << 11, 4048)
UNION_PERMS = (42, 17)  # two chained batches, united
KEC_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_keccak_golden.npz")
INV_RATE_GRID = 4  # the constraint grid's blowup (the 4N LDE)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# 32-bit integer issue of one sm_90 SM per clock: 64 on the FMA-heavy pipe
# (IMAD*), 64 on the ALU pipe (ISETP, IADD3, SEL) (CUDA C++ Programming
# Guide, arithmetic throughput table, compute capability 9.0; Nsight
# Compute's pipe list), and at most 128 thread-instructions in all: four
# schedulers issue one warp instruction each (H100 whitepaper).
PIPE_PER_CLOCK_PER_SM, ISSUE_PER_CLOCK_PER_SM = 64, 128
# 32-bit instructions of one Baby Bear operation as (FMA pipe only, ALU
# pipe only, either pipe), the sequence nvcc emits for csrc/babybear.cuh
# on sm_90a (tools/sass_mix.py): a Montgomery product is IMAD.WIDE.U32,
# IMAD, IMAD.HI.U32, a compare and two adds (carry, conditional subtract);
# a modular add or subtract is a compare and two adds. An add may issue on
# either pipe (IADD3 or IMAD.IADD); a compare only on the ALU.
MUL_MIX, ADD_MIX = (3, 1, 2), (0, 1, 2)
# One Poseidon2 permutation in csrc/poseidon2.cu: 8 external rounds (24
# S-boxes of 4 products, 24 constant adds, the 128-add external linear
# layer), 21 internal rounds (one S-box, the 24 diagonal products, 48
# adds) and the initial external linear layer.
P2_MULS = 8 * 24 * 4 + 21 * (4 + 24)
P2_ADDS = 128 + 8 * (24 + 128) + 21 * 48


def say(phase: str, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def rand_words(rng, shape, device):
    """Uniform Montgomery words in [0, P) as an int32 tensor."""
    from boundless_tpu_torch.core import field as F

    return torch.from_numpy(rng.integers(0, F.P, size=shape, dtype=np.int64)
                            .astype(np.int32)).to(device)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of `fn` over `reps` runs after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Checker:
    """Bit-for-bit comparisons of a kernel with its plain version."""

    def __init__(self):
        self.max_err = 0
        self.checked = 0

    def __call__(self, got, want, what):
        torch.cuda.synchronize()
        if got.shape != want.shape:
            raise AssertionError(f"{what}: shape {tuple(got.shape)} vs "
                                 f"{tuple(want.shape)}")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
            if got.numel() else 0
        self.max_err = max(self.max_err, err)
        self.checked += 1
        if err:
            raise AssertionError(f"{what}: kernel differs from plain torch")


def bound_ms(nbytes: float, muls: float, adds: float, sm_clocks_per_s: float,
             extra=(0, 0, 0)):
    """The least time the card could take for `muls` Baby Bear products
    and `adds` adds or subtracts (plus `extra` (FMA, ALU, either)
    instructions) over `nbytes` of memory traffic: the larger of the
    bytes' time and the slowest of the FMA pipe, the ALU pipe and the
    issue limit. -> (ms, "bytes" or "operations")."""
    fma, alu, either = (muls * m + adds * a + e
                        for m, a, e in zip(MUL_MIX, ADD_MIX, extra))
    t_ops = max(fma / PIPE_PER_CLOCK_PER_SM, alu / PIPE_PER_CLOCK_PER_SM,
                (fma + alu + either) / ISSUE_PER_CLOCK_PER_SM) / sm_clocks_per_s
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False); this script runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sm_clocks_per_s = sms * float(clock) * 1e6
    say("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, sms=sms, max_sm_mhz=clock,
        int32_issue_per_s=f"{sm_clocks_per_s * ISSUE_PER_CLOCK_PER_SM:.4e}")
    return sm_clocks_per_s


def phase_build():
    """One nvcc per library, all started together."""
    from boundless_tpu_torch.kernels import build
    from boundless_tpu_torch.kernels import cons as CK
    from boundless_tpu_torch.kernels import ntt as NK
    from boundless_tpu_torch.kernels import poseidon2 as P2K
    from boundless_tpu_torch.zkvm import prove

    jobs = {"bt_poseidon2": P2K._lib, "bt_ntt": NK._lib,
            "bt_issue_probe": probe_lib}
    for variant, air in prove._AIRS.items():
        jobs[f"bt_cons_{variant}"] = (lambda a=air: CK.build_kernels(a))
    errors = {}

    def run(name, fn):
        try:
            fn()
        except Exception as e:  # reported below, after every build
            errors[name] = e

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=item)
               for item in jobs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    occupancy = {}
    if not errors:
        # blocks per SM of the NTT at its two four-step sizes and of each
        # fused constraint kernel
        occupancy["bt_ntt"] = (f"m1024:{NK.blocks_per_sm(10)},"
                               f"m512:{NK.blocks_per_sm(9)}")
        for variant, air in prove._AIRS.items():
            occupancy[f"bt_cons_{variant}"] = CK.blocks_per_sm(air)
    for name in jobs:
        log = build.PTXAS_LOG.get(name, "")
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
        say("build", library=name, arch="sm_90a",
            nvcc_seconds=f"{build.BUILD_SECONDS.get(name, 0.0):.3f}",
            functions=len(regs), max_registers=max(regs, default=0),
            spill_store_bytes=sum(spills),
            blocks_per_sm=occupancy.get(name, "-"), ok=name not in errors)
    if "bt_ntt" in build.PTXAS_LOG:  # registers by sub-transform size
        regs = re.findall(r"Compiling entry function '\S*sub_ntt_kernel"
                          r"ILi(\d+)E\S*'.*?Used (\d+) registers",
                          build.PTXAS_LOG["bt_ntt"], re.S)
        say("build", library="bt_ntt",
            registers_by_log_m=",".join(f"{lm}:{n}" for lm, n in regs))
    say("build", parallel_wall_seconds=f"{wall:.3f}")
    if errors:
        name, err = next(iter(errors.items()))
        raise RuntimeError(f"build of {name} failed") from err


PROBE_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "babybear.cuh"
// CHAINS independent chains a thread of one Baby Bear operation.
constexpr int CHAINS = 8;
template <int OP>
__global__ void chains(uint32_t* x, unsigned iters) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t b = x[i] % bb::P;
  uint32_t a[CHAINS];
  for (int k = 0; k < CHAINS; ++k) a[k] = (x[i] + k) % bb::P;
  for (unsigned t = 0; t < iters; ++t) {
#pragma unroll
    for (int k = 0; k < CHAINS; ++k)
      a[k] = OP ? bb::add(a[k], b) : bb::mul(a[k], b);
  }
  uint32_t s = 0;
  for (int k = 0; k < CHAINS; ++k) s ^= a[k];
  x[i] = s;
}
extern "C" int bt_probe(int op, uint32_t* x, unsigned blocks,
                        unsigned threads, unsigned iters, void* stream) {
  if (op) chains<1><<<blocks, threads, 0, (cudaStream_t)stream>>>(x, iters);
  else chains<0><<<blocks, threads, 0, (cudaStream_t)stream>>>(x, iters);
  return (int)cudaGetLastError();
}
"""
PROBE_CHAINS, PROBE_ITERS, PROBE_THREADS = 8, 2048, 256


def probe_lib():
    import ctypes

    from boundless_tpu_torch.kernels import build

    lib = build.load_source("bt_issue_probe", lambda: PROBE_SOURCE)
    vp, u = ctypes.c_void_p, ctypes.c_uint
    lib.bt_probe.argtypes = [ctypes.c_int, vp, u, u, u, vp]
    lib.bt_probe.restype = ctypes.c_int
    return lib


def phase_probe(dev, sm_clocks_per_s):
    """Achieved Baby Bear operations per second in independent chains on
    every SM, and the 32-bit instructions per second they imply at the
    bound's mix (MUL_MIX, ADD_MIX), beside the published issue rate."""
    lib = probe_lib()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = sms * 2048 // PROBE_THREADS  # every SM full of threads
    x = torch.arange(blocks * PROBE_THREADS, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ops = blocks * PROBE_THREADS * PROBE_ITERS * PROBE_CHAINS
    for op, name, mix in ((0, "mul", MUL_MIX), (1, "add", ADD_MIX)):
        def run():
            rc = lib.bt_probe(op, x.data_ptr(), blocks, PROBE_THREADS,
                              PROBE_ITERS, stream)
            if rc:
                raise RuntimeError(f"probe launch failed: CUDA error {rc}")
        ms = cuda_ms(run, 5)
        per_s = ops / (ms * 1e-3)
        say("probe", op=name, chains_per_thread=PROBE_CHAINS,
            threads=blocks * PROBE_THREADS, ms=f"{ms:.4f}",
            ops_per_s=f"{per_s:.4e}", instructions_per_op=sum(mix),
            int32_instructions_per_s=f"{per_s * sum(mix):.4e}",
            published_issue_per_s=f"{sm_clocks_per_s * ISSUE_PER_CLOCK_PER_SM:.4e}")


def phase_kernel_sponge(dev, sm_clocks_per_s):
    from boundless_tpu_torch.core import poseidon2 as P2
    from boundless_tpu_torch.kernels import poseidon2 as P2K

    rng = np.random.default_rng(SEED)
    check = Checker()
    shapes = [(n, c) for n in KERNEL_SHAPES_N for c in KERNEL_SHAPES_C]
    for n, c in shapes + list(MAIN_PATH_SHAPES):
        x = rand_words(rng, (n, c), dev)
        check(P2K.hash_rows(x), P2.hash_rows(x), f"hash_rows N={n} C={c}")
    left = rand_words(rng, (1 << 17, 8), dev)
    right = rand_words(rng, (1 << 17, 8), dev)
    check(P2K.hash_pairs(left, right), P2.hash_pair(left, right),
          "hash_pairs N=2^17")
    for n in (1, 1000):
        st = rand_words(rng, (n, P2.WIDTH), dev)
        check(P2K.permute(st), P2.permute(st), f"permute N={n}")

    leaf = rand_words(rng, LEAF_SHAPE, dev)
    ms = cuda_ms(lambda: P2K.hash_rows(leaf), 10)
    plain_ms = cuda_ms(lambda: P2.hash_rows(leaf), 2)
    n, c = LEAF_SHAPE
    perms = n * -(-c // P2.RATE)
    bms, by = bound_ms(4 * n * (c + P2.DIGEST_WORDS), perms * P2_MULS,
                       perms * P2_ADDS + n * c, sm_clocks_per_s)
    say("kernel", kernel="poseidon2_sponge", checked=check.checked,
        tolerance=0, max_abs_err=check.max_err, shape=f"{n}x{c}",
        permutations=perms, kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        bound_ms=f"{bms:.4f}", bound_by=by)
    return dict(max_abs_err=check.max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by)


def phase_kernel_ntt(dev, sm_clocks_per_s):
    from boundless_tpu_torch.core import ntt as NTT
    from boundless_tpu_torch.kernels import ntt as NK

    rng = np.random.default_rng(SEED + 1)
    check = Checker()
    for m in NTT_SUB_M:
        for lanes in NTT_SUB_L:
            x = rand_words(rng, (m, lanes), dev)
            for fw in (True, False):
                check(NK.sub_ntt(x, fw), NTT.stockham(x, fw),
                      f"sub_ntt M={m} L={lanes} forward={fw}")
            n2 = 7 if lanes % 7 == 0 else (32 if lanes % 32 == 0 else 1)
            mid = rand_words(rng, (m, n2), dev)
            check(NK.sub_ntt(x, True, mid), NK.sub_ntt_plain(x, True, mid),
                  f"sub_ntt M={m} L={lanes} four-step store")
    for n, c, fw in NTT_MAIN_SHAPES:
        x = rand_words(rng, (n, c), dev)
        check(NTT.ntt(x, fw), NTT.stockham(x, fw),
              f"four-step N={n} C={c} forward={fw}")
    glue = {"intt": (NTT.intt, NTT.intt_plain),
            "coset_evaluate": (NTT.coset_evaluate, NTT.coset_evaluate_plain),
            "coset_interpolate": (NTT.coset_interpolate,
                                  NTT.coset_interpolate_plain)}
    for name, n, c, expand in NTT_GLUE_SHAPES:
        x = rand_words(rng, (n, c), dev)
        fused, plain = glue[name]
        args = () if name == "intt" else (expand,)
        check(fused(x, *args), plain(x, *args),
              f"{name} N={n} C={c} expand={expand}")

    n, c = NTT_TIME_SHAPE
    x = rand_words(rng, NTT_TIME_SHAPE, dev)
    before = NK.LAUNCHES
    NTT.ntt(x)
    per_call = NK.LAUNCHES - before
    ms = cuda_ms(lambda: NTT.ntt(x), 10)
    plain_ms = cuda_ms(lambda: NTT.stockham(x), 2)
    butterflies = c * (n // 2) * (n.bit_length() - 1)
    nbytes = 2 * 4 * n * c  # the input read once, the output written once
    bms, by = bound_ms(nbytes, butterflies, 2 * butterflies, sm_clocks_per_s)
    floor = per_call * nbytes / HBM_BYTES_PER_S * 1e3  # each launch's pass
    # each launch of the four-step alone: the first with the mid twiddle
    # and the transposed store, the second a plain sub-transform
    n1, n2 = NTT._split(n)
    first = x.reshape(n1, n2 * c)
    mid = NTT._mid_twiddles(n1, n2, True, dev)
    first_ms = cuda_ms(lambda: NK.sub_ntt(first, True, mid), 10)
    second = NK.sub_ntt(first, True, mid)
    second_ms = cuda_ms(lambda: NK.sub_ntt(second, True), 10)
    coeffs = rand_words(rng, (n // INV_RATE_GRID, c), dev)
    lde_ms = cuda_ms(lambda: NTT.coset_evaluate(coeffs), 10)
    lde_plain_ms = cuda_ms(lambda: NTT.coset_evaluate_plain(coeffs), 2)
    say("kernel", kernel="ntt_sub_transform", checked=check.checked,
        tolerance=0, max_abs_err=check.max_err, shape=f"{n}x{c}",
        launches_per_transform=per_call, kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        bound_ms=f"{bms:.4f}", bound_by=by, floor_ms_two_launches=f"{floor:.4f}",
        launch_ms=f"{n1}x{n2 * c}+mid:{first_ms:.4f},{n2}x{n1 * c}:"
                  f"{second_ms:.4f}",
        lde_shape=f"{n // INV_RATE_GRID}x{c}->{n}", lde_ms=f"{lde_ms:.4f}",
        lde_plain_ms=f"{lde_plain_ms:.4f}")
    return dict(max_abs_err=check.max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by)


class CaptureCons:
    """Records the inputs of every constraint-kernel call while active."""

    def __enter__(self):
        from boundless_tpu_torch.kernels import cons as CK

        self.calls, self._ck, self._orig = [], CK, CK.evaluate_combined

        def evaluate_combined(air, *args):
            self.calls.append((air, args))
            return self._orig(air, *args)

        CK.evaluate_combined = evaluate_combined
        return self

    def __exit__(self, *exc):
        self._ck.evaluate_combined = self._orig


class ForbidCombineRows:
    """Counts calls of the eager α-combine (`cons_eval.combine_rows`) while
    active: the card's route must not make any."""

    def __enter__(self):
        from boundless_tpu_torch.air import cons_eval as CE

        self.calls, self._ce, self._orig = 0, CE, CE.combine_rows

        def combine_rows(*args, **kwargs):
            self.calls += 1
            return self._orig(*args, **kwargs)

        CE.combine_rows = combine_rows
        return self

    def __exit__(self, *exc):
        self._ce.combine_rows = self._orig


def plain_combined(air, args):
    """The fused kernel's plain version: combine_rows of the plain rows."""
    from boundless_tpu_torch.air import cons_eval as CE
    from boundless_tpu_torch.kernels import cons as CK

    *grid, alpha, masks = args
    return CE.combine_rows(CE.trace(air).kinds, CK.evaluate_plain(air, *grid),
                           alpha, masks)


def check_cons(calls, check, what):
    from boundless_tpu_torch.kernels import cons as CK

    for air, args in calls:
        got = CK.evaluate_combined(air, *args)
        want = plain_combined(air, args)
        if len(got) != len(want):
            raise AssertionError(f"{what}: {len(got)} class columns, plain "
                                 f"{len(want)}")
        for k, (g, w) in enumerate(zip(got, want)):
            check(g, w, f"constraint columns {air.name} {what} "
                  f"M={args[1].shape[0]} class {k}")


def counts():
    from boundless_tpu_torch.kernels import cons as CK
    from boundless_tpu_torch.kernels import ntt as NK
    from boundless_tpu_torch.kernels import poseidon2 as P2K

    return {"poseidon2_sponge": P2K.LAUNCHES, "ntt_sub_transform": NK.LAUNCHES,
            "cons_eval": CK.LAUNCHES}


def zero_counts():
    from boundless_tpu_torch.kernels import cons as CK
    from boundless_tpu_torch.kernels import ntt as NK
    from boundless_tpu_torch.kernels import poseidon2 as P2K

    P2K.LAUNCHES = NK.LAUNCHES = CK.LAUNCHES = 0


def phase_golden(dev, cons_check):
    from boundless_tpu_torch import convert as C
    from boundless_tpu_torch.core import field as F
    from boundless_tpu_torch.prover import stark
    from boundless_tpu_torch.zkvm import prove

    g = np.load(os.path.join(ROOT, "tests", "data", "torch_golden_po2_8.npz"))
    zero_counts()
    with CaptureCons() as cap:
        for variant in ("rv32im", "rv32i"):
            pre = variant + "/"
            data = F.fp(g[pre + "in.data"].astype(np.int64), dev)
            ctrl = F.fp(g[pre + "in.ctrl"].astype(np.int64), dev)
            pub = C.pub_from_numpy(
                {k[len(pre + "in.pub."):]: g[k] for k in g.files
                 if k.startswith(pre + "in.pub.")}, dev)
            gold = {k[len(pre + "proof."):]: g[k] for k in g.files
                    if k.startswith(pre + "proof.")}
            t0 = time.perf_counter()
            proof = stark.prove(prove._AIRS[variant], data, pub, 8,
                                prove.TEST_PS, ctrl)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if proof.data_root.device.type != "cuda":
                raise AssertionError("golden proof did not run on the card")
            flat = C.proof_to_numpy(proof)
            if sorted(flat) != sorted(gold):
                raise AssertionError(f"{variant}: proof fields differ from "
                                     f"golden")
            bad = [k for k in gold if not np.array_equal(flat[k], gold[k])]
            if bad:
                raise AssertionError(f"{variant}: words differ from golden: "
                                     f"{bad}")
            say("golden", variant=variant, po2=8, arrays=len(gold),
                equal="bit-for-bit", prove_s=f"{secs:.3f}")
    launched = counts()
    if min(launched.values()) <= 0:
        raise AssertionError(f"a kernel was not launched in the golden "
                             f"proofs: {launched}")
    check_cons(cap.calls, cons_check, "golden po2 8")
    say("golden", launches=json.dumps(launched).replace(" ", ""),
        constraint_grids_checked=len(cap.calls),
        class_columns=[len(args[-1]) for _, args in cap.calls], tolerance=0,
        max_abs_err=cons_check.max_err)


def phase_main(dev, cons_check, sm_clocks_per_s):
    from boundless_tpu_torch.air import cons_eval as CE
    from boundless_tpu_torch.kernels import cons as CK
    from boundless_tpu_torch.kernels import poseidon2 as P2K
    from boundless_tpu_torch.zkvm import guests, prove
    from boundless_tpu_torch.zkvm.executor import Executor

    image = guests.loop_guest()
    iters = ((1 << MAIN_PO2) - 40) // 2
    torch.cuda.reset_peak_memory_stats()
    native_before = prove.NATIVE_WITNESSES
    with CaptureCons() as cap, ForbidCombineRows() as eager:
        zero_counts()
        t0 = time.perf_counter()
        res = Executor(image, guests.words([iters]),
                       segment_po2=MAIN_PO2).run()
        seg = res.segments[0]
        t_exec = time.perf_counter() - t0
        variant = prove.air_variant_of(image, seg)
        if variant != "rv32i":
            raise AssertionError(f"loop guest picked {variant}, "
                                 f"expected rv32i")
        t0 = time.perf_counter()
        receipt = prove.prove_segment(image, seg, prove.DEFAULT_PS, device=dev)
        torch.cuda.synchronize()
        t_prove = time.perf_counter() - t0
        launches = counts()  # the main path's own: executor + witness + prove
    peak = torch.cuda.max_memory_allocated()
    if min(launches.values()) <= 0:
        raise AssertionError(f"prove_segment skipped a kernel: {launches}")
    if eager.calls:
        raise AssertionError(f"the card's proof ran the eager α-combine "
                             f"combine_rows {eager.calls} times")
    if prove.NATIVE_WITNESSES != native_before + 1:
        raise AssertionError("the witness did not come from the native C++ "
                             "generator")
    P2K.LAUNCHES = 0
    t0 = time.perf_counter()
    ok = prove.verify_segment(receipt, prove.DEFAULT_PS)
    t_verify = time.perf_counter() - t0
    verify_launches = P2K.LAUNCHES
    if not ok:
        raise AssertionError("verify_segment rejected the po2-17 proof")
    if verify_launches <= 0:
        raise AssertionError("verify_segment launched no sponge kernel")
    if receipt.proof.data_root.device.type != "cuda":
        raise AssertionError("the main-path proof did not run on the card")
    io = receipt.pub["io"].copy()
    io[0, 2] ^= 1
    tampered = dataclasses.replace(receipt, pub={**receipt.pub, "io": io})
    if prove.verify_segment(tampered, prove.DEFAULT_PS):
        raise AssertionError("verify_segment accepted a tampered io word")
    say("main", guest="loop", po2=MAIN_PO2, variant=variant,
        queries=prove.DEFAULT_PS.queries, cycles=seg.cycles,
        exec_s=f"{t_exec:.3f}", prove_s=f"{t_prove:.3f}",
        verify_s=f"{t_verify:.3f}",
        proved_mcycles_per_s=f"{seg.cycles / t_prove / 1e6:.6f}",
        max_memory_allocated=peak, witness="native",
        launches=json.dumps(launches).replace(" ", ""),
        verify_sponge_launches=verify_launches, tampered="rejected",
        eager_combine_rows_calls=eager.calls)

    # The constraint kernel on the proof's own 4N grid.
    if len(cap.calls) != 1:
        raise AssertionError(f"{len(cap.calls)} constraint-kernel calls in "
                             f"the proof, expected 1")
    check_cons(cap.calls, cons_check, f"main po2 {MAIN_PO2}")
    air, args = cap.calls[0]
    ctrl, data, accum, globals_, pub, alpha, masks = args
    prog = CE.trace(air)
    pubvec = air.cons_pub_pack(pub, globals_)
    weights = CE.alpha_weight_rows(prog.kinds, alpha)
    sels = CK.selectors(prog, masks)
    ms = cuda_ms(lambda: CK.launch(air, ctrl, data, accum, pubvec, weights,
                                   sels), 5)
    wrapper_ms = cuda_ms(lambda: CK.evaluate_combined(air, *args), 3)
    pack_ms = cuda_ms(lambda: air.cons_pub_pack(pub, globals_), 3)
    weights_ms = cuda_ms(lambda: CE.alpha_weight_rows(prog.kinds, alpha), 3)
    plain_ms = cuda_ms(lambda: plain_combined(air, args), 1)
    m = data.shape[0]
    muls, adds = CK.field_ops(prog)
    comb = CK.combine_counts(prog)
    # the combine as the kernel does it: one IMAD.WIDE a product, a fold is
    # an IMAD.WIDE and a move, a final reduction a Montgomery product
    extra = tuple(m * (comb["products"] * p + comb["folds"] * f
                       + comb["reductions"] * r)
                  for p, f, r in zip((1, 0, 0), (1, 0, 1), MUL_MIX))
    nbytes = 4 * m * (sum(prog.cols) + 4 * len(sels))
    bms, by = bound_ms(nbytes, m * muls, m * adds, sm_clocks_per_s, extra)
    say("kernel", kernel="cons_eval", variant=air.name, grid_rows=m,
        rows=len(prog.outputs), chunks=len(CK.chunks(prog)),
        class_columns=len(sels), products_per_row=muls, adds_per_row=adds,
        combine_products_per_row=comb["products"],
        combine_folds_per_row=comb["folds"], checked=cons_check.checked,
        tolerance=0, max_abs_err=cons_check.max_err, kernel_ms=f"{ms:.4f}",
        wrapper_ms_with_public_pack=f"{wrapper_ms:.4f}",
        public_pack_ms=f"{pack_ms:.4f}", weights_ms=f"{weights_ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bms:.4f}", bound_by=by,
        blocks_per_sm=CK.blocks_per_sm(air), warps_per_block=CK.WARPS)
    cons = dict(max_abs_err=cons_check.max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by)
    return launches, cons


class TimeCalls:
    """Host seconds of every call of `module.name` while active, each
    closed by a device synchronize."""

    def __init__(self, module, name):
        self.module, self.name, self.seconds = module, name, []

    def __enter__(self):
        self._orig = getattr(self.module, self.name)

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self._orig(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            return out

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self._orig)


def phase_recursion_kernels(dev, sm_clocks_per_s):
    """The sponge and the NTT at the recursion proofs' largest shapes."""
    from boundless_tpu_torch.core import ntt as NTT
    from boundless_tpu_torch.core import poseidon2 as P2
    from boundless_tpu_torch.kernels import ntt as NK
    from boundless_tpu_torch.kernels import poseidon2 as P2K

    rng = np.random.default_rng(SEED + 2)
    check = Checker()
    x = rand_words(rng, REC_SPONGE_SHAPE, dev)
    check(P2K.hash_rows(x), P2.hash_rows(x), "hash_rows rec leaves")
    n, c = REC_SPONGE_SHAPE
    perms = n * -(-c // P2.RATE)
    ms = cuda_ms(lambda: P2K.hash_rows(x), 5)
    plain_ms = cuda_ms(lambda: P2.hash_rows(x), 1)
    bms, by = bound_ms(4 * n * (c + P2.DIGEST_WORDS), perms * P2_MULS,
                       perms * P2_ADDS + n * c, sm_clocks_per_s)
    say("kernel", kernel="poseidon2_sponge", path="recursion",
        shape=f"{n}x{c}", tolerance=0, max_abs_err=check.max_err,
        kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        bound_ms=f"{bms:.4f}", bound_by=by)
    del x
    x = rand_words(rng, REC_NTT_SHAPE, dev)
    before = NK.LAUNCHES
    got = NTT.ntt(x)
    per_call = NK.LAUNCHES - before
    if per_call != 3:
        raise AssertionError(f"the 2^22 NTT made {per_call} launches, not 3")
    check(got, NTT.stockham(x), "four-step rec 4N evaluate")
    del got
    ms = cuda_ms(lambda: NTT.ntt(x), 5)
    plain_ms = cuda_ms(lambda: NTT.stockham(x), 1)
    n, c = REC_NTT_SHAPE
    butterflies = c * (n // 2) * (n.bit_length() - 1)
    bms, by = bound_ms(2 * 4 * n * c, butterflies, 2 * butterflies,
                       sm_clocks_per_s)
    say("kernel", kernel="ntt_sub_transform", path="recursion",
        shape=f"{n}x{c}", launches_per_transform=per_call, tolerance=0,
        max_abs_err=check.max_err, kernel_ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bms:.4f}", bound_by=by)


def rom_sha256(prog) -> str:
    """sha256 of a program's ROM words (canonical little-endian u32)."""
    import hashlib

    return hashlib.sha256(prog.ctrl_trace_np().astype("<u4").tobytes()
                          ).hexdigest()


def phase_recursion(dev):
    """Two po2-17 segment proofs lifted into rec_po2-20 RecursionAir
    proofs, joined, finalized and verified, all on the card."""
    from boundless_tpu_torch.core import field as F
    from boundless_tpu_torch.prover import stark
    from boundless_tpu_torch.recursion import succinct, vm
    from boundless_tpu_torch.zkvm import guests, paging, prove
    from boundless_tpu_torch.zkvm.executor import Executor

    seg_ps = prove.DEFAULT_PS
    image = guests.loop_guest()
    iters = ((1 << MAIN_PO2) - 40) // 2  # the main path's session: 2 segments
    t0 = time.perf_counter()
    ex = Executor(image, guests.words([iters]), segment_po2=MAIN_PO2)
    res = ex.run()
    t_exec = time.perf_counter() - t0
    if len(res.segments) != 2:
        raise AssertionError(f"{len(res.segments)} segments, expected 2")
    seg_receipts = []
    for seg in res.segments:
        zero_counts()
        t0 = time.perf_counter()
        r = prove.prove_segment(image, seg, seg_ps, device=dev)
        torch.cuda.synchronize()
        launches = counts()
        if min(launches.values()) <= 0:
            raise AssertionError(f"segment proof skipped a kernel: {launches}")
        say("recursion", stage="segment_proof", segment=seg.index,
            cycles=seg.cycles, variant=r.variant,
            prove_s=f"{time.perf_counter() - t0:.3f}",
            launches=json.dumps(launches).replace(" ", ""))
        seg_receipts.append(r)
    t0 = time.perf_counter()
    chains = succinct.segment_pre_chains(ex, res)
    t_chains = time.perf_counter() - t0

    params = succinct.SuccinctParams(
        seg_po2=MAIN_PO2, seg_ps=seg_ps, rec_po2=REC_PO2,
        rec_ps=stark.ProofSystem(**REC_PS_ARGS), variants=("rv32i",))
    system = succinct.SuccinctSystem(params, device=dev)
    gold = np.load(REC_GOLDEN)
    for kind, prog in system.progs.items():
        if rom_sha256(prog) != str(gold[f"prod/{kind}/rom_sha256"]):
            raise AssertionError(f"{kind} ROM differs from the JAX digest")
        say("recursion", stage="rom", program=kind,
            rows=int(gold[f"prod/{kind}/rows"]), rom="equal to JAX sha256",
            control_id=",".join(str(x) for x in system.control_ids[kind]))
    say("recursion", stage="setup", exec_s=f"{t_exec:.3f}",
        segment_pre_chains_s=f"{t_chains:.4f}",
        program_build_s=f"{system.seconds['program_build']:.3f}",
        control_ids_s=f"{system.seconds['control_ids']:.3f}",
        allowed_root=",".join(str(x) for x in system.allowed_root))

    evals_before = vm.NATIVE_EVALS
    rec_launches = {k: 0 for k in counts()}

    def recursion_proof(what, make):
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        with TimeCalls(stark, "_quotient_coeffs") as quotient:
            t0 = time.perf_counter()
            r = make()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = counts()
        if launches["poseidon2_sponge"] <= 0 or \
                launches["ntt_sub_transform"] <= 0:
            raise AssertionError(f"{what}: a kernel was not launched: "
                                 f"{launches}")
        if launches["cons_eval"] != 0:
            raise AssertionError(f"{what}: RecursionAir ran the constraint "
                                 f"kernel")
        if r.proof.data_root.device != dev:
            raise AssertionError(f"{what}: the proof did not run on the card")
        for k, v in launches.items():
            rec_launches[k] += v
        sec = system.seconds
        say("recursion", stage=what, wall_s=f"{wall:.3f}",
            witness_s=f"{sec['witness']:.3f}",
            native_eval_s=f"{sec['native_eval']:.3f}",
            prove_s=f"{sec['prove']:.3f}",
            quotient_s=f"{sum(quotient.seconds):.3f}",
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            launches=json.dumps(launches).replace(" ", ""))
        return r

    lifts = [recursion_proof(f"lift{seg.index}", lambda sr=sr, seg=seg:
                             system.lift(sr, chains[seg.index], seg.pre_mem,
                                         seg.index))
             for sr, seg in zip(seg_receipts, res.segments)]
    joined = recursion_proof("join", lambda: system.join(*lifts))
    native = vm.NATIVE_EVALS - evals_before
    if native != 3:
        raise AssertionError(f"{native} native rec_eval runs for 3 proofs")

    words = [int(w) for w in ex.journal_words]
    session = succinct.finalize_session(joined, words, image.entry,
                                        paging.image_root(image))
    t0 = time.perf_counter()
    ok = succinct.verify_session(session, system)
    t_verify = time.perf_counter() - t0
    if not ok:
        raise AssertionError("verify_session rejected the session receipt")
    for r in lifts + [joined]:
        if not system.verify(r):
            raise AssertionError(f"verify rejected a {r.kind} receipt")
    fc = joined.proof.fri_proof.final_coeffs.clone()
    fc[0, 0] = (fc[0, 0] + 1) % F.P
    bumped = dataclasses.replace(joined, proof=joined.proof._replace(
        fri_proof=joined.proof.fri_proof._replace(final_coeffs=fc)))
    if system.verify(bumped):
        raise AssertionError("verify accepted a join proof with a bumped word")
    moved = dataclasses.replace(joined, claim=dataclasses.replace(
        joined.claim, post_pc=joined.claim.post_pc + 4))
    if system.verify(moved):
        raise AssertionError("verify accepted a claim with post_pc changed")
    say("recursion", stage="session", segments=len(lifts),
        cycles=res.total_cycles, halted=joined.claim.halted,
        verify_session_s=f"{t_verify:.3f}", verify_session="accepted",
        receipts_verified=len(lifts) + 1, bumped_proof="rejected",
        changed_post_pc="rejected", native_rec_evals=native,
        launches_recursion=json.dumps(rec_launches).replace(" ", ""))
    return rec_launches


def phase_coproc_kernels(dev, sm_clocks_per_s):
    """The sponge and the NTT at the KeccakAir proof's shapes (4048 data
    columns: 126 whole 32-column NTT strips and a 16-column tail; 253
    rate blocks a leaf)."""
    from boundless_tpu_torch.core import ntt as NTT
    from boundless_tpu_torch.core import poseidon2 as P2
    from boundless_tpu_torch.kernels import poseidon2 as P2K

    rng = np.random.default_rng(SEED + 3)
    check = Checker()
    x = rand_words(rng, KEC_SPONGE_SHAPE, dev)
    check(P2K.hash_rows(x), P2.hash_rows(x), "hash_rows keccak leaves")
    n, c = KEC_SPONGE_SHAPE
    perms = n * -(-c // P2.RATE)
    ms = cuda_ms(lambda: P2K.hash_rows(x), 5)
    plain_ms = cuda_ms(lambda: P2.hash_rows(x), 1)
    bms, by = bound_ms(4 * n * (c + P2.DIGEST_WORDS), perms * P2_MULS,
                       perms * P2_ADDS + n * c, sm_clocks_per_s)
    say("coproc", kernel="poseidon2_sponge", shape=f"{n}x{c}", tolerance=0,
        max_abs_err=check.max_err, kernel_ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bms:.4f}", bound_by=by)
    glue = (("intt", NTT.intt, NTT.intt_plain, ()),
            ("coset_evaluate", NTT.coset_evaluate, NTT.coset_evaluate_plain,
             (INV_RATE_GRID,)))
    for name, fused, plain, args in glue:
        x = rand_words(rng, KEC_TRACE_SHAPE, dev)
        check(fused(x, *args), plain(x, *args),
              f"{name} keccak {KEC_TRACE_SHAPE}")
    x = rand_words(rng, KEC_NTT_SHAPE, dev)
    check(NTT.ntt(x), NTT.stockham(x), "ntt keccak forward")
    ms = cuda_ms(lambda: NTT.ntt(x), 5)
    plain_ms = cuda_ms(lambda: NTT.stockham(x), 1)
    n, c = KEC_NTT_SHAPE
    butterflies = c * (n // 2) * (n.bit_length() - 1)
    bms, by = bound_ms(2 * 4 * n * c, butterflies, 2 * butterflies,
                       sm_clocks_per_s)
    say("coproc", kernel="ntt_sub_transform", shape=f"{n}x{c}",
        glue_checked=",".join(g[0] for g in glue), tolerance=0,
        max_abs_err=check.max_err, checked=check.checked,
        kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        bound_ms=f"{bms:.4f}", bound_by=by)


def phase_coproc(dev, cons_check):
    """The keccak coprocessor on the card: a keccak guest's po2-17 rv32im
    segment and its KeccakAir batch lifted into rec_po2-21 proofs, the
    coproc chain discharged by resolve_coproc, the session finalized and
    verified; then two chained random batches (42 + 17 permutations)
    lifted and united."""
    from boundless_tpu_torch.core import field as F
    from boundless_tpu_torch.prover import stark
    from boundless_tpu_torch.recursion import coproc_succinct as cs
    from boundless_tpu_torch.recursion import succinct, vm
    from boundless_tpu_torch.zkvm import coproc, guests, paging, prove
    from boundless_tpu_torch.zkvm.executor import Executor

    gold = np.load(KEC_GOLDEN)
    q50 = stark.ProofSystem(**REC_PS_ARGS)
    cparams = cs.CoprocParams(kec_po2=KEC_PO2, kec_ps=q50,
                              rec_po2=COPROC_REC_PO2, rec_ps=q50)
    params = succinct.SuccinctParams(
        seg_po2=MAIN_PO2, seg_ps=prove.DEFAULT_PS, rec_po2=COPROC_REC_PO2,
        rec_ps=q50, variants=("rv32im",))
    coproc_launches = {k: 0 for k in counts()}

    def counted(what, make, stages=None, cons_kernel: bool = False):
        """Run one proof with the launch counts zeroed just before and read
        right after: sponge and NTT launched, the constraint kernel
        launched iff `cons_kernel` (the rv32im segment proof). `stages`:
        the recursion system whose `seconds` time the proof's stages."""
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        with TimeCalls(stark, "_quotient_coeffs") as quotient:
            t0 = time.perf_counter()
            r = make()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = counts()
        for k, v in launches.items():
            coproc_launches[k] += v
        if launches["poseidon2_sponge"] <= 0 or \
                launches["ntt_sub_transform"] <= 0:
            raise AssertionError(f"{what}: a kernel was not launched: "
                                 f"{launches}")
        if (launches["cons_eval"] > 0) != cons_kernel:
            raise AssertionError(f"{what}: {launches['cons_eval']} "
                                 f"constraint-kernel launches")
        if r.proof.data_root.device != dev:
            raise AssertionError(f"{what}: the proof did not run on the card")
        sec = {} if stages is None else {
            f"{k}_s": f"{stages.seconds[k]:.3f}"
            for k in ("witness", "native_eval", "prove")}
        say("coproc", stage=what, wall_s=f"{wall:.3f}", **sec,
            quotient_s=f"{sum(quotient.seconds):.3f}",
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            launches=json.dumps(launches).replace(" ", ""))
        return r

    # the keccak guest's session: one po2-17 segment, one permutation
    image = guests.keccak_guest()
    t0 = time.perf_counter()
    ex = Executor(image, guests.words([]), segment_po2=MAIN_PO2)
    res = ex.run()
    t_exec = time.perf_counter() - t0
    if len(res.segments) != 1 or not ex.keccak_states:
        raise AssertionError(f"keccak guest: {len(res.segments)} segments, "
                             f"{len(ex.keccak_states)} permutations")
    seg = res.segments[0]
    with CaptureCons() as cap:
        seg_receipt = counted("segment_proof", lambda: prove.prove_segment(
            image, seg, prove.DEFAULT_PS, device=dev), cons_kernel=True)
    if seg_receipt.variant != "rv32im":
        raise AssertionError(f"the keccak segment proved {seg_receipt.variant}")
    if not prove.verify_segment(seg_receipt, prove.DEFAULT_PS):
        raise AssertionError("verify_segment rejected the keccak segment")
    check_cons(cap.calls, cons_check, f"coproc rv32im po2 {MAIN_PO2}")
    say("coproc", stage="segment", guest="keccak", cycles=seg.cycles,
        permutations=len(ex.keccak_states), exec_s=f"{t_exec:.3f}",
        verify_segment="accepted", constraint_grids_checked=len(cap.calls),
        tolerance=0, max_abs_err=cons_check.max_err)

    # programs, ROMs and control IDs of both lattices
    placeholder = (tuple(int(x) for x in gold["placeholder/coproc_root"]),
                   tuple(int(x) for x in gold["placeholder/kec_circuit_id"]))
    t0 = time.perf_counter()
    system = succinct.SuccinctSystem(params, coproc=cparams, device=dev)
    t_systems = time.perf_counter() - t0
    csys = system.coproc_sys
    # resolve_coproc embeds the coproc allowed root and the keccak circuit
    # id; its ROM is held to JAX's through a build with the golden's
    # placeholder constants in their place
    t0 = time.perf_counter()
    progs = dict(system.progs, **csys.progs)
    progs["resolve_coproc"] = succinct.build_resolve_coproc(
        COPROC_REC_PO2, q50, placeholder[0], COPROC_REC_PO2, q50,
        placeholder[1]).finalize(1 << COPROC_REC_PO2)
    t_placeholder = time.perf_counter() - t0
    cid = coproc.circuit_id(KEC_PO2, q50, dev)
    if cid != tuple(int(x) for x in gold["prod/circuit_id"]):
        raise AssertionError("the keccak circuit id differs from JAX's")
    ids = dict(system.control_ids, **csys.control_ids)
    for kind, prog in progs.items():
        if rom_sha256(prog) != str(gold[f"prod/{kind}/rom_sha256"]):
            raise AssertionError(f"{kind} ROM differs from the JAX digest")
        say("coproc", stage="rom", program=kind,
            rows=int(gold[f"prod/{kind}/rows"]), rom="equal to JAX sha256",
            built_with=("placeholder constants" if kind == "resolve_coproc"
                        else "the real constants"),
            control_id=",".join(str(x) for x in ids[kind]))
    say("coproc", stage="setup",
        coproc_program_build_s=f"{csys.seconds['program_build']:.3f}",
        coproc_control_ids_s=f"{csys.seconds['control_ids']:.3f}",
        main_program_build_s=f"{system.seconds['program_build']:.3f}",
        main_control_ids_s=f"{system.seconds['control_ids']:.3f}",
        systems_wall_s=f"{t_systems:.3f}",
        placeholder_build_s=f"{t_placeholder:.3f}",
        circuit_id="equal to JAX",
        coproc_allowed_root=",".join(str(x) for x in csys.allowed_root),
        allowed_root=",".join(str(x) for x in system.allowed_root))
    evals_before = vm.NATIVE_EVALS

    # the guest chain: batch -> lift_keccak; segment -> lift; resolve_coproc
    kec = counted("keccak_proof guest", lambda: coproc.prove_keccak(
        ex.keccak_states, KEC_PO2, q50, device=dev))
    if not coproc.verify_keccak(kec, q50):
        raise AssertionError("verify_keccak rejected the guest's batch")
    bumped_pub = kec.states_pub.copy()
    bumped_pub[0, 1] = (int(bumped_pub[0, 1]) + 1) % F.P
    if coproc.verify_keccak(dataclasses.replace(kec, states_pub=bumped_pub),
                            q50):
        raise AssertionError("verify_keccak accepted a bumped state limb")
    if kec.digests() != list(ex.keccak_claims):
        raise AssertionError("batch digests differ from the ecall claims")
    klift = counted("lift_keccak guest", lambda: csys.lift(kec), csys)
    chains = succinct.segment_pre_chains(ex, res)
    lift = counted("lift", lambda: system.lift(
        seg_receipt, chains[seg.index], seg.pre_mem, seg.index), system)
    words = [int(w) for w in ex.journal_words]
    mem_root = paging.image_root(image)
    try:
        succinct.finalize_session(lift, words, image.entry, mem_root)
        raise AssertionError("finalize_session accepted an undischarged lift")
    except succinct.SuccinctError:
        pass
    resolved = counted("resolve_coproc", lambda: system.resolve_coproc(
        lift, klift), system)
    session = succinct.finalize_session(resolved, words, image.entry,
                                        mem_root)
    t0 = time.perf_counter()
    if not succinct.verify_session(session, system):
        raise AssertionError("verify_session rejected the keccak session")
    t_verify = time.perf_counter() - t0
    for r in (lift, resolved):
        if not system.verify(r):
            raise AssertionError(f"verify rejected a {r.kind} receipt")
    if not csys.verify(klift):
        raise AssertionError("verify rejected the lift_keccak receipt")
    fc = klift.proof.fri_proof.final_coeffs.clone()
    fc[0, 0] = (fc[0, 0] + 1) % F.P
    if csys.verify(dataclasses.replace(klift, proof=klift.proof._replace(
            fri_proof=klift.proof.fri_proof._replace(final_coeffs=fc)))):
        raise AssertionError("verify accepted a lift_keccak proof with a "
                             "bumped word")
    moved = dataclasses.replace(resolved, claim=dataclasses.replace(
        resolved.claim, post_coproc=lift.claim.post_coproc))
    if system.verify(moved):
        raise AssertionError("verify accepted a resolve_coproc claim with "
                             "post_coproc changed")
    say("coproc", stage="session", guest="keccak",
        post_coproc="discharged", verify_session="accepted",
        verify_session_s=f"{t_verify:.3f}", bumped_state_limb="rejected",
        bumped_lift_keccak_word="rejected",
        changed_post_coproc="rejected", undischarged_finalize="raised")

    # the union of two chained random batches
    rng = np.random.default_rng(SEED + 4)
    batches = [[[int(v) for v in rng.integers(0, 1 << 64, size=25,
                                               dtype=np.uint64)]
                for _ in range(k)] for k in UNION_PERMS]
    lifts, chain, count = [], (0,) * 8, 0
    for i, states in enumerate(batches):
        r = counted(f"keccak_proof batch{i}", lambda s=states:
                    coproc.prove_keccak(s, KEC_PO2, q50, device=dev))
        lifts.append(counted(f"lift_keccak batch{i}",
                             lambda r=r, c=chain, n=count: csys.lift(r, c, n),
                             csys))
        chain, count = lifts[-1].claim.post_chain, count + len(states)
    united = counted("union", lambda: csys.union(*lifts), csys)
    span = (united.claim.pre_count, united.claim.post_count)
    if not csys.verify(united) or span != (0, sum(UNION_PERMS)):
        raise AssertionError(f"the union did not verify over 0 -> "
                             f"{sum(UNION_PERMS)}: {span}")
    try:
        csys.union(lifts[1], lifts[0])
        raise AssertionError("union accepted its children in the wrong order")
    except ValueError:
        pass
    native = vm.NATIVE_EVALS - evals_before
    if native != 6:
        raise AssertionError(f"{native} native rec_eval runs for 6 proofs")
    say("coproc", stage="union", permutations="+".join(map(str, UNION_PERMS)),
        span=f"{span[0]}->{span[1]}", verify="accepted",
        wrong_order="raised", native_rec_evals=native,
        launches_coproc=json.dumps(coproc_launches).replace(" ", ""))
    return coproc_launches


KERNELS = (
    ("poseidon2_sponge", "boundless_tpu_torch/csrc/poseidon2.cu",
     "boundless_tpu/core/poseidon2_pallas.py:358"),
    ("ntt_sub_transform", "boundless_tpu_torch/csrc/ntt.cu",
     "boundless_tpu/core/ntt_pallas.py:65"),
    ("cons_eval", "boundless_tpu_torch/kernels/cons.py",
     "boundless_tpu/air/pallas_eval.py:380"),
)


def main():
    sys.path.insert(0, ROOT)
    sm_clocks_per_s = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    phase_probe(dev, sm_clocks_per_s)
    stats = {"poseidon2_sponge": phase_kernel_sponge(dev, sm_clocks_per_s),
             "ntt_sub_transform": phase_kernel_ntt(dev, sm_clocks_per_s)}
    cons_check = Checker()
    phase_golden(dev, cons_check)
    launches, stats["cons_eval"] = phase_main(dev, cons_check,
                                              sm_clocks_per_s)
    phase_recursion_kernels(dev, sm_clocks_per_s)
    rec_launches = phase_recursion(dev)
    phase_coproc_kernels(dev, sm_clocks_per_s)
    coproc_launches = phase_coproc(dev, cons_check)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], "launches_recursion": rec_launches[name],
         "launches_coproc": coproc_launches[name],
         **stats[name], "library_ms": None}
        for name, source, replaces in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
