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
              the generated constraint kernels of both AIR variants
              (kernels/cons.py); prints nvcc seconds, registers and spills.
  3. kernel   each kernel against its plain torch version on the card, bit
              for bit (tolerance 0: field words). Sponge: N in {1, 1000,
              1024, 2^18} x C in {0, 7, 16, 384}, the main path's sponge
              shapes, pairs at 2^17 and transcript permutations. NTT: the
              sub-transform at M in {2, 64, 512, 1024} x L in {1, 7, 128,
              392}, both directions, with the four-step store; the whole
              four-step at the main path's transforms (2^17 x {40, 392,
              48} inverse, 2^19 x {40, 392, 48, 16} forward, 2^19 x 4
              inverse). Times the sponge at the leaf shape and the NTT at
              2^19 x 392 with CUDA events.
  4. golden   the port's po2-8 TEST_PS proofs on the card equal the JAX
              reference proofs stored in tests/data/torch_golden_po2_8.npz;
              every kernel launched in them; the constraint kernel's rows
              on both golden grids equal the plain version's.
  5. main     the loop guest at po2 17 (as bench.py): executor -> witness
              (the native C++ generator) -> prove_segment (100 queries,
              rate 1/2, rv32i) on the card, verify_segment accepts it and
              rejects a tampered claim. The launch counts are zeroed just
              before the executor and read right after the proof: sponge,
              NTT and constraint kernels must each be > 0 (the verifier's
              sponge launches are counted apart). Then the constraint
              kernel against its plain version on the proof's own 4N grid,
              all rows bit for bit, and both timed.
The last two lines are the kernel table (each kernel's launches on the
main path, max abs error, ms, plain ms and bound ms) and the contract line
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
MAIN_PO2 = 17
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


def bound_ms(nbytes: float, muls: float, adds: float, sm_clocks_per_s: float):
    """The least time the card could take for `muls` Baby Bear products
    and `adds` adds or subtracts over `nbytes` of memory traffic: the
    larger of the bytes' time and the slowest of the FMA pipe, the ALU
    pipe and the issue limit. -> (ms, "bytes" or "operations")."""
    fma, alu, either = (muls * m + adds * a for m, a in zip(MUL_MIX, ADD_MIX))
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

    jobs = {"bt_poseidon2": P2K._lib, "bt_ntt": NK._lib}
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
    for name in jobs:
        log = build.PTXAS_LOG.get(name, "")
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
        say("build", library=name, arch="sm_90a",
            nvcc_seconds=f"{build.BUILD_SECONDS.get(name, 0.0):.3f}",
            functions=len(regs), max_registers=max(regs, default=0),
            spill_store_bytes=sum(spills),
            ok=name not in errors)
    say("build", parallel_wall_seconds=f"{wall:.3f}")
    if errors:
        name, err = next(iter(errors.items()))
        raise RuntimeError(f"build of {name} failed") from err


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
            n2 = 7 if lanes % 7 == 0 else 1
            mid = rand_words(rng, (m, n2), dev)
            check(NK.sub_ntt(x, True, mid), NK.sub_ntt_plain(x, True, mid),
                  f"sub_ntt M={m} L={lanes} four-step store")
    for n, c, fw in NTT_MAIN_SHAPES:
        x = rand_words(rng, (n, c), dev)
        check(NTT.ntt(x, fw), NTT.stockham(x, fw),
              f"four-step N={n} C={c} forward={fw}")
    n, c = NTT_TIME_SHAPE
    x = rand_words(rng, NTT_TIME_SHAPE, dev)
    before = NK.LAUNCHES
    NTT.ntt(x)
    per_call = NK.LAUNCHES - before
    ms = cuda_ms(lambda: NTT.ntt(x), 10)
    plain_ms = cuda_ms(lambda: NTT.stockham(x), 2)
    butterflies = c * (n // 2) * (n.bit_length() - 1)
    bms, by = bound_ms(2 * 4 * n * c, butterflies, 2 * butterflies,
                       sm_clocks_per_s)
    say("kernel", kernel="ntt_sub_transform", checked=check.checked,
        tolerance=0, max_abs_err=check.max_err, shape=f"{n}x{c}",
        launches_per_transform=per_call, kernel_ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bms:.4f}", bound_by=by)
    return dict(max_abs_err=check.max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by)


class CaptureCons:
    """Records the inputs of every constraint-kernel call while active."""

    def __enter__(self):
        from boundless_tpu_torch.kernels import cons as CK

        self.calls, self._ck, self._orig = [], CK, CK.evaluate

        def evaluate(air, *args):
            self.calls.append((air, args))
            return self._orig(air, *args)

        CK.evaluate = evaluate
        return self

    def __exit__(self, *exc):
        self._ck.evaluate = self._orig


def check_cons(calls, check, what):
    from boundless_tpu_torch.kernels import cons as CK

    for air, args in calls:
        check(CK.evaluate(air, *args), CK.evaluate_plain(air, *args),
              f"constraint rows {air.name} {what} M={args[1].shape[0]}")


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
        constraint_grids_checked=len(cap.calls), tolerance=0,
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
    with CaptureCons() as cap:
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
        verify_sponge_launches=verify_launches, tampered="rejected")

    # The constraint kernel on the proof's own 4N grid.
    if len(cap.calls) != 1:
        raise AssertionError(f"{len(cap.calls)} constraint-kernel calls in "
                             f"the proof, expected 1")
    check_cons(cap.calls, cons_check, f"main po2 {MAIN_PO2}")
    air, args = cap.calls[0]
    pubvec = air.cons_pub_pack(args[4], args[3])  # (pub, globals_)
    ms = cuda_ms(lambda: CK.launch(air, *args[:3], pubvec), 5)
    wrapper_ms = cuda_ms(lambda: CK.evaluate(air, *args), 3)
    plain_ms = cuda_ms(lambda: CK.evaluate_plain(air, *args), 1)
    prog = CE.trace(air)
    m = args[1].shape[0]
    muls, adds = CK.field_ops(prog)
    bms, by = bound_ms(4 * m * (sum(prog.cols) + len(prog.outputs)),
                       m * muls, m * adds, sm_clocks_per_s)
    say("kernel", kernel="cons_eval", variant=air.name, grid_rows=m,
        rows=len(prog.outputs), chunks=len(CK.chunks(prog)),
        products_per_row=muls, adds_per_row=adds, checked=cons_check.checked,
        tolerance=0, max_abs_err=cons_check.max_err, kernel_ms=f"{ms:.4f}",
        wrapper_ms_with_public_pack=f"{wrapper_ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bms:.4f}", bound_by=by)
    cons = dict(max_abs_err=cons_check.max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by)
    return launches, cons


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
    stats = {"poseidon2_sponge": phase_kernel_sponge(dev, sm_clocks_per_s),
             "ntt_sub_transform": phase_kernel_ntt(dev, sm_clocks_per_s)}
    cons_check = Checker()
    phase_golden(dev, cons_check)
    launches, stats["cons_eval"] = phase_main(dev, cons_check,
                                              sm_clocks_per_s)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], **stats[name], "library_ms": None}
        for name, source, replaces in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
