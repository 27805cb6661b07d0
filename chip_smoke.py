"""GPU smoke run of the PyTorch/CUDA port's main path (one NVIDIA card).

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero:
  1. device   a CUDA card is required (nothing runs on the CPU); prints
              `nvidia-smi --query-gpu=name,power.limit`.
  2. build    compiles the CUDA Poseidon2 sponge with nvcc for sm_90a.
  3. kernel   the CUDA sponge against the plain torch sponge on the card,
              bit for bit (tolerance 0: field words), at N in {1, 1000,
              1024, 2^18} x C in {0, 7, 16, 384}, at the main path's own
              sponge shapes, pairs at 2^17 and transcript permutations;
              times both at the main-path leaf shape (rv32i data group,
              2^18 rows).
  4. golden   the port's po2-8 TEST_PS proofs on the card equal the JAX
              reference proofs stored in tests/data/torch_golden_po2_8.npz.
  5. main     the loop guest at po2 17 (as bench.py): executor -> witness
              -> prove_segment (100 queries, rate 1/2, rv32i) on the card,
              verify_segment accepts it and rejects a tampered claim; the
              sponge's launch count over executor, witness and proof (read
              before the verifier runs) must be > 0, and so must the
              verifier's own, counted apart.
The last two lines are the kernel table and the contract line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
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
MAIN_PO2 = 17


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


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False); this script runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    say("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)


def phase_build():
    from boundless_tpu_torch.kernels import build
    from boundless_tpu_torch.kernels import poseidon2 as P2K

    t0 = time.perf_counter()
    P2K._lib()
    say("build", library="bt_poseidon2", arch="sm_90a",
        seconds=f"{time.perf_counter() - t0:.3f}",
        nvcc_seconds=f"{build.BUILD_SECONDS.get('bt_poseidon2', 0.0):.3f}")


def phase_kernel(dev):
    from boundless_tpu_torch.core import poseidon2 as P2
    from boundless_tpu_torch.kernels import poseidon2 as P2K

    rng = np.random.default_rng(SEED)
    max_err = 0
    checked = 0

    def compare(got, want, what):
        nonlocal max_err, checked
        torch.cuda.synchronize()
        if got.shape != want.shape:
            raise AssertionError(f"{what}: shape {tuple(got.shape)} vs "
                                 f"{tuple(want.shape)}")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        max_err = max(max_err, err)
        checked += 1
        if err:
            raise AssertionError(f"{what}: kernel differs from plain torch")

    shapes = [(n, c) for n in KERNEL_SHAPES_N for c in KERNEL_SHAPES_C]
    for n, c in shapes + list(MAIN_PATH_SHAPES):
        x = rand_words(rng, (n, c), dev)
        compare(P2K.hash_rows(x), P2.hash_rows(x), f"hash_rows N={n} C={c}")
    left = rand_words(rng, (1 << 17, 8), dev)
    right = rand_words(rng, (1 << 17, 8), dev)
    compare(P2K.hash_pairs(left, right), P2.hash_pair(left, right),
            "hash_pairs N=2^17")
    for n in (1, 1000):
        st = rand_words(rng, (n, P2.WIDTH), dev)
        compare(P2K.permute(st), P2.permute(st), f"permute N={n}")

    leaf = rand_words(rng, LEAF_SHAPE, dev)
    ms = cuda_ms(lambda: P2K.hash_rows(leaf), 10)
    plain_ms = cuda_ms(lambda: P2.hash_rows(leaf), 2)
    say("kernel", checked=checked, tolerance=0, max_abs_err=max_err,
        leaf_shape=f"{LEAF_SHAPE[0]}x{LEAF_SHAPE[1]}",
        kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}")
    return max_err, ms, plain_ms


def phase_golden(dev):
    from boundless_tpu_torch import convert as C
    from boundless_tpu_torch.core import field as F
    from boundless_tpu_torch.prover import stark
    from boundless_tpu_torch.zkvm import prove

    g = np.load(os.path.join(ROOT, "tests", "data", "torch_golden_po2_8.npz"))
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
        proof = stark.prove(prove._AIRS[variant], data, pub, 8, prove.TEST_PS,
                            ctrl)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if proof.data_root.device.type != "cuda":
            raise AssertionError("golden proof did not run on the card")
        flat = C.proof_to_numpy(proof)
        if sorted(flat) != sorted(gold):
            raise AssertionError(f"{variant}: proof fields differ from golden")
        bad = [k for k in gold if not np.array_equal(flat[k], gold[k])]
        if bad:
            raise AssertionError(f"{variant}: words differ from golden: {bad}")
        say("golden", variant=variant, po2=8, arrays=len(gold),
            equal="bit-for-bit", prove_s=f"{secs:.3f}")


def phase_main(dev):
    from boundless_tpu_torch.kernels import poseidon2 as P2K
    from boundless_tpu_torch.zkvm import guests, prove
    from boundless_tpu_torch.zkvm.executor import Executor

    image = guests.loop_guest()
    iters = ((1 << MAIN_PO2) - 40) // 2
    torch.cuda.reset_peak_memory_stats()
    P2K.LAUNCHES = 0
    t0 = time.perf_counter()
    res = Executor(image, guests.words([iters]),
                   segment_po2=MAIN_PO2).run()
    seg = res.segments[0]
    t_exec = time.perf_counter() - t0
    variant = prove.air_variant_of(image, seg)
    if variant != "rv32i":
        raise AssertionError(f"loop guest picked {variant}, expected rv32i")
    t0 = time.perf_counter()
    receipt = prove.prove_segment(image, seg, prove.DEFAULT_PS, device=dev)
    torch.cuda.synchronize()
    t_prove = time.perf_counter() - t0
    launches = P2K.LAUNCHES  # the proof's own: executor + witness + prove
    peak = torch.cuda.max_memory_allocated()
    if launches <= 0:
        raise AssertionError("prove_segment launched no sponge kernel")
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
        max_memory_allocated=peak, prove_sponge_launches=launches,
        verify_sponge_launches=verify_launches, tampered="rejected")
    return launches


def main():
    sys.path.insert(0, ROOT)
    phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    max_err, ms, plain_ms = phase_kernel(dev)
    phase_golden(dev)
    launches = phase_main(dev)
    print(json.dumps({"kernels": [{
        "name": "poseidon2_sponge", "route": "cuda",
        "source": "boundless_tpu_torch/csrc/poseidon2.cu",
        "replaces": "boundless_tpu/core/poseidon2_pallas.py:358",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
