"""Times the two BN254 kernels (the p254 sponge and the G1 MSM) of one tree.

    python3 tools/bn254_profile.py [--root DIR] [--label NAME] [--sweep]
                                   [--only probe,p254,shrink,msm,groth16]

Imports `boundless_tpu_torch` from `--root` (default: this repository; a
checkout of another commit, e.g. the parent, to compare two trees in one
call, in turns: parent, change, change, parent) and `chip_smoke.py`'s
helpers from this repository, and on `cuda:0`:

* probe: `bn254::mul<Fr>` of the tree's `csrc/bn254_field.cuh`: the
  dependent latency of one product (one warp, one chain a lane, clocks)
  and the throughput of independent products on every SM (4 chains a
  thread, products per second and SM clocks a product); the registers
  and spills of the tree's two kernel libraries;
* p254: a one-pair launch, 2^10 pairs, 2^16 x 64 leaves, the levels above
  them and the whole 2^16-leaf commit (`chip_smoke.device_ms` for short
  launches, CUDA events for long ones), each with its launches;
* shrink: the JAX CI wrap chain up to the session (echo guest, seg po2 6,
  rec_po2 17), then one warm identity_p254 shrink and its verify under
  `chip_smoke.SpongeProfile(sponge="p254")`: the sponge's device ms and
  launches by kind and by layout;
* msm: the MSM kernel at 497, 2^16, 2^18 and 2^20 points (random scalars;
  the points are multiples of G, 2^16 of them tiled), CUDA events, with
  the products this design does and the parent's yardstick;
* groth16: `chip_smoke.merkle_circuit`'s CRS proof (`qap.setup_sparse`,
  then `prove_sparse` twice): the device ms of each MSM kernel call of
  the second proof.

`--sweep` (the change's tree only) times `hash_rows` at 2^8 .. 2^16 rows
of 64 columns and `hash_level` at the same counts in both layouts, which
sets `kernels/poseidon254.LANE_CROSSOVER`. Prints `[bn254] label=...`
lines, the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTS = ("probe", "p254", "shrink", "msm", "groth16")
MSM_N = (497, 1 << 16, 1 << 18, 1 << 20)


def load_chip_smoke():
    """This repository's chip_smoke.py, whichever tree the package is."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    C = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(C)
    return C


def tree_levels(C, P254K, leaves):
    """The levels above a commit's leaves, as the tree's suite forms them:
    `chip_smoke.p254_levels` where the tree has a tree top, else one
    checked launch a level (a host synchronize each)."""
    if hasattr(P254K, "hash_tree"):
        return C.p254_levels(leaves)
    cur = leaves
    while cur.shape[0] > 1:
        cur = P254K.hash_level(cur.view(-1, 16))
    return cur


def pairs_launch(P254K, pairs):
    """One launch of the pair kernel on (m, 16) digests, without the
    wrapper's check of the digests (a host synchronize), in either tree."""
    import torch

    if hasattr(P254K, "lanes_for"):
        return lambda: P254K.hash_level(pairs, trusted=True)
    out = torch.empty((pairs.shape[0], 8), dtype=torch.int32,
                      device=pairs.device)
    return lambda: P254K._launch(lambda lib, s: lib.bt_p254_pairs(
        pairs.data_ptr(), pairs.shape[0], out.data_ptr(), s), pairs.device)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="tree")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--only", default=",".join(PARTS))
    args = ap.parse_args()
    parts = set(args.only.split(","))
    sys.path.insert(0, os.path.abspath(args.root))  # the tree's package
    import numpy as np
    import torch

    C = load_chip_smoke()
    from boundless_tpu_torch.core import suites
    from boundless_tpu_torch.groth16 import msm_device as MD
    from boundless_tpu_torch.groth16.bn254 import R
    from boundless_tpu_torch.kernels import build
    from boundless_tpu_torch.kernels import msm as MK
    from boundless_tpu_torch.kernels import poseidon254 as P254K

    label = args.label
    sm_clocks_per_s = C.phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    rng = np.random.default_rng(C.SEED)

    def say(**kw):
        C.say("bn254", label=label, **kw)

    def launches():
        return P254K.LAUNCHES, dict(getattr(P254K, "LAUNCHES_BY_LAYOUT", {}))

    def counted(what, fn, timer, **kw):
        fn()  # a warm-up, then count one call's launches
        torch.cuda.synchronize()
        n0, by0 = launches()
        fn()
        n1, by1 = launches()
        ms = timer(fn)
        by = {k: v - by0.get(k, 0) for k, v in by1.items()
              if v > by0.get(k, 0)}
        say(what=what, ms=f"{ms:.4f}", launches=n1 - n0,
            layouts=str(by).replace(" ", ""), **kw)
        return ms

    if "probe" in parts:
        t0 = time.perf_counter()
        P254K._lib()
        MK._lib()
        for name in ("bt_poseidon254", "bt_msm"):
            say(library=name, nvcc_s=f"{build.BUILD_SECONDS.get(name, 0):.1f}",
                registers_spill_stack_bytes=C.ptxas_summary(
                    build.PTXAS_LOG.get(name, "")))
        bn = C.bn_mul_probe(C.bn_probe_lib(), dev, sm_clocks_per_s)
        say(probe="bn254::mul<Fr>", mul_latency_clocks=
            f"{bn['bn_mul_latency_clocks']:.1f}",
            mul_products_per_s=f"{bn['bn_mul_products_per_s']:.4e}",
            mul_sm_clocks_per_product=
            f"{bn['bn_mul_sm_clocks_per_product']:.2f}")
        say(part="probe", seconds=f"{time.perf_counter() - t0:.1f}")

    if "p254" in parts:
        t0 = time.perf_counter()
        x = C.rand_words(rng, (2, 8), dev)
        pair = P254K.hash_rows(x).view(1, 16)
        counted("p254 one pair", pairs_launch(P254K, pair),
                lambda f: C.device_ms(f, 20))
        pairs = P254K.hash_rows(C.rand_words(rng, (2048, 8), dev)).view(-1, 16)
        counted("p254 1024 pairs", pairs_launch(P254K, pairs),
                lambda f: C.device_ms(f, 10))
        x = C.rand_words(rng, (1 << 16, 64), dev)
        counted("p254 leaves 65536x64", lambda: P254K.hash_rows(x),
                lambda f: C.cuda_ms(f, 3))
        leaves = P254K.hash_rows(x)
        counted("p254 tree levels of 65536 leaves",
                lambda: tree_levels(C, P254K, leaves),
                lambda f: C.cuda_ms(f, 3))
        counted("p254 commit 65536x64",
                lambda: suites.get("poseidon254").commit(x),
                lambda f: C.cuda_ms(f, 3))
        say(part="p254", seconds=f"{time.perf_counter() - t0:.1f}")

    if args.sweep:
        for k in range(8, 17):
            n = 1 << k
            x = C.rand_words(rng, (n, 64), dev)
            pairs = P254K.hash_rows(x).view(-1, 16)
            row = {}
            for g in (1, 3):
                ms = C.sponge_ms(lambda: P254K._hash_rows(x, g), n, 16)
                row[f"rows_lanes{g}_ms"] = f"{ms:.4f}"
                ms = C.sponge_ms(lambda: P254K._hash_level(
                    pairs, g, trusted=True), n // 2, 0)
                row[f"pairs_lanes{g}_ms"] = f"{ms:.4f}"
            say(sweep=f"{n}x64", pairs=n // 2, **row)

    if "shrink" in parts:
        from boundless_tpu_torch.recursion import identity

        t0 = time.perf_counter()
        system, session, _, _ = C.ci_session(dev)
        p254 = identity.get_p254(system)
        shr = p254.shrink(session.root)  # warm
        for what, make in (("shrink", lambda: p254.shrink(session.root)),
                           ("verify", lambda: p254.verify(shr))):
            with C.SpongeProfile(sponge="p254") as prof:
                ok = make()
            if what == "verify" and not ok:
                raise AssertionError("P254System.verify rejected the shrink")
            say(stage=f"identity_p254 {what}", **C.sponge_fields(
                prof.summary()))
        say(part="shrink", seconds=f"{time.perf_counter() - t0:.1f}")

    if "msm" in parts:
        t0 = time.perf_counter()
        base = torch.from_numpy(C.affine_words(C.multiples_of_g(1 << 16))
                                .view(np.int32).copy()).to(dev)
        for n in MSM_N:
            pts = base.repeat((n + base.shape[0] - 1) // base.shape[0],
                              1)[:n].contiguous()
            sc = [int.from_bytes(rng.bytes(32), "little") % R
                  for _ in range(n)]
            pr = MD.prep(sc, dev)
            ms = C.cuda_ms(lambda: MK.pippenger(pts, pr), 3)
            say(what=f"msm {n} points", ms=f"{ms:.4f}",
                entries=pr.idx.shape[0], chunks=pr.chunk_start.shape[0],
                products_parent=C.msm_products(sc, dev),
                **({"products": C.msm_products_new(pr)}
                   if hasattr(MD, "signed_digits") else {}))
        say(part="msm", seconds=f"{time.perf_counter() - t0:.1f}")

    if "groth16" in parts:
        from boundless_tpu_torch.groth16 import protocol, qap

        t0 = time.perf_counter()
        bld, root = C.merkle_circuit(C.GROTH16_DEPTH,
                                     np.random.default_rng(C.SEED + 9))
        sys_ = bld.to_sparse()
        wit = bld.witness()
        pk, vk = qap.setup_sparse(sys_)
        qap.prove_sparse(sys_, pk, wit, device=dev)  # warm: points cached
        calls = []
        orig = MK.pippenger

        spin = C.spin_lib()

        def timed(points, prep):  # behind a spin: the host's cost hidden
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            spin.bt_spin(C.SpongeProfile.SPIN_CLOCKS,
                         torch.cuda.current_stream().cuda_stream)
            start.record()
            out = orig(points, prep)
            end.record()
            calls.append((points.shape[0], start, end))
            return out

        MK.pippenger = timed
        try:
            proof = qap.prove_sparse(sys_, pk, wit, device=dev)
        finally:
            MK.pippenger = orig
        torch.cuda.synchronize()
        if not protocol.verify(vk, proof, [root]):
            raise AssertionError("the CRS proof does not verify")
        say(what="groth16 CRS prove MSM calls", calls=len(calls),
            points=",".join(str(n) for n, _, _ in calls),
            ms=",".join(f"{s.elapsed_time(e):.4f}" for _, s, e in calls),
            seconds=f"{time.perf_counter() - t0:.1f}")


if __name__ == "__main__":
    main()
