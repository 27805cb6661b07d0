"""Times the Poseidon2 sponge's internal rounds against the classic form,
and (`--sweep`) the sweeps that chose its layout crossovers and tree top.

    python3 tools/sponge_variants.py
    python3 tools/sponge_variants.py --sweep

Builds copies of `csrc/poseidon2.cu` with one choice undone, each through
`kernels/build.load_source` into `build/`:

* `shipped`: the source as it is;
* `classic_internal`: the lane groups run the one-thread internal round
  (the 24-term sum across the group in every round, on the round's chain)
  in place of `internal_rounds_split`.

(`tools/field_ops_ab.py` times the field operations' two forms.)

Each is held to the plain sponge at small shapes (tolerance 0), then timed
on `cuda:0` (`chip_smoke.sponge_ms`: device time, the host's cost hidden
for short launches) in every layout at a one-row chain of 25 permutations
(1 x 392), a transcript permutation (1 x 0), the KeccakAir leaves
(2^11 x 4048) and, at one thread a hash, the main path's and the
recursion's leaves (2^18 x 392, 2^21 x 64). Prints the card's name and
power limit first.

`--sweep` times the shipped sponge instead: every layout at N = 2^10 ..
2^17 rows of 16 and 392 columns (the fastest layout against
`kernels/poseidon2.lanes_for`, which `LANE_CROSSOVER` sets), and the
one-block tree top against the level loop at every level size up to
`tree_max()`, device and host ms (which `TREE_TOP` sets).
"""

from __future__ import annotations

import ctypes
import os
import re
import sys
import threading

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as C  # noqa: E402
from boundless_tpu_torch.core import poseidon2 as P2  # noqa: E402
from boundless_tpu_torch.kernels import build  # noqa: E402

SWEEP = tuple((1 << k, c) for c in (16, 392) for k in range(10, 18))
SHAPES = ((1, 392, (1, 2, 4, 8)), (1, 0, (1, 2, 4, 8)),
          (1 << 11, 4048, (2, 4, 8)), (1 << 18, 392, (1,)),
          (1 << 21, 64, (1,)))


def variants() -> dict:
    with open(os.path.join(build.CSRC, "poseidon2.cu")) as f:
        src = f.read()
    split = "    internal_rounds_split<K>(s, lane);"
    classic = ("#pragma unroll 1\n    for (int r = 0; r < ROUNDS_PARTIAL;"
               " ++r) internal_round_lanes<K>(s, r, lane);")
    # the one-thread round, with the S-box kept by word 0's lane and the
    # sum taken across the group
    lanes_round = '''template <int K>
__device__ __forceinline__ void internal_round_lanes(uint32_t* s, int r,
                                                     const Lane<K>& lane) {
  const uint32_t x0 = sbox(bb::add(s[0], c_int_rc[r]));
  const uint32_t rest = tree_sum<4 * K - 1, 1>(s + 1);
  s[0] = lane.g == 0 ? x0 : s[0];
  const uint32_t sum = group_sum<K>(bb::add(rest, s[0]), lane.active);
#pragma unroll
  for (int j = 0; j < 4 * K; ++j)
    s[j] = bb::add(bb::mul(s[j], lane.mu[j]), sum);
}

'''
    anchor = "template <int K>\n__device__ __forceinline__ void permute("
    assert split in src and anchor in src
    classic_src = src.replace(split, classic).replace(
        anchor, lanes_round + anchor)
    return {"shipped": src, "classic_internal": classic_src}


def typed(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.bt_p2_set_constants.argtypes = [vp, vp, vp]
    lib.bt_p2_sponge.argtypes = [vp, ctypes.c_longlong, i, i, vp, vp, i, i,
                                 vp]
    tables = [np.ascontiguousarray(t, dtype=np.uint32)
              for t in P2.constants()]
    if lib.bt_p2_set_constants(*(t.ctypes.data for t in tables)):
        raise RuntimeError("constant upload failed")
    return lib


def main():
    C.phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    libs, errors = {}, {}

    def make(name, text):
        try:
            libs[name] = build.load_source(f"bt_p2var_{name}", lambda: text)
        except Exception as e:  # reported after every build
            errors[name] = e

    threads = [threading.Thread(target=make, args=item)
               for item in variants().items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError(f"builds failed: {errors}")
    for name in libs:
        regs = re.findall(r"Used (\d+) registers",
                          build.PTXAS_LOG.get(f"bt_p2var_{name}", ""))
        C.say("variant", name=name, registers=",".join(regs))
    rng = np.random.default_rng(C.SEED)
    stream = torch.cuda.current_stream().cuda_stream
    for n, c, lane_set in SHAPES:
        x = C.rand_words(rng, (n, c), dev)
        init = C.rand_words(rng, (n, P2.WIDTH), dev) if c == 0 else None
        out_words = P2.WIDTH if c == 0 else P2.DIGEST_WORDS
        out = torch.empty((n, out_words), dtype=torch.int32, device=dev)
        want = P2.hash_rows(x, init, out_words) if n <= (1 << 11) else None
        times = {}
        for name, lib in libs.items():
            typed(lib)
            for lanes in lane_set:
                def run(lib=lib, lanes=lanes):
                    rc = lib.bt_p2_sponge(
                        x.data_ptr(), n, c, 1,
                        None if init is None else init.data_ptr(),
                        out.data_ptr(), out_words, lanes, stream)
                    if rc:
                        raise RuntimeError(f"launch failed: CUDA error {rc}")
                run()
                if want is not None and not torch.equal(out, want):
                    raise AssertionError(f"{name} lanes={lanes} N={n} C={c}"
                                         f" differs from the plain sponge")
                times[f"{name}_lanes{lanes}_ms"] = \
                    f"{C.sponge_ms(run, n, c):.4f}"
        C.say("variant", shape=f"{n}x{c}", **times)
        del x


def sweep():
    """The layout crossovers and the tree top's size, re-measured."""
    from boundless_tpu_torch.kernels import poseidon2 as P2K

    C.phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    rng = np.random.default_rng(C.SEED)
    for n, c in SWEEP:
        x = C.rand_words(rng, (n, c), dev)
        ms = {g: C.sponge_ms(lambda g=g: C.hash_lanes(x, g), n, c)
              for g in P2K.LANES}
        C.say("sweep", shape=f"{n}x{c}",
              **{f"lanes{g}_ms": f"{v:.4f}" for g, v in ms.items()},
              fastest=f"lanes{min(ms, key=ms.get)}",
              picked=f"lanes{P2K.lanes_for(n)}")
    C.say("sweep", lane_crossover=",".join(f"lanes{g}:N>={f}" for f, g in
                                           P2K.LANE_CROSSOVER),
          below=f"lanes{P2K.LANES[-1]}")
    for m in [1 << k for k in range(1, P2K.tree_max().bit_length())]:
        level = C.rand_words(rng, (m, P2.DIGEST_WORDS), dev)

        def loop():
            cur = level
            while cur.shape[0] > 1:
                cur = P2K.hash_rows(cur.view(-1, 2 * P2.DIGEST_WORDS))

        C.say("sweep", tree_nodes=m, levels=m.bit_length() - 1,
              tree_top_ms=f"{C.device_ms(lambda: P2K.hash_tree(level), 20):.4f}",
              level_loop_ms=f"{C.device_ms(loop, 20):.4f}",
              tree_top_host_ms=f"{C.host_ms(lambda: P2K.hash_tree(level), 20):.4f}",
              level_loop_host_ms=f"{C.host_ms(loop, 20):.4f}")
    C.say("sweep", tree_top=P2K.TREE_TOP)


if __name__ == "__main__":
    if "--sweep" in sys.argv[1:]:
        sweep()
    else:
        main()
