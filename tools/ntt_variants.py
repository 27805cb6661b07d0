"""The NTT sub-transform kernel at several shapes, on one CUDA card.

    python3 tools/ntt_variants.py [--variants R32W32,R32W16,R16W8,R8W8]

A variant RaWb is a copy of `csrc/ntt.cu` with its constants LOG_R =
log2 a and LOG_W = log2 b (a elements a thread, b columns a block); the
port builds the source as it is. All builds run in parallel. Each variant
then runs, through the port's own glue (`core/ntt`), the po2-17 rv32i
data group's transforms on the same random inputs: the 2^19 x 392
forward NTT (two launches: 1024 x 200,704 with the mid twiddle and the
transposed store, then 512 x 401,408), each of those launches alone, and
the 4N LDE of 2^17 x 392 coefficients (zero tail and coset shift in the
first launch's load). Prints per variant: registers,
spill bytes, blocks per SM at m = 1024 and 512, and CUDA-event ms (two
rounds, the variants in turns, then in reverse), and checks every
variant's words against the first variant's. Needs a card.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import threading

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from boundless_tpu_torch.core import field as F  # noqa: E402
from boundless_tpu_torch.core import ntt as NTT  # noqa: E402
from boundless_tpu_torch.kernels import build  # noqa: E402
from boundless_tpu_torch.kernels import ntt as NK  # noqa: E402

N, C = 1 << 19, 392


def load(spec: str):
    m = re.fullmatch(r"R(\d+)W(\d+)", spec)
    if not m:
        raise SystemExit(f"bad variant {spec!r} (RaWb)")
    log_r, log_w = (int(v).bit_length() - 1 for v in m.groups())
    with open(os.path.join(build.CSRC, "ntt.cu")) as f:
        text = f.read()
    for const, value in (("LOG_R", log_r), ("LOG_W", log_w)):
        text, n = re.subn(rf"constexpr int {const} = \d+;",
                          f"constexpr int {const} = {value};", text)
        if n != 1:
            raise SystemExit(f"csrc/ntt.cu has no single {const} constant")
    name = f"bt_ntt_{spec}"
    return name, NK.typed(build.load_source(name, lambda: text))


def cuda_ms(fn, reps: int = 10) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="R32W32,R32W16,R16W8,R8W8")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ntt_variants: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    specs = list(dict.fromkeys(args.variants.split(",")))
    libs, errors = {}, {}

    def build_one(spec):
        try:
            libs[spec] = load(spec)
        except Exception as e:  # reported after every build
            errors[spec] = e

    threads = [threading.Thread(target=build_one, args=(s,)) for s in specs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        spec, err = next(iter(errors.items()))
        raise SystemExit(f"build of {spec} failed: {err}")

    rng = np.random.default_rng(11)

    def words(shape):
        return torch.from_numpy(rng.integers(0, F.P, size=shape).astype(
            np.int32)).to(dev)

    x, coeffs = words((N, C)), words((N // 4, C))
    n1, n2 = NTT._split(N)
    first = x.reshape(n1, n2 * C)
    mid = NTT._mid_twiddles(n1, n2, True, dev)
    second = words((n2, n1 * C))
    work = {"ntt": lambda: NTT.ntt(x),
            "first_launch": lambda: NK.sub_ntt(first, True, mid),
            "second_launch": lambda: NK.sub_ntt(second, True),
            "lde": lambda: NTT.coset_evaluate(coeffs)}
    shipped = NK._lib
    times = {s: {k: [] for k in work} for s in specs}
    want = None
    try:
        for order in (specs, specs[::-1]):
            for spec in order:
                lib = libs[spec][1]
                NK._lib = lambda lib=lib: lib  # the wrapper launches this build
                got = [fn() for fn in work.values()]
                torch.cuda.synchronize()
                if want is None:
                    want = got
                elif not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise SystemExit(f"{spec} differs from {specs[0]}")
                for k, fn in work.items():
                    times[spec][k].append(cuda_ms(fn))
    finally:
        NK._lib = shipped
    for spec in specs:
        name, lib = libs[spec]
        log = build.PTXAS_LOG.get(name, "")
        regs = dict(re.findall(r"Compiling entry function '\S*sub_ntt_kernel"
                               r"ILi(\d+)E\S*'.*?Used (\d+) registers", log,
                               re.S))
        spills = sum(int(v) for v in re.findall(r"(\d+) bytes spill stores",
                                                log))
        print(f"[variant] {spec} registers_m1024={regs.get('10')} "
              f"registers_m512={regs.get('9')} spill_store_bytes={spills} "
              f"blocks_per_sm_m1024={lib.bt_ntt_blocks_per_sm(10)} "
              f"blocks_per_sm_m512={lib.bt_ntt_blocks_per_sm(9)} "
              + " ".join(f"{k}_ms={','.join(f'{t:.4f}' for t in v)}"
                         for k, v in times[spec].items())
              + f" words_equal={specs[0]}", flush=True)


if __name__ == "__main__":
    main()
