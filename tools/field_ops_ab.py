"""The three kernels with `csrc/babybear.cuh` as shipped against its
compare-and-select form, on one CUDA card.

    python3 tools/field_ops_ab.py

`bb::add`, `bb::sub` and `bb::mul` end in an unsigned min (`min(s, s -
P)`: one VIADDMNMX). The `select` variant is a copy of `csrc/` under
`build/field_select/` whose `babybear.cuh` ends them in a compare and a
select (`s >= P ? s - P : s`), the form the port had before. Each variant's
libraries are built through the port's own wrappers (`kernels/build.py`
with its source directory pointed at the copy), then every kernel runs
through its wrapper on the same random inputs, the variants in the order
shipped, select, select, shipped; each time is the mean of a variant's two
rounds (CUDA events; `chip_smoke.sponge_ms` for short sponge launches):

* the sponge: transcript permute (N = 1), the main DEEP absorb (1 x 3904),
  the KeccakAir leaves (2^11 x 4048), the main leaves (2^18 x 392) and the
  recursion leaves (2^21 x 64), each in the layout the wrapper picks;
* the NTT: the main path's 2^19 x 392 forward four-step and the
  recursion's 2^22 x 64;
* the rv32i constraint kernel on a random 4N grid of 2^19 rows, two
  classes.

Both variants' outputs must be equal word for word. Prints the card's name
and power limit first. Needs a card and nvcc.
"""

from __future__ import annotations

import glob
import os
import shutil
import sys
import threading

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as C  # noqa: E402
from boundless_tpu_torch.air import cons_eval as CE  # noqa: E402
from boundless_tpu_torch.core import ntt as NTT  # noqa: E402
from boundless_tpu_torch.kernels import build  # noqa: E402
from boundless_tpu_torch.kernels import cons as CK  # noqa: E402
from boundless_tpu_torch.kernels import poseidon2 as P2K  # noqa: E402
from boundless_tpu_torch.zkvm import prove  # noqa: E402

SELECT = (("return min(s, s - P);", "return s >= P ? s - P : s;"),
          ("return min(d, d + P);", "return a >= b ? d : d + P;"),
          ("return min(r, r - P);", "return r >= P ? r - P : r;"))
SPONGE = tuple((what, n, c) for what, n, c in C.SPONGE_TIME_SHAPES) + (
    ("recursion leaves", *C.REC_SPONGE_SHAPE),)
NTT_SHAPES = (C.NTT_TIME_SHAPE, C.REC_NTT_SHAPE)
CONS_ROWS = C.INV_RATE_GRID << C.MAIN_PO2


def select_dir() -> str:
    """A copy of csrc/ whose bb::add, bb::sub and bb::mul compare and
    select."""
    out = os.path.join(build.BUILD_DIR, "field_select")
    os.makedirs(out, exist_ok=True)
    for path in glob.glob(os.path.join(build.CSRC, "*.cu*")):
        shutil.copy(path, out)
    header = os.path.join(out, "babybear.cuh")
    with open(header) as f:
        text = f.read()
    for old, new in SELECT:
        if text.count(old) != 1:
            raise SystemExit(f"csrc/babybear.cuh has no single {old!r}")
        text = text.replace(old, new)
    with open(header, "w") as f:
        f.write(text)
    return out


VARIANTS = {"shipped": build.CSRC}
CACHES = {"shipped": {}}


def use(variant: str):
    """Point the port's builds and loaded libraries at a variant."""
    build.CSRC = VARIANTS[variant]
    build._LIBS = CACHES[variant]
    P2K._READY_DEVICES.clear()  # constants live in each library


def build_all(variant: str, air):
    use(variant)
    errors = []

    def run(fn):
        try:
            fn()
        except Exception as e:  # reported after every build
            errors.append(e)

    threads = [threading.Thread(target=run, args=(fn,)) for fn in
               (P2K._lib, lambda: build.load("bt_ntt", "ntt.cu"),
                lambda: CK.build_kernels(air))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError(f"{variant} builds failed: {errors}")


def main():
    C.phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    VARIANTS["select"] = select_dir()
    CACHES["select"] = {}
    air = prove._AIRS["rv32i"]
    for variant in VARIANTS:
        build_all(variant, air)

    rng = np.random.default_rng(C.SEED)
    runs = {}  # name -> (fn, timer)
    for what, n, c in SPONGE:
        if c:
            x = C.rand_words(rng, (n, c), dev)
            runs[f"sponge {what} {n}x{c}"] = (
                lambda x=x: P2K.hash_rows(x),
                lambda fn, n=n, c=c: C.sponge_ms(fn, n, c))
        else:
            x = C.rand_words(rng, (n, 24), dev)
            runs[f"sponge {what} {n}x0"] = (
                lambda x=x: P2K.permute(x),
                lambda fn, n=n, c=c: C.sponge_ms(fn, n, c))
    for n, c in NTT_SHAPES:
        x = C.rand_words(rng, (n, c), dev)
        runs[f"ntt forward {n}x{c}"] = (lambda x=x: NTT.ntt(x),
                                        lambda fn: C.cuda_ms(fn, 5))
    prog = CE.trace(air)
    groups = [C.rand_words(rng, (CONS_ROWS, c), dev) for c in prog.cols]
    pub = C.rand_words(rng, (prog.pub_words,), dev)
    weights = C.rand_words(rng, (len(prog.outputs), 4), dev)
    runs[f"cons_eval rv32i {CONS_ROWS} rows"] = (
        lambda: torch.stack(CK.launch(air, *groups, pub, weights, [1, 2])),
        lambda fn: C.cuda_ms(fn, 5))

    outs, times = {}, {}
    for variant in ("shipped", "select", "select", "shipped"):
        use(variant)
        for name, (fn, timer) in runs.items():
            got = fn()
            torch.cuda.synchronize()
            want = outs.setdefault(name, got)
            if not torch.equal(got, want):
                raise AssertionError(f"{name}: {variant} differs")
            times.setdefault((name, variant), []).append(timer(fn))
    for name in runs:
        shipped, select = (sum(times[(name, v)]) / 2
                           for v in ("shipped", "select"))
        C.say("field_ops", kernel=name.replace(" ", "_"),
              shipped_ms=f"{shipped:.4f}", select_ms=f"{select:.4f}",
              select_over_shipped=f"{select / shipped:.4f}",
              rounds_ms=",".join(f"{v}:{t:.4f}" for (k, v), ts in
                                 times.items() if k == name for t in ts))


if __name__ == "__main__":
    main()
