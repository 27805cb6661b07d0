"""Regenerate `torch_degree_golden.npz`: the JAX package's measured
constraint degrees (`boundless_tpu/air/degree.py`) for the port's degree
auditor (`boundless_tpu_torch/air/degree.py`).

For each AIR, at po2 5 with expand 16 and seed 0 (`assert_degrees`), the
arrays `<air>/index`, `<air>/lane`, `<air>/kind` and `<air>/degree`, one
entry per constraint lane:
  * `rv32im`, `rv32i`: `Rv32imAir()` and `Rv32imAir(False)` over the random
    `PublicValues` of `cli prover audit-degrees` (`default_rng(0)`, drawn
    field by field in declaration order);
  * `recursion`: `RecursionAir` over `pub_array([0] * PUB_VALS)` (as
    `tests/test_recursion_air.py::test_degree_audit`);
  * `keccak`: `KeccakAir` over a random `states` table of `max_perms(5)`
    slots (`default_rng(0)`).

Usage (several minutes on a CPU host: each audit jits one AIR's
constraints over a 512-row grid):

    JAX_PLATFORMS=cpu python tests/data/make_torch_degree_golden.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, "torch_degree_golden.npz")
PO2 = 5
EXPAND = 16
AIRS = ("rv32im", "rv32i", "recursion", "keccak")


def rv32im_pub(rng):
    """The random PublicValues of `cli prover audit-degrees`."""
    import jax.numpy as jnp

    from boundless_tpu.air import rv32im as R
    from boundless_tpu.core import field as F

    def rf(shape):
        return jnp.asarray(rng.integers(0, F.P, size=shape, dtype=np.uint32))

    return R.PublicValues(
        pre_pc=rf(()), post_pc=rf(()), pre_regs=rf((64,)),
        post_regs=rf((64,)), halted=rf(()), pre_seqs=rf((4,)),
        post_seqs=rf((4,)), io=rf((R.IO_MAX, 5)), cpio=rf((R.CP_IO, 4)),
        mem=rf((R.MEM_PAGES, R.MEM_PAGE_ELEMS)))


def air_and_pub(name: str):
    import jax.numpy as jnp

    from boundless_tpu.air import keccak as K
    from boundless_tpu.air import rv32im as R
    from boundless_tpu.core import field as F
    from boundless_tpu.recursion import air as rair
    from boundless_tpu.recursion import vm

    if name in ("rv32im", "rv32i"):
        return (R.Rv32imAir(name == "rv32im"),
                rv32im_pub(np.random.default_rng(0)))
    if name == "recursion":
        return rair.AIR, rair.pub_array([0] * vm.PUB_VALS)
    rng = np.random.default_rng(0)
    states = rng.integers(0, F.P, size=(K.max_perms(PO2), 1 + 2 * K.LIMBS),
                          dtype=np.uint32)
    return K.KeccakAir(), K.PublicValues(states=jnp.asarray(states))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    from boundless_tpu.air import degree as DA
    from boundless_tpu.core import field as F

    F.enable_u64()
    out = {}
    for name in AIRS:
        air, pub = air_and_pub(name)
        degs = DA.assert_degrees(air, pub, po2=PO2, expand=EXPAND)
        out[f"{name}/index"] = np.array([d.index for d in degs], np.int32)
        out[f"{name}/lane"] = np.array([d.lane for d in degs], np.int32)
        out[f"{name}/kind"] = np.array([d.kind for d in degs])
        out[f"{name}/degree"] = np.array([d.degree for d in degs], np.int32)
        print(name, len(degs), "lanes, worst", max(d.degree for d in degs),
              flush=True)
    np.savez_compressed(OUT, **out)
    print("wrote", OUT)


if __name__ == "__main__":
    main()
