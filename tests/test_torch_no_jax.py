"""The port runs where JAX and the JAX package are not installed (as on
the GPU host).

A subprocess blocks `import jax` and `import boundless_tpu`
(`sys.modules[name] = None`), imports every module of
`boundless_tpu_torch` and `chip_smoke.py`, and runs executor -> witness ->
prove_segment -> verify_segment for the echo guest at po2 8 on the CPU
(the native C++ witness included), a dev-mode lift of that receipt, a
dev-mode keccak batch lifted into the coproc lattice, a
RecursionAir proof of a small program (the native `rec_eval` trace) with
its verification, and the wrap's modules: a p254-suite commit, a BLAKE3
digest, a Groth16 proof and its pairing check, and the MSM's plain
version; no `boundless_tpu` module may load. The
sources of the port and of `chip_smoke.py` must not import either package.
"""

import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["boundless_tpu"] = None  # and so does the JAX package
import boundless_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    boundless_tpu_torch.__path__, "boundless_tpu_torch.")]
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
from boundless_tpu_torch.zkvm import guests, prove
from boundless_tpu_torch.zkvm.executor import Executor
res = Executor(guests.echo(), guests.words([2, 11, 22]), segment_po2=8).run()
receipt = prove.prove_segment(guests.echo(), res.segments[0], prove.TEST_PS,
                              device="cpu")
assert prove.verify_segment(receipt, prove.TEST_PS)
assert prove.NATIVE_WITNESSES == 1 and prove.REPLAY_WITNESSES == 0
from boundless_tpu_torch.prover import stark
from boundless_tpu_torch.recursion import air as rair, succinct, vm
lifted = succinct.DevModeSystem().lift(receipt)
assert lifted.claim.image_id == tuple(int(x) for x in receipt.image_id)
from boundless_tpu_torch.recursion import coproc_succinct
from boundless_tpu_torch.zkvm import coproc
batch = coproc.prove_keccak([[3] * 25], po2=8, dev_mode=True)
span = coproc_succinct.DevModeCoprocSystem().lift(batch)
assert span.claim.post_count == 1 and len(batch.digests()) == 1
prog = vm.Prog("square")
b = prog.input()
prog.assert_eq(prog.pub(0), prog.mul(b, b))
prog.finalize(256)
ctrl = rair.rom_trace(prog, 256, "cpu")
data = rair.data_trace(prog, [(3, 0, 0, 0)], [9], "cpu")
assert vm.NATIVE_EVALS == 1
pub = rair.pub_array([9], "cpu")
rec = stark.prove(rair.AIR, data, pub, 8, prove.TEST_PS, ctrl)
root = stark.control_root_of(rair.AIR, 8, ctrl, prove.TEST_PS)
assert stark.verify(rair.AIR, rec, pub, 8, root, prove.TEST_PS)
for must in ("groth16.bn254", "groth16.circuit", "groth16.crs", "groth16.evm",
             "groth16.limbs", "groth16.msm", "groth16.msm_device",
             "groth16.pairing", "groth16.protocol", "groth16.qap",
             "groth16.r1cs", "groth16.wrap", "recursion.identity",
             "recursion.receipt", "core.blake3", "core.poseidon_bn254",
             "kernels.poseidon254", "kernels.msm"):
    assert "boundless_tpu_torch." + must in names, must
from boundless_tpu_torch.core import blake3, suites
from boundless_tpu_torch.groth16 import msm_device, protocol as GP
from boundless_tpu_torch.groth16.bn254 import G1
tree = suites.get("poseidon254").commit(ctrl[:8, :4])
assert tree.root.shape == (8,) and len(tree.levels) == 4
assert len(blake3.digest(b"abc")) == 32
mc = GP.mul_circuit()
pk, vk = GP.setup(mc)
assert GP.verify(vk, GP.prove(mc, pk, [1, 6, 2, 3, 6]), [6])
g = G1.generator()
assert msm_device.msm([g, g.double()], [3, 5], "cpu").eq(g.mul(13))
loaded = [m for m in sys.modules if m.startswith(("jax", "boundless_tpu"))
          and not m.startswith("boundless_tpu_torch")]
assert sorted(loaded) == ["boundless_tpu", "jax"], loaded  # placeholders
print("NOJAX-OK", len(names), receipt.variant)
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT), BT_ZK_SEED="5")
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "NOJAX-OK" in out.stdout


def test_package_sources_never_import_jax():
    for path in (ROOT / "boundless_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            stripped = line.strip()
            assert not stripped.startswith(("import jax", "from jax")), path


def test_port_sources_never_import_the_jax_package():
    paths = list((ROOT / "boundless_tpu_torch").rglob("*.py"))
    paths += [ROOT / "chip_smoke.py", ROOT / "tools" / "profile_torch.py"]
    for path in paths:
        for line in path.read_text().splitlines():
            words = line.split()
            for i, word in enumerate(words[:-1]):
                if word in ("import", "from"):
                    name = words[i + 1].rstrip(",")
                    assert not (name == "boundless_tpu"
                                or name.startswith("boundless_tpu.")), \
                        (path, line)
