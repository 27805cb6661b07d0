"""The port runs where JAX is not installed (as on the GPU host).

A subprocess blocks `import jax` (`sys.modules["jax"] = None`), imports
every module of `boundless_tpu_torch` and `chip_smoke.py`, and runs
executor -> witness -> prove_segment -> verify_segment for the echo guest
at po2 8 on the CPU.
"""

import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import boundless_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    boundless_tpu_torch.__path__, "boundless_tpu_torch.")]
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
from boundless_tpu_torch.zkvm import guests, prove
from boundless_tpu_torch.zkvm.executor import Executor
res = Executor(guests.echo(), guests.words([2, 11, 22]), segment_po2=8).run()
receipt = prove.prove_segment(guests.echo(), res.segments[0], prove.TEST_PS)
assert prove.verify_segment(receipt, prove.TEST_PS)
loaded = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
          or m.startswith(("boundless_tpu.core", "boundless_tpu.air",
                           "boundless_tpu.prover"))]
assert loaded == ["jax"], loaded  # only the blocked placeholder
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
