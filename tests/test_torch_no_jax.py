"""The port runs where JAX and the JAX package are not installed (as on
the GPU host).

A subprocess blocks `import jax` and `import boundless_tpu`
(`sys.modules[name] = None`), imports every module of
`boundless_tpu_torch` and `chip_smoke.py`, and runs executor -> witness ->
prove_segment -> verify_segment for the echo guest at po2 8 on the CPU
(the native C++ witness included), a dev-mode lift of that receipt, a
dev-mode keccak batch lifted into the coproc lattice, a
RecursionAir proof of a small program (the native `rec_eval` trace) with
its verification and the same proof spread by trace columns over two
CPU positions (`core/sharded.ShardedTrace`), the wrap's modules: a
p254-suite commit, a BLAKE3 digest, a Groth16 proof and its pairing
check, and the MSM's plain
version, and a dev-mode session of the echo guest through the port's
cluster (`ClusterApi`, worker threads, the receipt's wire format), the
market's modules: `cli requestor submit` through a dev-mode broker and the
in-guest ECDSA assessor over one signed fill; a degree audit of a
synthetic AIR, `check_constraints` on the echo witness (valid, and a
tampered word refused), PoVW's `record_receipt` on the dev-mode session
and an `IndexerService` sync of a scripted chain; no `boundless_tpu`
module may load. The
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
from boundless_tpu_torch.air import debug, degree, dsl
from boundless_tpu_torch.core import field as F
from boundless_tpu_torch.zkvm import witness
w = witness.trace_segment(guests.echo(), res.segments[0], 8)
wpub = witness.to_public_values(w.pub)
air = prove._AIRS["rv32im"]
assert debug.check_constraints(air, F.fp(w.ctrl), F.fp(w.data), wpub) == (
    True, [])
bad = w.data.copy()
bad[3, 0] = (bad[3, 0] + 1) % F.P
assert not debug.check_constraints(air, F.fp(w.ctrl), F.fp(bad), wpub)[0]
class Cube(dsl.Air):
    name, data_cols, max_degree = "cube", 1, 3
    def constraints(self, alg, now, nxt, globals_, pub):
        x = now.data[0]
        return [alg.mul(alg.mul(x, x), x)]
degs = degree.assert_degrees(Cube(), (), po2=4, device="cpu")
assert [d.degree for d in degs] == [3 * 15]
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
from boundless_tpu_torch import convert
from boundless_tpu_torch.core import sharded
two = ["cpu", "cpu"]
rec_tp = stark.prove(rair.AIR, sharded.ShardedTrace.of(data, two), pub, 8,
                     prove.TEST_PS, sharded.ShardedTrace.of(ctrl, two))
a, b = convert.proof_to_numpy(rec_tp), convert.proof_to_numpy(rec)
assert sorted(a) == sorted(b) and all((a[k] == b[k]).all() for k in a)
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
for must in ("utils.serde", "cli", "cluster.agent", "cluster.api",
             "cluster.dataplane", "cluster.executor_service",
             "cluster.hotstore", "cluster.metrics", "cluster.planner",
             "cluster.remote", "cluster.storage", "cluster.taskdb"):
    assert "boundless_tpu_torch." + must in names, must
import time
from boundless_tpu_torch.cluster import agent, api, hotstore, storage, taskdb
from boundless_tpu_torch.utils import serde
ctx = agent.ClusterContext(db=taskdb.MemoryBackend(), hot=hotstore.HotStore(),
                           store=storage.SharedFs(), ps=prove.TEST_PS,
                           segment_po2=8, succinct=succinct.DevModeSystem(),
                           dev_mode=True, device="cpu")
capi = api.ClusterApi(ctx)
capi.upload_image("echo", serde.dump_image(guests.echo()))
capi.upload_input("in0", guests.words([2, 11, 22]))
job = capi.create_session(dict(img="echo", input="in0"))["uuid"]
threads, agents = agent.run_workers(ctx, {"exec": 1, "prove": 1, "join": 1,
                                          "aux": 1})
deadline = time.time() + 120
while capi.session_status(job)["status"] not in ("SUCCEEDED", "FAILED"):
    assert time.time() < deadline
    time.sleep(0.05)
for a in agents:
    a.stop()
assert capi.session_status(job)["status"] == "SUCCEEDED"
session = serde.load_session_receipt(capi.receipt(job))
assert session.journal == guests.words([11, 22])
assert succinct.verify_session(session, ctx.succinct)
from boundless_tpu_torch.market import povw
assert povw.WorkLog().record_receipt("p1", session, ctx.succinct,
                                     seg_po2=8) == 1 << 8
for must in ("zkvm.secp256k1_guest", "market.types", "market.crypto",
             "market.chain", "market.storage_providers", "market.client",
             "market.deployments", "market.router", "market.batcher",
             "market.order_stream", "market.order_stream_http",
             "market.bench", "market.broker.pipeline", "market.broker.db",
             "market.broker.cluster_prover", "market.broker.telemetry",
             "air.degree", "air.debug", "parallel.mesh", "utils.profiling",
             "market.povw", "market.services", "market.indexer_service",
             "utils.config", "utils.service_runner"):
    assert "boundless_tpu_torch." + must in names, must
import contextlib, io
from boundless_tpu_torch import cli
from boundless_tpu_torch.market import batcher, crypto, types as mtypes
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    cli.main(["requestor", "submit", "--input", "2,5,6", "--timeout", "60"])
assert "status: fulfilled" in buf.getvalue(), buf.getvalue()
assert "journal: 0500000006000000" in buf.getvalue(), buf.getvalue()
alice = crypto.Wallet.from_seed(b"alice")
journal = guests.words([5, 6])
req = mtypes.ProofRequest(
    id=mtypes.RequestId(alice.address, 1),
    requirements=mtypes.Requirements(
        image_id="ab", predicate=mtypes.Predicate.digest_match(journal)),
    image_url="local://x", input_data=b"",
    offer=mtypes.Offer(1, 1, 0.0, 1.0, 10.0, 10.0, 0))
fill = mtypes.Fulfillment(req.id, journal, b"c" * 32, None, "prover1")
assessed = batcher.Assessor().assess(
    [(req, mtypes.sign_request(req, alice), fill)], "prover1")
assert assessed.journal == batcher.expected_assessor_journal(
    [(req, None, fill)])
from boundless_tpu_torch.market import chain as mchain, indexer_service
market = mchain.MarketChain(lambda f, r: True)
market.create_account(alice.address, funds=100)
market.submit_request(req, mtypes.sign_request(req, alice))
indexer = indexer_service.IndexerService(market)
assert indexer.sync() == 1 and indexer.stats()["total_requests"] == 1
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
