"""The harness's own checks, on the CPU.

    python -m pytest proofbench/tests -q -p no:xdist -o addopts=""
"""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from proofbench import harness, roofline, traffic
from proofbench.reference import dsl
from proofbench.reference.stark import ExtVal, VecVal

ROOT = harness.ROOT
BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_by_name(name):
    cell = harness.resolve(name)
    assert cell.config["name"] == next(
        w["config"] for w in BENCH["workloads"] if w["name"] == name)
    assert os.path.exists(os.path.join(
        ROOT, "proofbench", "paths", f"{cell.config['path']}.py"))
    names = {m["name"] for m in cell.end_to_end}
    assert {"setup_s", "effective_khz"} <= names
    assert cell.per_layer
    for m in cell.per_layer:
        mod = harness.metric_module(m["name"])
        assert mod.NAME == m["name"] and callable(mod.read)


def test_config_files_hold_what_the_benchmark_names():
    for c in BENCH["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])


def test_a_cell_added_as_files_loads_without_edits(tmp_path):
    """A later PR adds a configuration, a mix, a metric and a cell by
    adding files and entries: nothing that exists changes."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "proofbench"), root / "proofbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    pb = root / "proofbench"
    cfg = json.loads((pb / "configs" / "loop-rv32i-seg20.json").read_text())
    cfg["name"] = "loop-rv32i-seg19"
    cfg["segment_po2"] = 19
    (pb / "configs" / "loop-rv32i-seg19.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "segments-po2-20.json").read_text())
    mix["name"] = "segments-half"
    mix["fill"] = [0.45, 0.49]
    (pb / "traffic" / "segments-half.json").write_text(json.dumps(mix))
    (pb / "metrics" / "jobs_seen.py").write_text(
        "NAME = 'jobs_seen'\n\ndef read(trace):\n"
        "    return float(len(trace.spans.get('prove_segment', [])))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name=cfg["name"],
                                 file="proofbench/configs/"
                                      "loop-rv32i-seg19.json"))
    bench["workloads"].append(dict(name="seg19-half", config=cfg["name"],
                                   traffic="segments-half", chips=1,
                                   why="a test"))
    bench["per_layer"].append(dict(bench["per_layer"][0], name="jobs_seen",
                                   workloads=["seg19-half"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    changed = [p for p, b in before.items()
               if p.name != "BENCHMARK.json" and p.read_bytes() != b]
    assert not changed
    cell = harness.resolve("seg19-half", root=str(root))
    assert cell.config["segment_po2"] == 19
    assert cell.traffic["fill"] == [0.45, 0.49]
    assert "jobs_seen" in [m["name"] for m in cell.per_layer]
    mod = harness.metric_module("jobs_seen", root=str(root))
    assert mod.read(type("T", (), {"spans": {"prove_segment": [1, 2]}})) == 2
    jobs = traffic.jobs(cell.traffic, cell.config, 7)
    assert next(jobs).cycles < 0.5 * (1 << 19)
    _an_rv32im_cell_added_as_files_is_judged(root, before)


SMALL_PS = dict(queries=8, fri_min_degree=16, commit_expand=4)
# an M-heavy guest: read n, run a mul/mulhu/divu/remu chain n times,
# commit the chain's value, halt; 20 cycles and 9 an iteration
CHAIN_SRC = """
start:
    li t0, 2
    ecall
    mv s2, a0
    li s3, 0
    li s4, 0x9e3779b9
    li s5, 12345
chain:
    beq s3, s2, done
    mul s5, s5, s4
    mulhu t1, s5, s4
    divu t3, s5, t1
    remu t4, s5, t1
    add s5, s5, t3
    xor s5, s5, t4
    addi s3, s3, 1
    j chain
done:
    mv a0, s5
    li t0, 1
    ecall
    li t0, 0
    li a0, 0
    ecall
"""


def _an_rv32im_cell_added_as_files_is_judged(root, before):
    """An rv32im configuration and its cell, added as files to the
    checkout `root`, judged on the CPU at po2 8 with 8 queries: the
    port's receipt passes, one with a journal word changed fails, and
    one proved under the configuration's control proof system fails."""
    from boundless_tpu_torch.zkvm import asm

    from proofbench.reference import check

    pb = root / "proofbench"
    words, _ = asm.assemble(CHAIN_SRC, base=0x1000)
    cfg = dict(
        name="chain-rv32im-seg8", path="segment", segment_po2=8,
        variant="rv32im", proof_system=SMALL_PS, reduced={}, assumed={},
        program=dict(name="chain", base=0x1000, entry=0x1000, words=words,
                     cycles_per_iteration=9, cycles_fixed=20),
        control=dict(proof_system=dict(SMALL_PS, commit_expand=2)))
    (pb / "configs" / "chain-rv32im-seg8.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name=cfg["name"],
                                 file="proofbench/configs/"
                                      "chain-rv32im-seg8.json"))
    bench["workloads"].append(dict(name="m8-chain", config=cfg["name"],
                                   traffic="segments-half", chips=1,
                                   why="a test"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert not [p for p, b in before.items()
                if p.name != "BENCHMARK.json" and p.read_bytes() != b]
    cell = harness.resolve("m8-chain", root=str(root))
    job = next(traffic.jobs(cell.traffic, cell.config, 2 ** 33 + 19))
    path = harness.path_module(cell.config, root=str(root)).Path
    out = path.export(path(cell.config, "cpu").run_job(job))
    assert [s["variant"] for s in out["segments"]] == ["rv32im"]
    checks = check.judge(cell.config, [(0, out)], "cpu")
    assert checks["claim_fields_wrong"]["value"] == 0
    assert checks["proofs_rejected"]["value"] == 0
    assert check.passes(checks)

    journal = bytearray(out["journal"])
    journal[0] ^= 1
    checks = check.judge(cell.config, [(0, dict(out, journal=bytes(
        journal)))], "cpu")
    assert checks["claim_fields_wrong"]["value"] >= 1
    assert not check.passes(checks)

    control = path(cell.config, "cpu",
                   proof_system=cell.config["control"]["proof_system"])
    checks = check.judge(cell.config, [(0, path.export(
        control.run_job(job)))], "cpu")
    assert checks["proofs_rejected"]["value"] >= 1
    assert not check.passes(checks)


# every mix of `traffic/`, with the configuration it is sized against
MIXES = {"segments-po2-20": "loop-rv32i-seg20",
         "sessions-2seg": "loop-rv32i-seg17-rec20",
         "sessions-1seg": "loop-rv32i-seg17-rec20"}


def _mix_cell(name):
    config = json.loads(open(os.path.join(
        ROOT, "proofbench", "configs", f"{MIXES[name]}.json")).read())
    mix = json.loads(open(os.path.join(
        ROOT, "proofbench", "traffic", f"{name}.json")).read())
    return harness.Cell(name, 1, config, mix, [], [])


def test_every_mix_is_tested():
    assert sorted(MIXES) == sorted(
        f[:-5] for f in os.listdir(os.path.join(ROOT, "proofbench",
                                                "traffic")))


@pytest.mark.parametrize("name", sorted(MIXES))
def test_traffic_repeats_for_a_seed_and_differs_across_seeds(name):
    cell = _mix_cell(name)
    traffic.check_arrivals(cell.traffic)

    def first(seed, n=32):
        gen = traffic.jobs(cell.traffic, cell.config, seed)
        return [next(gen) for _ in range(n)]

    big = 2 ** 33 + 12345
    assert first(big) == first(big)
    assert first(big) != first(big + 1)
    # every seed sends the same work, in another order
    size = len(traffic.targets(cell.traffic, cell.config))
    a = sorted(j.cycles for j in first(big, size))
    b = sorted(j.cycles for j in first(3, size))
    assert abs(sum(a) - sum(b)) <= size * 3 * cell.traffic[
        "jitter_iterations"]
    cap = 1 << cell.config["segment_po2"]
    lo, hi = cell.traffic["fill"]
    assert all(lo * cap - 3 * 8 - 16 <= j.cycles <= hi * cap for j in
               first(big))


@pytest.mark.parametrize("loop,in_flight", [("closed", 2), ("open", 1),
                                             (None, None)])
def test_a_mix_the_harness_does_not_drive_is_refused(tmp_path, loop,
                                                     in_flight):
    root = tmp_path / "repo"
    shutil.copytree(os.path.join(ROOT, "proofbench"), root / "proofbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    path = root / "proofbench" / "traffic" / "segments-po2-20.json"
    mix = json.loads(path.read_text())
    mix.pop("loop"), mix.pop("in_flight")
    if loop is not None:
        mix.update(loop=loop, in_flight=in_flight)
    path.write_text(json.dumps(mix))
    with pytest.raises(ValueError, match="in flight"):
        harness.resolve("seg20-prove", root=str(root))


def test_ntt_counts_equal_hand_counts():
    # m = 8, 2 lanes, every row in and out, no tables: 4 * 3 butterflies
    # a lane, each one product and two sums
    instr, nbytes = roofline.ntt_work(8, 2, 8, rows_out=8)
    bf = 4 * 3 * 2
    assert instr == bf * 6 + 2 * bf * 2
    assert nbytes == (8 * 2 + 8 * 2) * 4
    # a four-step first pass: m = 4, 6 lanes, turned through (4, 3), and
    # a coset shift (A of 4, B of 3) as it loads
    instr, nbytes = roofline.ntt_work(4, 6, 4, n2=3, load=(4, 3))
    bf = 2 * 2 * 6
    products = bf + 4 * 6 + 4 * 6
    assert instr == products * 6 + 2 * bf * 2
    assert nbytes == (4 * 6 + 4 * 6 + 4 * 3 + 4 + 3) * 4


def test_sponge_counts_equal_hand_counts():
    # one permutation: the first external layer (6 blocks x 14 sums, 20
    # block sums, 24 broadcasts), 8 full rounds, 21 partial rounds
    ext = 6 * 14 + 20 + 24
    assert roofline.P2_PRODUCTS == 8 * 24 * 4 + 21 * (4 + 24)
    assert roofline.P2_SUMS == ext + 8 * (24 + ext) + 21 * (1 + 23 + 24)
    perm = roofline.P2_PRODUCTS * 6 + roofline.P2_SUMS * 2
    # 3 rows of 40 words: 3 blocks each, 40 absorbed words a row
    instr, nbytes = roofline.sponge_work(3, 40, False, 8)
    assert instr == 9 * perm + 3 * 40 * 2
    assert nbytes == (3 * 40 + 3 * 8) * 4
    # a transcript permute: one row, no columns, a 24-word state in and out
    instr, nbytes = roofline.sponge_work(1, 0, True, 24)
    assert instr == perm and nbytes == (24 + 24) * 4
    # a tree top over 8 digests: 7 two-to-one hashes
    instr, nbytes = roofline.tree_work(8)
    assert instr == 7 * (perm + 16 * 2)
    assert nbytes == (8 + 7) * 8 * 4


class _TinyAir(dsl.Air):
    name, ctrl_cols, data_cols, accum_cols, globals_count = "tiny", 1, 3, 4, 1

    def constraints(self, alg, now, nxt, globals_, pub):
        x, y, z = now.data[0], now.data[1], now.data[2]
        inv = alg.read_ext(now.accum, 0)
        return [
            alg.mul(x, y),  # 1 product
            alg.sub(alg.mul(x, y), z),  # x * y shared: 1 sum
            alg.mul(x, alg.one()),  # a product by 1: none
            alg.add(nxt.data[0], alg.zero()),  # a sum with 0: none
            alg.sub(x, x),  # none, and the same on every row
            alg.mul(alg.const(3), alg.const(5)),  # literals: none, the same
            alg.mul(alg.pubval(pub), alg.const(2)),  # a public: the same
            alg.mul(alg.pubval(pub), x),  # 1 product
            # 3 sums, 3 products
            VecVal(alg.gmul(alg.B(x), alg.gsub(now.data.block(slice(0, 3)),
                                               alg.gconst([1, 2, 3])))),
            # an ext product by the mix challenge: 16 + 3 products, 12
            # sums; less a lifted base value: 1 sum (the other three
            # components less 0)
            ExtVal(alg.esub(alg.emul(inv, globals_[0]), alg.lift(z))),
        ]


def test_cons_counts_equal_hand_counts_on_a_tiny_air():
    assert roofline.EXT_MUL_PRODUCTS == 16 + 3
    assert roofline.EXT_MUL_SUMS == 4 * 3
    pub = torch.tensor(123456, dtype=torch.int32)
    row = roofline.count_row(_TinyAir(), pub,
                             torch.Generator().manual_seed(5))
    assert row.products == 1 + 1 + 3 + 19
    assert row.sums == 1 + 3 + 12 + 1
    assert row.rows == 8 + 3 + 4
    assert row.varying == row.rows - 3
    assert row.cols == (1, 3, 4)


def test_cons_counts_are_pinned_for_both_variants():
    i, im = (roofline.cons_row_ops(v) for v in ("rv32i", "rv32im"))
    assert i == (2860, 3760, 773, 721, (40, 392, 48))
    assert im == (3484, 4461, 1038, 986, (40, 584, 56))
    m = 1 << 19
    instr, nbytes = roofline.cons_work("rv32i", m, 40, 392, 48, 773, 2)
    assert instr == m * ((2860 + 4 * 721) * 6 + (3760 + 4 * 721) * 2)
    assert nbytes == (m * 480 + 256 + 773 * 4 + 2 * m * 4) * 4
    assert roofline.cons_work("rv32im", m, 40, 584, 56, 1038, 1) > (
        instr, nbytes)
    with pytest.raises(ValueError):
        roofline.cons_work("rv32i", m, 40, 584, 56, 1038, 1)
    with pytest.raises(ValueError):
        roofline.cons_row_ops("keccak")


def test_the_constraint_metric_counts_only_launches_it_can_count():
    mod = harness.metric_module("cons_roofline")

    class Grid:
        def __init__(self, m, cols, device="cuda"):
            self.shape, self.device = (m, cols), torch.device(device)

    def launch(name, m, cols, k, device="cuda"):
        air = type("Air", (), {"name": name})
        grids = [Grid(m, c, device) for c in cols]
        return mod._count(air, *grids, None, Grid(k, 4, device), [1, 2])

    m = 1 << 19
    assert launch("rv32i", m, (40, 392, 48), 773) == roofline.cons_work(
        "rv32i", m, 40, 392, 48, 773, 2)
    assert launch("rv32i", m, (40, 392, 48), 773, "cpu") is None
    assert launch("rec", m, (40, 392, 48), 773) is None
    assert launch("rv32im", m, (40, 392, 48), 773) is None
    # the share: least time over the kernel's device time
    instr, nbytes = roofline.cons_work("rv32i", m, 40, 392, 48, 773, 2)
    least = roofline.least_seconds(instr, nbytes)
    trace = type("T", (), {
        "launches": {"cons_roofline": [(instr, nbytes)] * 2},
        "kernel_seconds": lambda self, parts: (8 * least, 2)})()
    assert mod.read(trace) == pytest.approx(25.0)


def test_idle_gaps_are_split_by_the_host_spans_open_in_them():
    from proofbench import trace

    rec = trace.Recorder([], False)
    rec._w0 = 0
    rec.timeline = [("a", 10, 50), ("b", 20, 30), ("c", 60, 70)]
    kernels = [("k", 25, 28), ("k", 40, 65)]
    out = rec._breakdown(kernels, trace._union([(s, e) for _, s, e in
                                                 kernels]), 100)
    assert out["device_ops"] == [["k", 28e-9]]
    assert dict(out["idle_gaps"]) == pytest.approx({
        "outside every span": 40e-9, "a": 20e-9, "a+b": 7e-9, "c": 5e-9})


def test_the_roofline_constants_are_the_published_ones():
    assert roofline.HBM_BYTES_PER_S == 3.35e12
    assert roofline.ISSUE_PER_S == 132 * 128 * 1.98e9


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module


def _sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(ROOT, "proofbench", sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in _sources():
        for mod in _imports(path):
            assert mod.split(".")[0] not in harness.FORBIDDEN, (path, mod)


def test_the_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in (
                "boundless_tpu_torch",) + harness.FORBIDDEN, (path, mod)


def test_what_a_run_loads_holds_no_jax():
    """Every module of the benchmark, each path's and each metric's file
    and the port's modules they reach, loaded in a fresh process: no top
    level name of them is jax, jaxlib, flax or boundless_tpu."""
    code = """
import glob, os, sys
sys.path.insert(0, %r)
from proofbench import harness, trace, traffic, roofline
from proofbench.reference import check
import boundless_tpu_torch.cluster.agent, boundless_tpu_torch.cluster.api
import boundless_tpu_torch.recursion.succinct, boundless_tpu_torch.utils.serde
for f in glob.glob(os.path.join(%r, 'proofbench', 'metrics', '*.py')):
    harness.metric_module(os.path.basename(f)[:-3])
for w in harness.load_benchmark()['workloads']:
    harness.path_module(harness.resolve(w['name']).config)
print(harness.forbidden_modules())
mods = {m.split('.')[0] for m in sys.modules}
print(sorted(m for m in mods if m.startswith('boundless')))
""" % (ROOT, ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.split("\n")
    assert out[0] == "[]"
    assert out[1] == "['boundless_tpu_torch']"


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules({"boundless_tpu_torch.core": 1,
                                      "jaxtyping": 1}) == []
    assert harness.forbidden_modules({"jax.numpy": 1, "boundless_tpu": 1}) \
        == ["boundless_tpu", "jax"]


def test_no_card_means_no_result():
    """The entry point refuses to measure without a CUDA card."""
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "proofbench", "run.py"),
         "--workload", CELLS[0], "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0 and res.stdout.strip() == ""
