"""The wide trace on the CPU: an rv32im segment's data LDE at po2 20 is
2^22 x 584 = 2,449,473,536 words, past 2^31.

* The kernels' wrappers (`kernels/ntt.py`, `poseidon2.py`, `bbmm.py`,
  `cons.py`) take every launch of that proof: their shape checks alone,
  with nothing allocated, accept the launches past 2^31 words and refuse
  what the kernels cannot index (a 32-bit column, row or grid index).
* The benchmark's yardstick (`proofbench/roofline.py`) counts such a
  launch exactly, as linearly in its rows as a 2^19 x 392 one.
* The benchmark's configuration `chain-rv32im-seg20` and its cell
  `seg20-rv32im`, with the segment size lowered to po2 8 and 8 queries in
  this test only: the port's receipt passes the reference's judgement, one
  with a journal word flipped fails it, and the configuration's control
  fails it. `rec20-1seg` resolves to the cluster path and the 1-segment
  mix.

The kernels on the card at these shapes: tests/test_torch_wide_cuda.py.
"""

import copy

import pytest

from boundless_tpu_torch.kernels import bbmm as BK
from boundless_tpu_torch.kernels import cons as CK
from boundless_tpu_torch.kernels import ntt as NK
from boundless_tpu_torch.kernels import poseidon2 as P2K
from proofbench import harness, roofline, traffic
from proofbench.reference import check

PO2 = 20
ROWS = 4 << PO2  # the 4N grid of a po2-20 segment
DATA = 584  # rv32im's data columns
CTRL, ACCUM = 40, 56
WIDE = ROWS * DATA
H100_SMS = 132


def test_the_wide_lde_is_past_2_31_words():
    assert WIDE == 2_449_473_536 > 1 << 31


def _four_step_levels(n, lanes):
    """The sub-transform launches `core/ntt._leading_ntt` makes for an
    n-row LDE of `lanes` columns from n / 4 coefficient rows:
    [(m, rows_in, tile lanes), ...]."""
    out, rows = [], n // 4
    while n > NK.MAX_M:
        log1 = min((n.bit_length()) // 2, NK.MAX_LOG_M)
        n1, n2 = 1 << log1, n >> log1
        out.append((n1, rows // n2, n2 * lanes))
        lanes, n, rows = n1 * lanes, n2, n2
    out.append((n, rows, lanes))
    return out


def test_every_ntt_launch_of_the_wide_lde_is_taken():
    levels = _four_step_levels(ROWS, DATA)
    assert levels == [(1024, 256, 4096 * DATA), (64, 64, 64 * 1024 * DATA),
                      (64, 64, 64 * 1024 * DATA)]
    for m, rows_in, lanes in levels:
        assert m * lanes == WIDE
        assert NK.check_tile(m, rows_in, lanes) == m.bit_length() - 1


@pytest.mark.parametrize("m,rows_in,lanes", [
    (1024, 1024, 1 << 31), (1000, 10, 8), (64, 65, 8), (2048, 1, 8),
    (64, 1, -1)])
def test_the_ntt_refuses_what_it_cannot_index(m, rows_in, lanes):
    with pytest.raises(ValueError):
        NK.check_tile(m, rows_in, lanes)


def test_the_sponge_takes_the_wide_leaves():
    # one thread a hash at 2^22 rows; every layout takes the tile
    assert P2K.lanes_for(ROWS) == 1
    assert ROWS * DATA > 1 << 31
    for lanes in P2K.LANES:
        P2K.check_launch(DATA, lanes)


@pytest.mark.parametrize("cols,lanes", [(1 << 31, 1), (DATA, 3), (-1, 8)])
def test_the_sponge_refuses_what_it_cannot_index(cols, lanes):
    with pytest.raises(ValueError):
        P2K.check_launch(cols, lanes)


def test_the_weighted_sum_takes_the_wide_deep_sum():
    # the DEEP combination's z and zg sums over ctrl, data and accum
    k = CTRL + DATA + ACCUM
    cols, slices = BK.check_launch(ROWS, k, H100_SMS)
    assert (cols, slices) == BK.plan(ROWS, k, H100_SMS) == (704, 1)
    assert ROWS * k > 1 << 31
    # the α-combine of a few rows splits K; still taken
    assert BK.check_launch(8, 40000, H100_SMS)[1] > 1


@pytest.mark.parametrize("m,k", [(1 << 37, 8), (ROWS, 1 << 32),
                                 (8, BK.SLICE_MAX * (BK.MAX_SLICES + 1))])
def test_the_weighted_sum_refuses_what_it_cannot_index(m, k):
    with pytest.raises(ValueError):
        BK.check_launch(m, k, H100_SMS)


def test_the_constraint_kernel_takes_the_wide_grid():
    assert CK.check_grid(ROWS) == ROWS // CK.TR
    assert CK.check_grid((1 << 31) - 1) == 1 << 26
    for m in (1 << 31, CK.INV_RATE - 1):
        with pytest.raises(ValueError):
            CK.check_grid(m)


@pytest.mark.parametrize("rows,cols", [(1 << 19, 392), (ROWS, DATA)])
def test_the_yardstick_counts_a_wide_tile_linearly(rows, cols):
    # the leading sub-transform of an LDE of `rows` rows: 1024 rows of
    # rows / 1024 * cols lanes each, turned through the mid twiddles, and
    # a coset shift as it loads
    lanes = rows // 1024 * cols
    one = roofline.ntt_work(256, lanes // 8, 1024, n2=rows // 1024 // 8,
                            load=(1024, rows // 1024 // 8))
    whole = roofline.ntt_work(256, lanes, 1024, n2=rows // 1024,
                              load=(1024, rows // 1024))
    assert whole[0] == 8 * one[0]
    words = 256 * lanes + 1024 * lanes
    tables = 1024 * rows // 1024 + 1024 + rows // 1024
    assert whole[1] == (words + tables) * 4
    assert whole[0] == 6 * (512 * 10 * lanes + 1024 * lanes
                            + 256 * lanes) + 2 * 2 * 512 * 10 * lanes
    # the leaves: perms of ceil(cols / 16) blocks a row
    leaves = roofline.sponge_work(rows, cols, False, 8)
    eighth = roofline.sponge_work(rows // 8, cols, False, 8)
    assert leaves == (8 * eighth[0], 8 * eighth[1])
    perms = rows * -(-cols // 16)
    assert leaves[0] == 6 * perms * roofline.P2_PRODUCTS + 2 * (
        perms * roofline.P2_SUMS + rows * cols)
    assert leaves[1] == (rows * cols + rows * 8) * 4


def _lowered(config):
    """The shipped configuration at po2 8 and 8 queries (this test only).
    FRI's last degree goes from 256 to 16 with them: at po2 8 a degree of
    256 would leave FRI no round to fold, a proof the reference's verifier
    cannot read; at po2 20 it folds from a degree of 2^20."""
    cfg = copy.deepcopy(config)
    cfg["segment_po2"] = 8
    for ps in (cfg["proof_system"], cfg["control"]["proof_system"]):
        ps.update(queries=8, fri_min_degree=16)
    return cfg


def test_the_shipped_rv32im_configuration_is_judged():
    cell = harness.resolve("seg20-rv32im")
    assert cell.chips == 1
    assert cell.traffic["name"] == "segments-po2-20"
    shipped = cell.config
    assert (shipped["segment_po2"], shipped["variant"], shipped["path"]) == (
        20, "rv32im", "segment")
    assert shipped["proof_system"] == dict(queries=50, fri_min_degree=256,
                                           commit_expand=4)
    assert shipped["reduced"] == {}
    assert {m["name"] for m in cell.per_layer} == {
        "commit_s", "cons_m_roofline", "ntt_m_roofline"}
    cfg = _lowered(shipped)
    job = next(traffic.jobs(cell.traffic, cfg, 2 ** 33 + 20))
    assert job.cycles == 9 * job.input_words[0] + 20
    path = harness.path_module(cfg).Path
    out = path.export(path(cfg, "cpu").run_job(job))
    assert out["cycles"] == job.cycles
    # at po2 8 the blinded rows leave fewer cycles than the mix's fill:
    # every segment is judged
    assert {s["variant"] for s in out["segments"]} == {"rv32im"}
    checks = check.judge(cfg, [(0, out)], "cpu")
    assert checks["claim_fields_wrong"]["value"] == 0
    assert checks["proofs_rejected"]["value"] == 0
    assert check.passes(checks)

    journal = bytearray(out["journal"])
    journal[0] ^= 1
    checks = check.judge(cfg, [(0, dict(out, journal=bytes(journal)))],
                         "cpu")
    assert checks["claim_fields_wrong"]["value"] >= 1
    assert not check.passes(checks)

    control = path(cfg, "cpu",
                   proof_system=cfg["control"]["proof_system"])
    checks = check.judge(cfg, [(0, path.export(control.run_job(job)))],
                         "cpu")
    assert checks["proofs_rejected"]["value"] >= 1
    assert not check.passes(checks)


def test_rec20_1seg_is_the_cluster_path_on_one_segment_sessions():
    cell = harness.resolve("rec20-1seg")
    assert cell.chips == 1
    assert cell.config["name"] == "loop-rv32i-seg17-rec20"
    assert cell.config["path"] == "cluster"
    assert cell.traffic["name"] == "sessions-1seg"
    assert [m["name"] for m in cell.per_layer] == ["commit_s"]
    cap = check.segment_limit(cell.config["segment_po2"])
    sizes = traffic.targets(cell.traffic, cell.config)
    assert len(sizes) == 11 and max(sizes) < cap
    mod = harness.metric_module("commit_s")
    assert mod.read(type("T", (), {"registry": {
        ("span_seconds", (("span", "stark.commit"),)): (3.0, 4)}})) == 0.75
