"""Native (C++) witness generator must be bit-identical to the Python one."""

import dataclasses
import os

import numpy as np
import pytest

from boundless_tpu.zkvm import guests, witness
from boundless_tpu.zkvm.executor import Executor, GuestFault

PO2 = 9


def both(image, input_bytes):
    # Pin the blinding seed: the zk tail is random per witness (filled in
    # the shared _postprocess), so bit-parity needs the same stream.
    os.environ["BT_ZK_SEED"] = "1234"
    ex = Executor(image, input_bytes, segment_po2=PO2)
    res = ex.run()
    outs = []
    for seg in res.segments:
        py = witness.trace_segment(image, seg, PO2)
        nat = witness.trace_segment_native(image, seg, PO2)
        np.testing.assert_array_equal(nat.data, py.data)
        np.testing.assert_array_equal(nat.ctrl, py.ctrl)
        for key in py.pub:
            np.testing.assert_array_equal(np.asarray(nat.pub[key]),
                                          np.asarray(py.pub[key]), err_msg=key)
        outs.append(py)
    return res, outs


def test_echo_parity():
    both(guests.echo(), guests.words([3, 10, 20, 30]))


def test_loop_multisegment_parity():
    res, _ = both(guests.loop_guest(), guests.words([600]))
    assert len(res.segments) >= 2


def test_memtest_parity():
    both(guests.memtest(), guests.words([4, 9, 8, 7, 6]))


def test_identity_parity():
    both(guests.identity(), guests.words(list(range(8))))


def test_auipc_parity():
    both(guests.auipc_guest(), b"")


def test_subword_parity():
    both(guests.subword_guest(), b"")


@pytest.mark.parametrize("a,b", [
    (7, 3), (0xFFFFFFF9, 3), (0xFFFFFFF9, 0xFFFFFFFD), (7, 0),
    (0x80000000, 0xFFFFFFFF), (0x80000000, 1), (5, 0xFFFFFFFF),
    (0xDEADBEEF, 0xCAFEBABE),
])
def test_signed_m_parity(a, b):
    both(guests.signed_m_guest(), guests.words([a, b]))


ALU_SRC = """
start:
    li a0, -123456
    li a1, 789
    add a2, a0, a1
    sub a3, a0, a1
    slt a4, a0, a1
    sltu a5, a0, a1
    xor a6, a0, a1
    sll s6, a0, a1
    sra s8, a0, a1
    srli s4, a0, 7
    bltu a1, a0, over
    nop
over:
    li t0, 0
    li a0, 0
    ecall
"""


def test_alu_parity():
    both(guests.build(ALU_SRC), b"")


def test_native_faults_match():
    img = guests.build(".word 0xffffffff")
    ex = Executor(img, b"", segment_po2=PO2)
    try:
        ex.run()
    except GuestFault:
        pass
    # native gen on a hand-made segment with an unprovable instr faults too
    from boundless_tpu.zkvm.executor import Segment
    seg = Segment(index=0, po2=PO2, pre_pc=img.entry,
                  pre_regs=np.zeros(32, np.uint32), pre_mem=dict(img.words),
                  cycles=1, reads=[], pre_seqs=dict(commit=0, read=0, verify=0),
                  is_final=True, image_id=img.image_id())
    with pytest.raises(GuestFault):
        witness.trace_segment_native(img, seg, PO2)


def test_fast_execute_parity_and_speed():
    """C++ exec-only interpreter matches the Python executor exactly."""
    import time

    from boundless_tpu.zkvm.executor import fast_execute

    cases = [
        (guests.echo(), guests.words([3, 5, 6, 7])),
        (guests.loop_guest(), guests.words([5000])),
        (guests.muldiv(), guests.words([0xDEADBEEF, 12345])),
        (guests.memtest(), guests.words([3, 9, 8, 7])),
        (guests.keccak_guest(), b""),
    ]
    for image, inp in cases:
        res = Executor(image, inp).run()
        cycles, code, journal = fast_execute(image, inp)
        assert cycles == res.total_cycles
        assert code == res.exit_code
        assert journal == res.journal
    # speed: native should be >30x python on a big loop
    image, inp = guests.loop_guest(), guests.words([400_000])
    t0 = time.time()
    cycles, _, _ = fast_execute(image, inp)
    native_dt = time.time() - t0
    assert cycles > 800_000
    assert native_dt < 1.0, f"native exec too slow: {native_dt}s"


def test_fast_execute_faults():
    from boundless_tpu.zkvm.executor import fast_execute

    with pytest.raises(GuestFault):
        fast_execute(guests.build(".word 0xffffffff"))
    with pytest.raises(GuestFault):
        fast_execute(guests.echo(), b"")  # read past end of input
    with pytest.raises(GuestFault):
        fast_execute(guests.loop_guest(), guests.words([10**9]),
                     max_cycles=1000)


# A segment shorter than its image table: 300 data words sit before the
# code, so every fetched instruction's table row lies in the padding rows.
TABLE_PAST_CYCLES_SRC = """
start:
    j main
""" + "    .word 0\n" * 300 + """
main:
""" + guests.ECHO_SRC.replace("start:", "", 1)

# The columns the native pass writes after a row's own cells (the fetch
# multiplicities on the table rows, the degree helpers on every row).
TAIL_COLUMNS = ("mult_fetch", "sx", "is_addm", "is_subm", "sh_sra")


# The port's generator into a reused buffer (`trace_segment_native(out=)`,
# as `zkvm/prove.py`'s pool hands it): guests of different memory
# behaviour in turn, each into the buffer the one before left behind.
PORT_CHAIN = [
    ("memtest", lambda G: (G.memtest(), G.words([4, 9, 8, 7, 6]))),
    ("echo", lambda G: (G.echo(), G.words([3, 10, 20, 30]))),
    ("loop", lambda G: (G.loop_guest(), G.words([600]))),
    ("signed_m", lambda G: (G.signed_m_guest(),
                            G.words([0x80000000, 0xFFFFFFFF]))),
    ("keccak", lambda G: (G.keccak_guest(), b"")),
    ("table_past_cycles", lambda G: (G.build(TABLE_PAST_CYCLES_SRC),
                                     G.words([1, 5]))),
]
DIRT = np.int64(0x5A5A5A5A5A5A5A5A)


@pytest.mark.parametrize("step", range(len(PORT_CHAIN)),
                         ids=[name for name, _ in PORT_CHAIN])
def test_port_witness_into_a_dirty_buffer_is_word_equal(step):
    """A buffer filled with a nonzero pattern, then with every segment of
    the guest before this one in the chain, then with each segment of this
    guest: each such witness equals, word for word (data and publics), the
    one into a fresh array and the Python replay's."""
    from boundless_tpu_torch.air.rv32im import DC as TDC
    from boundless_tpu_torch.zkvm import guests as TG, witness as TW
    from boundless_tpu_torch.zkvm.executor import Executor as TExecutor

    def segments(i):
        image, inp = PORT_CHAIN[i][1](TG)
        return image, TExecutor(image, inp, segment_po2=PO2).run().segments

    rng = lambda: np.random.default_rng(1234)  # noqa: E731
    buf = np.full((1 << PO2, TDC.total), DIRT, dtype=np.int64)
    if step:
        image, segs = segments(step - 1)
        for seg in segs:
            TW.trace_segment_native(image, seg, PO2, rng(), out=buf)
    image, segs = segments(step)
    if PORT_CHAIN[step][0] == "loop":
        assert len(segs) >= 2
    for seg in segs:
        got = TW.trace_segment_native(image, seg, PO2, rng(), out=buf)
        assert got.data is buf
        for want in (TW.trace_segment_native(image, seg, PO2, rng()),
                     TW.trace_segment(image, seg, PO2, rng())):
            for name in TAIL_COLUMNS:
                col = getattr(TDC, name)
                np.testing.assert_array_equal(got.data[:, col],
                                              want.data[:, col],
                                              err_msg=name)
            np.testing.assert_array_equal(got.data[seg.cycles:],
                                          want.data[seg.cycles:],
                                          err_msg="padding and zk rows")
            np.testing.assert_array_equal(got.data, want.data)
            assert sorted(got.pub) == sorted(want.pub)
            for key in want.pub:
                np.testing.assert_array_equal(np.asarray(got.pub[key]),
                                              np.asarray(want.pub[key]),
                                              err_msg=key)

# (name, guest and input from a guests module, segments at least)
TAIL_GUESTS = [
    ("echo", lambda G: (G.echo(), G.words([3, 10, 20, 30])), 1),
    ("loop_multisegment", lambda G: (G.loop_guest(), G.words([600])), 2),
    ("memtest", lambda G: (G.memtest(), G.words([4, 9, 8, 7, 6])), 1),
    ("identity", lambda G: (G.identity(), G.words(list(range(8)))), 1),
    ("auipc", lambda G: (G.auipc_guest(), b""), 1),
    ("subword", lambda G: (G.subword_guest(), b""), 1),
    ("signed_m", lambda G: (G.signed_m_guest(),
                            G.words([0xFFFFFFF9, 0xFFFFFFFD])), 1),
    ("signed_m_overflow", lambda G: (G.signed_m_guest(),
                                     G.words([0x80000000, 0xFFFFFFFF])), 1),
    ("signed_m_by_zero", lambda G: (G.signed_m_guest(), G.words([7, 0])), 1),
    ("alu", lambda G: (G.build(ALU_SRC), b""), 1),
    ("keccak", lambda G: (G.keccak_guest(), b""), 1),
    ("table_past_cycles", lambda G: (G.build(TABLE_PAST_CYCLES_SRC),
                                     G.words([1, 5])), 1),
]


def _fetch_counts(pcs, image, rows):
    """The fetch multiplicities as the tail's per-cycle loop counted
    them: each fetched pc on its image-table row."""
    addr_to_trow = {a: i for i, (a, _) in
                    enumerate(sorted(image.words.items()))}
    want = np.zeros(rows, dtype=np.int64)
    for pc in pcs:
        want[addr_to_trow[int(pc) & ~3]] += 1
    return want


@pytest.mark.parametrize("name,make,min_segs", TAIL_GUESTS,
                         ids=[g[0] for g in TAIL_GUESTS])
def test_port_native_pass_writes_the_tail_columns_and_padding(name, make,
                                                              min_segs):
    """The port's native pass (fetch multiplicities, degree-helper
    columns, padding rows) is word-equal to the port's replay and to the
    JAX package's witness on every real row, and its multiplicities equal
    the per-cycle loop."""
    from boundless_tpu.air.rv32im import DC as JDC
    from boundless_tpu_torch.air import rv32im as TAIR
    from boundless_tpu_torch.air.rv32im import DC as TDC
    from boundless_tpu_torch.zkvm import guests as TG, witness as TW
    from boundless_tpu_torch.zkvm.executor import Executor as TExecutor

    assert JDC.total == TDC.total and all(
        getattr(JDC, c) == getattr(TDC, c) for c in TAIL_COLUMNS)
    image, inp = make(TG)
    jimage, jinp = make(guests)
    segs = TExecutor(image, inp, segment_po2=PO2).run().segments
    jsegs = Executor(jimage, jinp, segment_po2=PO2).run().segments
    assert len(segs) == len(jsegs) >= min_segs
    real = (1 << PO2) - TAIR.zk_rows(PO2)
    for seg, jseg in zip(segs, jsegs):  # the zk rows are left out
        nat = TW.trace_segment_native(image, seg, PO2).data[:real]
        rep = TW.trace_segment(image, seg, PO2).data[:real]
        ref = witness.trace_segment(jimage, jseg, PO2).data[:real]
        for want in (rep, ref):
            for col in TAIL_COLUMNS:
                np.testing.assert_array_equal(
                    nat[:, getattr(TDC, col)], want[:, getattr(TDC, col)],
                    err_msg=col)
            np.testing.assert_array_equal(nat[seg.cycles:],
                                          want[seg.cycles:],
                                          err_msg="padding rows")
        mult = nat[:, TDC.mult_fetch]
        np.testing.assert_array_equal(
            mult, _fetch_counts(nat[: seg.cycles, TDC.pc], image, real))
        assert mult.sum() == seg.cycles
        if name == "table_past_cycles":
            assert seg.cycles < len(image.words)
            # every fetch but the first jump's lands among the padding rows
            assert mult[seg.cycles:].sum() == seg.cycles - 1
        if name == "keccak":
            assert mult.max() >= 50  # the burst's 50 rows fetch its ecall


@pytest.mark.parametrize("native", [True, False], ids=["native", "replay"])
def test_port_witness_ctrl_is_the_image_s_ctrl_trace(native):
    from boundless_tpu_torch.zkvm import guests as TG, witness as TW
    from boundless_tpu_torch.zkvm.executor import Executor as TExecutor

    image = TG.build(TABLE_PAST_CYCLES_SRC)
    seg = TExecutor(image, TG.words([1, 5]),
                    segment_po2=PO2).run().segments[0]
    gen = TW.trace_segment_native if native else TW.trace_segment
    w = gen(image, seg, PO2, np.random.default_rng(3))
    np.testing.assert_array_equal(w.ctrl, TW.build_ctrl_trace(image, PO2))
    assert w.ctrl is w.ctrl  # built once, at the first read
    # a copy with its own data (as chip_smoke.phase_main keeps) has the
    # same ctrl trace
    c = dataclasses.replace(w, data=w.data.copy())
    np.testing.assert_array_equal(c.ctrl, w.ctrl)


def test_port_prove_segment_builds_no_ctrl_trace_once_the_image_s_is_kept(
        monkeypatch):
    from boundless_tpu_torch.zkvm import guests as TG, prove as TP
    from boundless_tpu_torch.zkvm import witness as TW
    from boundless_tpu_torch.zkvm.executor import Executor as TExecutor

    image = TG.echo()
    seg = TExecutor(image, TG.words([2, 11, 22]),
                    segment_po2=8).run().segments[0]
    TP._image_ctrl(image, 8, TP.TEST_PS, "cpu")
    built = []
    real = TW.build_ctrl_trace
    monkeypatch.setattr(TW, "build_ctrl_trace",
                        lambda *a: built.append(a) or real(*a))
    r = TP.prove_segment(image, seg, TP.TEST_PS, device="cpu",
                         rng=np.random.default_rng(5))
    assert TP.verify_segment(r, TP.TEST_PS)
    assert built == []
