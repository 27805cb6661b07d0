"""Native (C++) witness generator must be bit-identical to the Python one."""

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


def test_alu_parity():
    src = """
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
    both(guests.build(src), b"")


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
            np.testing.assert_array_equal(got.data, want.data)
            assert sorted(got.pub) == sorted(want.pub)
            for key in want.pub:
                np.testing.assert_array_equal(np.asarray(got.pub[key]),
                                              np.asarray(want.pub[key]),
                                              err_msg=key)
