"""Trace-domain constraint checker parity: the port's
`air/debug.check_constraints` against the JAX package's on the CPU, on the
same witnesses, tolerance 0: the `(ok, [(index, count), ...])` results
must be equal.

The cases of JAX `tests/test_rv32im_air.py` (the valid witnesses of the
echo, loop, memtest, identity, ALU-coverage, AUIPC and sub-word guests,
and the tampered ones of `test_auipc_tampered_rdv_fails`,
`test_subword_tampered_merge_fails` and `test_tampered_witness_fails_air`)
and of `tests/test_recursion_air.py` (the demo program, valid and with a
corrupted wire). The witnesses come from the JAX package (numpy) and go to
both checkers."""

import os
import sys

import numpy as np
import pytest

from boundless_tpu.air import debug as jdebug
from boundless_tpu.air.rv32im import DC
from boundless_tpu.core import field as JF
from boundless_tpu.zkvm import guests as JG
from boundless_tpu.zkvm import witness as JW
from boundless_tpu_torch import convert
from boundless_tpu_torch.air import debug
from boundless_tpu_torch.air.rv32im import Rv32imAir
from boundless_tpu_torch.core import field as F
from boundless_tpu_torch.recursion import air as rair
from boundless_tpu_torch.zkvm import witness

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_rv32im_air import AIR as JAIR  # noqa: E402
from test_rv32im_air import REAL, run_and_witness  # noqa: E402

AIR = Rv32imAir()


def both(w_ctrl, w_data, w_pub):
    """(port result, JAX result) of one canonical witness."""
    got = debug.check_constraints(AIR, F.fp(w_ctrl), F.fp(w_data),
                                  witness.to_public_values(w_pub))
    want = jdebug.check_constraints(JAIR, JF.fp(w_ctrl), JF.fp(w_data),
                                    JW.to_public_values(w_pub))
    return got, (want[0], [(int(i), int(n)) for i, n in want[1]])


# the program of test_rv32im_air.test_alu_coverage_witness
ALU_SRC = """
start:
    li a0, -7
    li a1, 3
    add a2, a0, a1
    sub a3, a0, a1
    slt a4, a0, a1
    sltu a5, a0, a1
    xor a6, a0, a1
    or a7, a0, a1
    and s2, a0, a1
    slli s3, a0, 4
    srli s4, a0, 3
    srai s5, a0, 3
    sll s6, a0, a1
    srl s7, a0, a1
    sra s8, a0, a1
    sltiu s9, a0, -1
    blt a0, a1, ok
    li t0, 0
    li a0, 1
    ecall
ok:
    bge a1, a0, ok2
    li t0, 0
    li a0, 2
    ecall
ok2:
    li t0, 0
    li a0, 0
    ecall
"""


def _digest_words():
    digest = bytes(range(32))
    return [int.from_bytes(digest[i:i + 4], "little")
            for i in range(0, 32, 4)]


VALID = {
    "echo": lambda: (JG.echo(), JG.words([2, 123456, 0xFFFF0001])),
    "loop": lambda: (JG.loop_guest(), JG.words([40])),
    "memtest": lambda: (JG.memtest(), JG.words([3, 5, 6, 7])),
    "identity": lambda: (JG.identity(), JG.words(_digest_words())),
    "alu": lambda: (JG.build(ALU_SRC), b""),
    "auipc": lambda: (JG.auipc_guest(), b""),
    "subword": lambda: (JG.subword_guest(), b""),
}


@pytest.mark.parametrize("name", sorted(VALID))
def test_valid_witness_equals_jax(name):
    _, w = run_and_witness(*VALID[name]())
    got, want = both(w.ctrl, w.data, w.pub)
    assert got == want == (True, [])


def test_auipc_tampered_rdv_equals_jax():
    _, w = run_and_witness(JG.auipc_guest(), b"")
    bad = w.data.copy()
    rows = np.nonzero(bad[:REAL, DC.sel.start + 1])[0]
    assert rows.size == 4
    bad[rows[0], DC.rdv.start] = (bad[rows[0], DC.rdv.start] + 1) % JF.P
    got, want = both(w.ctrl, bad, w.pub)
    assert got == want and not got[0] and got[1]


def test_subword_tampered_merge_equals_jax():
    _, w = run_and_witness(JG.subword_guest(), b"")
    bad = w.data.copy()
    rows = np.nonzero(bad[:REAL, DC.sel.start + 6] *
                      bad[:REAL, DC.f3.start + 0])[0]  # SB rows
    assert rows.size == 1
    col = DC.a_bits.start + 16  # a preserved byte of the merged word
    bad[rows[0], col] = 1 - bad[rows[0], col]
    got, want = both(w.ctrl, bad, w.pub)
    assert got == want and not got[0] and got[1]


def test_echo_tampered_rdv_equals_jax():
    _, w = run_and_witness(JG.echo(), JG.words([1, 42]))
    bad = w.data.copy()
    bad[3, DC.rdv.start] = (bad[3, DC.rdv.start] + 1) % JF.P
    got, want = both(w.ctrl, bad, w.pub)
    assert got == want and not got[0] and got[1]


def _recursion_case(tamper: bool):
    from boundless_tpu.recursion import air as jrair
    from boundless_tpu.recursion import vm as jvm
    from test_recursion_air import N, _demo_pub

    prog, inputs, pub_vals = _demo_pub()
    ctrl = jrair.rom_trace(prog, N)
    data = np.asarray(jrair.data_trace(prog, inputs, pub_vals)).copy()
    if tamper:
        data[3, jvm.DC.out.start] ^= 5  # one out component of an active row
    got = debug.check_constraints(rair.AIR, convert.tensor(ctrl),
                                  convert.tensor(data),
                                  rair.pub_array(pub_vals, "cpu"))
    want = jdebug.check_constraints(jrair.AIR, ctrl, data,
                                    jrair.pub_array(pub_vals))
    return got, (want[0], [(int(i), int(n)) for i, n in want[1]])


@pytest.mark.parametrize("tamper", [False, True])
def test_recursion_demo_equals_jax(tamper):
    got, want = _recursion_case(tamper)
    assert got == want
    assert got[0] is not tamper and bool(got[1]) is tamper


def test_globals_seed_is_free():
    """Any globals satisfy a valid witness; a tampered one fails under
    each."""
    _, w = run_and_witness(JG.echo(), JG.words([1, 42]))
    bad = w.data.copy()
    bad[3, DC.rdv.start] = (bad[3, DC.rdv.start] + 1) % JF.P
    pub = witness.to_public_values(w.pub)
    for seed in (1, 99):
        assert debug.check_constraints(AIR, F.fp(w.ctrl), F.fp(w.data), pub,
                                       globals_seed=seed) == (True, [])
        ok, failures = debug.check_constraints(AIR, F.fp(w.ctrl),
                                               F.fp(bad), pub,
                                               globals_seed=seed)
        assert not ok and failures
