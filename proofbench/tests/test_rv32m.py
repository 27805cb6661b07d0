"""The reference interpreter's M extension, on the CPU.

Cases from the RISC-V unprivileged ISA's "M" chapter, its table of
special cases among them, against Python's integer arithmetic; seeded
random programs of M and ALU instructions run in a loop, against the
port's executor; and the plain RV32I interpreter refusing an M op.

    python -m pytest proofbench/tests -q -p no:xdist -o addopts=""
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import pytest

from proofbench.reference import check, rv32i

M32 = 0xFFFFFFFF
MIN = 1 << 31  # -2^31 as a word
OPS = ("mul", "mulh", "mulhsu", "mulhu", "div", "divu", "rem", "remu")


def _signed(v):
    return v - (1 << 32) if v & MIN else v


def _python(op, a, b):
    """The instruction's result from Python's integers, as the chapter
    defines it: products exact, quotients rounded toward zero."""
    sa, sb = _signed(a), _signed(b)
    if op == "mul":
        return (sa * sb) % (1 << 32)
    if op in ("mulh", "mulhsu", "mulhu"):
        x = sa if op != "mulhu" else a
        y = sb if op == "mulh" else b
        return ((x * y) // (1 << 32)) % (1 << 32)
    if op in ("divu", "remu"):
        if b == 0:
            return M32 if op == "divu" else a
        return a // b if op == "divu" else a % b
    if b == 0:
        return M32 if op == "div" else a
    q = math.trunc(Fraction(sa, sb))
    if op == "div":
        return q % (1 << 32)
    return (sa - q * sb) % (1 << 32)


# (op, rs1, rs2, the result the chapter's table gives, or None where
# only the arithmetic above decides)
CASES = [
    # division by zero: quotient all ones, remainder the dividend
    ("div", 7, 0, M32), ("divu", 7, 0, M32), ("rem", 7, 0, 7),
    ("remu", 7, 0, 7), ("div", MIN, 0, M32), ("rem", MIN, 0, MIN),
    ("divu", 0, 0, M32), ("remu", 0, 0, 0), ("rem", M32, 0, M32),
    # overflow: -2^31 / -1 = -2^31, remainder 0
    ("div", MIN, M32, MIN), ("rem", MIN, M32, 0),
    # signs: the quotient rounds toward zero, the remainder takes the
    # dividend's sign
    ("div", (-7) & M32, 2, (-3) & M32), ("rem", (-7) & M32, 2, (-1) & M32),
    ("div", 7, (-2) & M32, (-3) & M32), ("rem", 7, (-2) & M32, 1),
    ("div", (-7) & M32, (-2) & M32, 3), ("rem", (-7) & M32, (-2) & M32,
                                         (-1) & M32),
    ("divu", (-7) & M32, 2, 0x7FFFFFFC), ("remu", (-7) & M32, 2, 1),
    ("div", MIN, 1, MIN), ("divu", MIN, M32, 0), ("remu", MIN, M32, MIN),
    # products: the low word, and the high word by the operands' signs
    ("mul", M32, M32, 1), ("mulh", M32, M32, 0), ("mulhu", M32, M32,
                                                  0xFFFFFFFE),
    ("mulhsu", M32, M32, M32), ("mulhsu", 1, M32, 0),
    ("mulh", MIN, MIN, 0x40000000), ("mulhu", MIN, MIN, 0x40000000),
    ("mulhsu", MIN, M32, 0x80000000), ("mul", MIN, MIN, 0),
    ("mul", 0x12345678, 0x9ABCDEF0, None), ("mulh", 0x12345678, 0x9ABCDEF0,
                                             None),
    ("mulhsu", 0x9ABCDEF0, 0x12345678, None),
    ("mulhu", 0x9ABCDEF0, 0x12345678, None),
    ("div", 0x7FFFFFFF, 0x12345, None), ("rem", 0x80000001, 0x7FFF, None),
]

# t0 = x5 selects the ecall; a0 = x10, a1 = x11, a2 = x12
F3 = {op: i for i, op in enumerate(OPS)}
HALT = [0x00000293, 0x00000513, 0x00000073]  # li t0, 0; li a0, 0; ecall
READ_A0 = [0x00200293, 0x00000073]  # li t0, 2; ecall
COMMIT_A0 = [0x00100293, 0x00000073]  # li t0, 1; ecall


def _r(rd, rs1, rs2, f3, f7):
    return f7 << 25 | rs2 << 20 | rs1 << 15 | f3 << 12 | rd << 7 | 0x33


def _i(rd, rs1, imm, f3):
    return (imm & 0xFFF) << 20 | rs1 << 15 | f3 << 12 | rd << 7 | 0x13


def _one_op(op):
    """read a1, read a2, a0 = op(a1, a2), commit a0, halt."""
    mv = [_i(11, 10, 0, 0)], [_i(12, 10, 0, 0)]
    body = READ_A0 + mv[0] + READ_A0 + mv[1] + [_r(10, 11, 12, F3[op], 1)]
    return {0x1000 + 4 * k: w for k, w in
            enumerate(body + COMMIT_A0 + HALT)}


@pytest.mark.parametrize("op,a,b,want", CASES)
def test_an_m_instruction_gives_what_the_chapter_gives(op, a, b, want):
    run = rv32i.execute(_one_op(op), 0x1000, [a, b], 1 << 12, m_ext=True)
    assert run.journal == [_python(op, a, b)]
    if want is not None:
        assert run.journal == [want]
    # one cycle an instruction: 2 x (li, ecall, mv), the op, li and
    # ecall to commit, li, li and ecall to halt
    assert run.cycles == 12


def test_an_rv32i_configuration_refuses_an_m_instruction():
    with pytest.raises(rv32i.GuestError, match="M extension"):
        rv32i.execute(_one_op("mulhu"), 0x1000, [3, 5], 1 << 12)
    # the judge runs the plain RV32I interpreter for an rv32i variant
    words = _one_op("mulhu")
    config = dict(segment_po2=8, variant="rv32i",
                  proof_system=dict(queries=8, fri_min_degree=16,
                                    commit_expand=4),
                  program=dict(base=0x1000, entry=0x1000,
                               words=[words[a] for a in sorted(words)]))
    with pytest.raises(rv32i.GuestError, match="M extension"):
        check.judge(config, [(0, dict(kind="segments", inputs=[3, 5]))],
                    "cpu")


ALU = [(0, 0), (0, 0x20), (1, 0), (2, 0), (3, 0), (4, 0), (5, 0),
       (5, 0x20), (6, 0), (7, 0)]  # add sub sll slt sltu xor srl sra or and
SPECIAL = [0, 1, M32, MIN, MIN - 1, 0x80000001]


def _random_program(rng):
    """Read 8 words into x6..x13, then run a block of M and ALU
    instructions on x6..x15 n times (n read first, into s11 = x27),
    commit x6..x15 and halt; returns (words, inputs)."""
    words = READ_A0 + [_i(27, 10, 0, 0)]
    for r in range(6, 14):
        words += READ_A0 + [_i(r, 10, 0, 0)]
    regs = range(6, 16)
    block = []
    for _ in range(int(rng.integers(6, 16))):
        rd, rs1, rs2 = (int(rng.choice(regs)) for _ in range(3))
        kind = rng.integers(0, 3)
        if kind == 0:
            block.append(_r(rd, rs1, rs2, int(rng.integers(0, 8)), 1))
        elif kind == 1:
            f3, f7 = ALU[int(rng.integers(0, len(ALU)))]
            block.append(_r(rd, rs1, rs2, f3, f7))
        else:  # addi, xori, slli, srai
            f3 = int(rng.choice([0, 4, 1, 5]))
            imm = int(rng.integers(-2048, 2048)) if f3 in (0, 4) else \
                int(rng.integers(0, 32)) | (0x400 if f3 == 5 else 0)
            block.append(_i(rd, rs1, imm, f3))
    # loop: beq s11, zero, done; block; addi s11, s11, -1; j loop
    n_block = len(block) + 2
    beq = ((n_block + 1) * 4)  # forward to done
    words.append((((beq >> 12) & 1) << 31) | (((beq >> 5) & 0x3F) << 25)
                 | (0 << 20) | (27 << 15) | (0 << 12)
                 | (((beq >> 1) & 0xF) << 8) | (((beq >> 11) & 1) << 7)
                 | 0x63)
    words += block + [_i(27, 27, -1, 0)]
    back = (-(n_block) * 4) & 0x1FFFFF  # jal x0 back to the beq
    words.append((((back >> 20) & 1) << 31) | (((back >> 1) & 0x3FF) << 21)
                 | (((back >> 11) & 1) << 20) | (((back >> 12) & 0xFF) << 12)
                 | 0x6F)
    for r in regs:
        words += [_i(10, r, 0, 0)] + COMMIT_A0
    words += HALT
    vals = [int(rng.choice(SPECIAL)) if rng.random() < 0.4 else
            int(rng.integers(0, 1 << 32)) for _ in range(8)]
    return words, [int(rng.integers(1, 40))] + vals


@pytest.mark.parametrize("seed", range(60))
def test_the_reference_runs_random_m_programs_as_the_port_does(seed):
    from boundless_tpu_torch.zkvm import guests
    from boundless_tpu_torch.zkvm.executor import Executor, MemoryImage

    rng = np.random.default_rng([seed, 0x3332])
    words, inputs = _random_program(rng)
    po2 = 8  # segments of 188 cycles: most programs span several
    image = MemoryImage.from_words(words, 0x1000, 0x1000)
    ex = Executor(image, guests.words(inputs), segment_po2=po2)
    got = ex.run()
    run = rv32i.execute({0x1000 + 4 * k: w for k, w in enumerate(words)},
                        0x1000, inputs, check.segment_limit(po2), m_ext=True)
    assert run.cycles == got.total_cycles
    assert b"".join(w.to_bytes(4, "little") for w in run.journal) \
        == got.journal
    assert run.exit_code == got.exit_code
    assert run.final_regs == [int(r) for r in ex.regs]
    assert run.final_pc == ex.pc
    assert len(run.segments) == len(got.segments)
    for want, seg in zip(run.segments, got.segments):
        assert (want.pre_pc, want.cycles, want.halted) == (
            seg.pre_pc, seg.cycles, seg.is_final)
        assert want.pre_regs == [int(r) for r in seg.pre_regs]
        assert [lo | hi << 16 for tag, _, lo, hi in want.io
                if tag == rv32i.TAG_READ] == seg.reads
