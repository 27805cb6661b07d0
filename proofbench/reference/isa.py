"""RV32IM instruction encoding/decoding tables.

Frozen copy of `boundless_tpu_torch/zkvm/isa.py` for the
benchmark's reference (plain torch and numpy; no kernel of the port).

Encoder used by the in-repo mini-assembler (no RISC-V toolchain exists in
the build image); decoder used by the executor and by witness generation.
Functional equivalent of the rv32im layer the reference gets from
`risc0-zkvm ExecutorImpl` (reference `prover/crates/workflow/src/tasks/
executor.rs:721-786`).

The port's own copy of `boundless_tpu/zkvm/isa.py` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

# opcode major groups
OP_LUI = 0b0110111
OP_AUIPC = 0b0010111
OP_JAL = 0b1101111
OP_JALR = 0b1100111
OP_BRANCH = 0b1100011
OP_LOAD = 0b0000011
OP_STORE = 0b0100011
OP_IMM = 0b0010011
OP_REG = 0b0110011
OP_SYSTEM = 0b1110011
OP_FENCE = 0b0001111

REG_NAMES = {
    "zero": 0, "ra": 1, "sp": 2, "gp": 3, "tp": 4, "t0": 5, "t1": 6,
    "t2": 7, "s0": 8, "fp": 8, "s1": 9, "a0": 10, "a1": 11, "a2": 12,
    "a3": 13, "a4": 14, "a5": 15, "a6": 16, "a7": 17, "s2": 18, "s3": 19,
    "s4": 20, "s5": 21, "s6": 22, "s7": 23, "s8": 24, "s9": 25, "s10": 26,
    "s11": 27, "t3": 28, "t4": 29, "t5": 30, "t6": 31,
}
for _i in range(32):
    REG_NAMES[f"x{_i}"] = _i


def _u(v, bits):
    return v & ((1 << bits) - 1)


def enc_r(op, rd, f3, rs1, rs2, f7):
    return op | (rd << 7) | (f3 << 12) | (rs1 << 15) | (rs2 << 20) | (f7 << 25)


def enc_i(op, rd, f3, rs1, imm):
    return op | (rd << 7) | (f3 << 12) | (rs1 << 15) | (_u(imm, 12) << 20)


def enc_s(op, f3, rs1, rs2, imm):
    imm = _u(imm, 12)
    return (op | ((imm & 0x1F) << 7) | (f3 << 12) | (rs1 << 15)
            | (rs2 << 20) | ((imm >> 5) << 25))


def enc_b(op, f3, rs1, rs2, imm):
    imm = _u(imm, 13)
    return (op | (((imm >> 11) & 1) << 7) | (((imm >> 1) & 0xF) << 8)
            | (f3 << 12) | (rs1 << 15) | (rs2 << 20)
            | (((imm >> 5) & 0x3F) << 25) | (((imm >> 12) & 1) << 31))


def enc_u(op, rd, imm):
    return op | (rd << 7) | (_u(imm, 32) & 0xFFFFF000)


def enc_j(op, rd, imm):
    imm = _u(imm, 21)
    return (op | (rd << 7) | (((imm >> 12) & 0xFF) << 12)
            | (((imm >> 11) & 1) << 20) | (((imm >> 1) & 0x3FF) << 21)
            | (((imm >> 20) & 1) << 31))


# name -> (format, encoder args)
R_OPS = {
    "add": (0b000, 0b0000000), "sub": (0b000, 0b0100000),
    "sll": (0b001, 0b0000000), "slt": (0b010, 0b0000000),
    "sltu": (0b011, 0b0000000), "xor": (0b100, 0b0000000),
    "srl": (0b101, 0b0000000), "sra": (0b101, 0b0100000),
    "or": (0b110, 0b0000000), "and": (0b111, 0b0000000),
    # M extension
    "mul": (0b000, 0b0000001), "mulh": (0b001, 0b0000001),
    "mulhsu": (0b010, 0b0000001), "mulhu": (0b011, 0b0000001),
    "div": (0b100, 0b0000001), "divu": (0b101, 0b0000001),
    "rem": (0b110, 0b0000001), "remu": (0b111, 0b0000001),
}
I_OPS = {
    "addi": 0b000, "slti": 0b010, "sltiu": 0b011, "xori": 0b100,
    "ori": 0b110, "andi": 0b111,
}
SHIFT_I_OPS = {"slli": (0b001, 0), "srli": (0b101, 0), "srai": (0b101, 0b0100000)}
LOAD_OPS = {"lb": 0b000, "lh": 0b001, "lw": 0b010, "lbu": 0b100, "lhu": 0b101}
STORE_OPS = {"sb": 0b000, "sh": 0b001, "sw": 0b010}
BRANCH_OPS = {
    "beq": 0b000, "bne": 0b001, "blt": 0b100, "bge": 0b101,
    "bltu": 0b110, "bgeu": 0b111,
}


def sign_extend(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    if v & (1 << (bits - 1)):
        v -= 1 << bits
    return v


def decode(word: int):
    """Decode a 32-bit instruction word into a dict of fields."""
    op = word & 0x7F
    rd = (word >> 7) & 0x1F
    f3 = (word >> 12) & 0x7
    rs1 = (word >> 15) & 0x1F
    rs2 = (word >> 20) & 0x1F
    f7 = (word >> 25) & 0x7F
    imm_i = sign_extend(word >> 20, 12)
    imm_s = sign_extend(((word >> 25) << 5) | ((word >> 7) & 0x1F), 12)
    imm_b = sign_extend(
        (((word >> 31) & 1) << 12) | (((word >> 7) & 1) << 11)
        | (((word >> 25) & 0x3F) << 5) | (((word >> 8) & 0xF) << 1), 13)
    imm_u = word & 0xFFFFF000
    imm_j = sign_extend(
        (((word >> 31) & 1) << 20) | (((word >> 12) & 0xFF) << 12)
        | (((word >> 20) & 1) << 11) | (((word >> 21) & 0x3FF) << 1), 21)
    return dict(op=op, rd=rd, f3=f3, rs1=rs1, rs2=rs2, f7=f7,
                imm_i=imm_i, imm_s=imm_s, imm_b=imm_b, imm_u=imm_u,
                imm_j=imm_j, word=word)
