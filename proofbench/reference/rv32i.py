"""A plain RV32I interpreter, with the M extension on request (RV32IM):
the reference's own execution of a guest.

It runs the program words the benchmark made, on the inputs the benchmark
drew, and reports what a receipt claims: the cycles, the journal, the
exit code and, for each continuation segment, the machine state at its
ends, its public io rows and the memory words it touched. It shares no
code with the port's executor; its rules are the zkVM's (one cycle an
instruction, one an ecall; a segment ends when its cycles reach the
segment's limit or the guest halts). The eight RV32M instructions
(`execute(..., m_ext=True)`) follow the RISC-V unprivileged ISA's "M"
chapter, its table of special cases included: a division by zero gives
a quotient of all ones and the dividend as the remainder; -2^31 / -1
gives -2^31, remainder 0. Each takes one cycle, as every instruction
does. Without `m_ext` an M instruction raises, as in plain RV32I.

Ecalls (t0): 0 halt (exit code a0), 1 commit a0 to the journal, 2 read
the next input word into a0, 3 log (no effect on the claim). Verify and
the keccak coprocessor are outside the configurations this benchmark
runs, and raise.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List

M32 = 0xFFFFFFFF
TAG_COMMIT, TAG_READ = 4, 5  # the io table's tags (journal, input)
PAGE_WORDS = 64  # words of a memory page


class GuestError(Exception):
    pass


@dataclasses.dataclass
class SegmentRun:
    pre_pc: int
    post_pc: int
    pre_regs: List[int]
    post_regs: List[int]
    pre_seqs: List[int]  # commit, read, verify, cpio counters
    post_seqs: List[int]
    io: List[tuple]  # (tag, seq, lo, hi) in execution order
    halted: bool
    cycles: int
    pre_mem: Dict[int, int]  # word address -> value, of touched words
    post_mem: Dict[int, int]
    page_words: Dict[int, int]  # every word of a touched page, at entry


@dataclasses.dataclass
class Run:
    cycles: int
    journal: List[int]
    exit_code: int
    inputs_read: List[int]
    segments: List[SegmentRun]
    final_pc: int
    final_regs: List[int]
    memory: Dict[int, int]  # word address -> value at the end


def _sx(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


@functools.lru_cache(maxsize=4096)
def _decode(word: int):
    op = word & 0x7F
    rd = (word >> 7) & 0x1F
    f3 = (word >> 12) & 7
    rs1 = (word >> 15) & 0x1F
    rs2 = (word >> 20) & 0x1F
    f7 = word >> 25
    imm_i = _sx(word >> 20, 12)
    imm_s = _sx(((word >> 25) << 5) | ((word >> 7) & 0x1F), 12)
    imm_b = _sx((((word >> 31) & 1) << 12) | (((word >> 7) & 1) << 11)
                | (((word >> 25) & 0x3F) << 5) | (((word >> 8) & 0xF) << 1),
                13)
    imm_u = word & 0xFFFFF000
    imm_j = _sx((((word >> 31) & 1) << 20) | (((word >> 12) & 0xFF) << 12)
                | (((word >> 20) & 1) << 11) | (((word >> 21) & 0x3FF) << 1),
                21)
    return op, rd, f3, rs1, rs2, f7, imm_i, imm_s, imm_b, imm_u, imm_j


def _alu(f3: int, a: int, b: int, alt: bool) -> int:
    if f3 == 0:
        return (a - b) & M32 if alt else (a + b) & M32
    if f3 == 1:
        return (a << (b & 31)) & M32
    if f3 == 2:
        return int(_sx(a, 32) < _sx(b, 32))
    if f3 == 3:
        return int(a < b)
    if f3 == 4:
        return a ^ b
    if f3 == 5:
        return (_sx(a, 32) >> (b & 31)) & M32 if alt else a >> (b & 31)
    if f3 == 6:
        return a | b
    return a & b


def _mext(f3: int, a: int, b: int) -> int:
    """RV32M (funct7 0000001) on the unsigned words a = rs1, b = rs2."""
    sa, sb = _sx(a, 32), _sx(b, 32)
    if f3 == 0:  # MUL: the low word of the product
        return (a * b) & M32
    if f3 == 1:  # MULH: signed x signed, the high word
        return ((sa * sb) >> 32) & M32
    if f3 == 2:  # MULHSU: signed rs1 x unsigned rs2, the high word
        return ((sa * b) >> 32) & M32
    if f3 == 3:  # MULHU: unsigned x unsigned, the high word
        return (a * b) >> 32
    if f3 in (4, 6):  # DIV, REM: signed, the quotient rounded toward 0
        if b == 0:
            return M32 if f3 == 4 else a
        q = abs(sa) // abs(sb)
        if (sa < 0) != (sb < 0):
            q = -q
        # -2^31 / -1 gives 2^31 here, which wraps to -2^31 (remainder 0)
        return q & M32 if f3 == 4 else (sa - q * sb) & M32
    if b == 0:  # DIVU, REMU
        return M32 if f3 == 5 else a
    return a // b if f3 == 5 else a % b


def execute(words: Dict[int, int], entry: int, inputs: List[int],
            segment_limit: int, max_cycles: int = 1 << 32,
            m_ext: bool = False) -> Run:
    """Run the program `words` (byte address -> u32) from `entry`; with
    `m_ext` the M extension's instructions run, else they raise."""
    mem = {a >> 2: w & M32 for a, w in words.items()}
    regs = [0] * 32
    pc = entry
    journal, reads = [], []
    seqs = [0, 0, 0, 0]
    segments: List[SegmentRun] = []
    total = 0
    exit_code = None
    while exit_code is None:
        pre = (pc, list(regs), list(seqs))
        io, touched = [], {}
        cycles = 0
        while cycles < segment_limit and exit_code is None:
            if pc & 3:
                raise GuestError(f"misaligned pc {pc:#x}")
            word = mem.get(pc >> 2, 0)
            (op, rd, f3, rs1, rs2, f7, imm_i, imm_s, imm_b, imm_u,
             imm_j) = _decode(word)
            a, b = regs[rs1], regs[rs2]
            nxt = (pc + 4) & M32
            val = None
            if op == 0b0110111:  # LUI
                val = imm_u
            elif op == 0b0010111:  # AUIPC
                val = (pc + imm_u) & M32
            elif op == 0b1101111:  # JAL
                val, nxt = nxt, (pc + imm_j) & M32
            elif op == 0b1100111:  # JALR
                val, nxt = nxt, (a + imm_i) & M32 & ~1
            elif op == 0b1100011:  # BRANCH
                sa, sb = _sx(a, 32), _sx(b, 32)
                taken = {0: a == b, 1: a != b, 4: sa < sb, 5: sa >= sb,
                         6: a < b, 7: a >= b}.get(f3)
                if taken is None:
                    raise GuestError(f"illegal branch at {pc:#x}")
                if taken:
                    nxt = (pc + imm_b) & M32
            elif op == 0b0000011:  # LOAD
                addr = (a + imm_i) & M32
                size = {0: 1, 1: 2, 2: 4, 4: 1, 5: 2}[f3]
                if addr % size:
                    raise GuestError(f"misaligned load at {addr:#x}")
                w = mem.get(addr >> 2, 0)
                touched.setdefault(addr >> 2, w)
                v = (w >> ((addr & 3) * 8)) & ((1 << (8 * size)) - 1)
                val = _sx(v, 8 * size) & M32 if f3 in (0, 1) else v
            elif op == 0b0100011:  # STORE
                addr = (a + imm_s) & M32
                size = {0: 1, 1: 2, 2: 4}[f3]
                if addr % size:
                    raise GuestError(f"misaligned store at {addr:#x}")
                w = mem.get(addr >> 2, 0)
                touched.setdefault(addr >> 2, w)
                sh = (addr & 3) * 8
                mask = ((1 << (8 * size)) - 1) << sh
                mem[addr >> 2] = (w & ~mask) | ((b << sh) & mask)
            elif op == 0b0010011:  # OP-IMM
                if f3 in (1, 5):
                    val = _alu(f3, a, imm_i & 31, bool((word >> 30) & 1))
                else:
                    val = _alu(f3, a, imm_i & M32, False)
            elif op == 0b0110011:  # OP
                if f7 & 1:
                    if not m_ext:
                        raise GuestError("the M extension is not in rv32i")
                    if f7 != 1:
                        raise GuestError(f"illegal instruction {word:#010x} "
                                         f"at {pc:#x}")
                    val = _mext(f3, a, b)
                else:
                    val = _alu(f3, a, b, bool((word >> 30) & 1))
            elif op == 0b1110011:  # ECALL
                code, a0 = regs[5], regs[10]
                if code == 0:
                    exit_code = a0
                elif code == 1:
                    journal.append(a0)
                    io.append((TAG_COMMIT, seqs[0], a0 & 0xFFFF, a0 >> 16))
                    seqs[0] += 1
                elif code == 2:
                    if seqs[1] >= len(inputs):
                        raise GuestError("guest read past end of input")
                    v = inputs[seqs[1]] & M32
                    reads.append(v)
                    io.append((TAG_READ, seqs[1], v & 0xFFFF, v >> 16))
                    seqs[1] += 1
                    regs[10] = v
                elif code != 3:
                    raise GuestError(f"ecall {code} is outside the reference")
            elif op != 0b0001111:  # FENCE is a no-op
                raise GuestError(f"illegal instruction {word:#010x} at "
                                 f"{pc:#x}")
            if val is not None and rd:
                regs[rd] = val
            pc = nxt
            cycles += 1
        total += cycles
        if total > max_cycles:
            raise GuestError("cycle limit exceeded")
        segments.append(SegmentRun(
            pre_pc=pre[0], post_pc=pc, pre_regs=pre[1], post_regs=list(regs),
            pre_seqs=pre[2], post_seqs=list(seqs), io=io,
            halted=exit_code is not None, cycles=cycles, pre_mem=touched,
            post_mem={k: mem.get(k, 0) for k in touched},
            page_words={a: touched.get(a, mem.get(a, 0))
                        for pg in {w // PAGE_WORDS for w in touched}
                        for a in range(pg * PAGE_WORDS,
                                       (pg + 1) * PAGE_WORDS)}))
    return Run(cycles=total, journal=journal, exit_code=exit_code,
               inputs_read=reads, segments=segments, final_pc=pc,
               final_regs=list(regs), memory=mem)
