"""Witness generation: executor segment -> rv32im AIR traces (numpy).

The JAX package's witness generator (`boundless_tpu/zkvm/witness.py`),
wired to the port's column layout (`air/rv32im.py`, identical to the
reference's): a Python replay (`trace_segment`) and the C++ cycle loop of
the port's copy of `native/witness_gen.cpp` (`trace_segment_native`), sharing
one vectorized tail. All values are canonical int64; `to_public_values`
lifts the claim to Montgomery tensors.

The blinded zk tail rows come from an explicit numpy Generator; without
one, `zk_rng()` seeds it from BT_ZK_SEED like the reference, so a given
seed gives the reference's rows.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from ..air import rv32im
from ..air.rv32im import (DC, DC_I, CC, TAG, IO_MAX, CP_IO, KEC_WORDS,
                          MEM_PAGES, PAGE_WORDS, MEM_PAGE_ELEMS, PublicValues)
from ..core import field as F
from . import isa
from .executor import Segment, MemoryImage, GuestFault, M32


def zk_rng() -> np.random.Generator:
    """The blinding RNG: seeded by BT_ZK_SEED when set, else fresh."""
    seed = os.environ.get("BT_ZK_SEED")
    return np.random.default_rng(int(seed) if seed is not None else None)


def _signed(v):
    return v - (1 << 32) if v & 0x80000000 else v


def decode_row(addr: int, word: int):
    """One decoded image-table row: [t_pc, word_lo, word_hi, sel10, f3sel8,
    alt, imm_lo, imm_hi, imm_field, rd, rs1, rs2, mext]."""
    d = isa.decode(word)
    op = d["op"]
    sel = [0] * 10
    f3v = d["f3"]
    alt = 0
    mext = 0
    imm_lo = imm_hi = imm_field = 0
    rd, rs1, rs2 = d["rd"], d["rs1"], d["rs2"]
    if op == isa.OP_LUI:
        sel[0] = 1
        imm_lo, imm_hi = d["imm_u"] & 0xFFFF, d["imm_u"] >> 16
        rs1 = rs2 = 0
    elif op == isa.OP_AUIPC:
        sel[1] = 1
        imm_lo, imm_hi = d["imm_u"] & 0xFFFF, d["imm_u"] >> 16
        rs1 = rs2 = 0
    elif op == isa.OP_JAL:
        sel[2] = 1
        imm_field = d["imm_j"] % F.P
        rs1 = rs2 = 0
    elif op == isa.OP_JALR:
        sel[3] = 1
        imm32 = d["imm_i"] & M32
        imm_lo, imm_hi = imm32 & 0xFFFF, imm32 >> 16
        rs2 = 0
    elif op == isa.OP_BRANCH:
        sel[4] = 1
        imm_field = d["imm_b"] % F.P
        rd = 0
    elif op == isa.OP_LOAD:
        sel[5] = 1
        imm32 = d["imm_i"] & M32
        imm_lo, imm_hi = imm32 & 0xFFFF, imm32 >> 16
        rs2 = 0
    elif op == isa.OP_STORE:
        sel[6] = 1
        imm32 = d["imm_s"] & M32
        imm_lo, imm_hi = imm32 & 0xFFFF, imm32 >> 16
        rd = 0
    elif op == isa.OP_IMM:
        sel[7] = 1
        if f3v in (1, 5):  # shifts: imm = shamt only; alt from bit 30
            imm_lo = (d["imm_i"] & 0x1F)
            alt = (word >> 30) & 1
        else:
            imm32 = d["imm_i"] & M32
            imm_lo, imm_hi = imm32 & 0xFFFF, imm32 >> 16
        rs2 = 0
    elif op == isa.OP_REG:
        sel[8] = 1
        alt = (word >> 30) & 1
        mext = (word >> 25) & 1
    elif op == isa.OP_SYSTEM:
        sel[9] = 1
        rd = rs1 = rs2 = 0
        f3v = 0
    else:
        # data word / unsupported op: inert row (fetching it is unprovable
        # because every sel is 0, violating sum(sel) == active).
        sel = [0] * 10
        rd = rs1 = rs2 = 0
        f3v = 0
    f3sel = [0] * 8
    f3sel[f3v] = 1
    if not any(sel):
        f3sel = [0] * 8
    return ([addr, word & 0xFFFF, word >> 16] + sel + f3sel
            + [alt, imm_lo, imm_hi, imm_field, rd, rs1, rs2, mext])


def build_ctrl_trace(image: MemoryImage, po2: int) -> np.ndarray:
    """Ctrl-group trace (canonical int64): selectors + decoded image table.

    Its Merkle-committed LDE root is the program's image id for proofs.
    """
    n = 1 << po2
    zk = rv32im.zk_rows(po2)
    rows = sorted(image.words.items())
    # The decoded table must live in the REAL region: a table entry on a
    # blinded zk row could never be fetched (its multiplicity column is
    # free there and the LogUp running sum only binds real rows).
    assert len(rows) <= n - zk, "program larger than real segment rows"
    ctrl = np.zeros((n, CC.total), dtype=np.int64)
    ctrl[0, CC.is_first] = 1
    # trans gate: transitions between real rows only (blinding region =
    # last zk rows); boundary claims bind at the last real row.
    ctrl[: n - zk - 1, CC.not_last] = 1
    ctrl[n - zk - 1, CC.is_last] = 1
    ctrl[:, CC.clk] = np.arange(n)
    for i, (addr, word) in enumerate(rows):
        row = decode_row(addr, word)
        ctrl[i, CC.t_active] = 1
        ctrl[i, CC.t_pc] = row[0]
        ctrl[i, CC.t_word.start : CC.t_word.stop] = row[1:3]
        ctrl[i, CC.t_sel.start : CC.t_sel.stop] = row[3:13]
        ctrl[i, CC.t_f3.start : CC.t_f3.stop] = row[13:21]
        ctrl[i, CC.t_alt] = row[21]
        ctrl[i, CC.t_imm_lo] = row[22]
        ctrl[i, CC.t_imm_hi] = row[23]
        ctrl[i, CC.t_imm_field] = row[24]
        ctrl[i, CC.t_rd] = row[25]
        ctrl[i, CC.t_rs1] = row[26]
        ctrl[i, CC.t_rs2] = row[27]
        ctrl[i, CC.t_mext] = row[28]
    return ctrl


@dataclasses.dataclass
class SegmentWitness:
    data: np.ndarray  # (N, DC.total) canonical int64
    ctrl: np.ndarray  # (N, CC.total)
    pub: dict  # canonical int64 arrays matching PublicValues fields


def _bits(v, n=32):
    return [(v >> i) & 1 for i in range(n)]


# kec_linv witness table: inverse of (j - 49) mod P for burst rows j<49
# (the iszero gadget forcing kec_last == (kec_cnt == 49)).
_KEC_LINV = [pow((j - (KEC_WORDS - 1)) % F.P, F.P - 2, F.P)
             for j in range(KEC_WORDS - 1)] + [0]


def data_for_variant(data, variant: str):
    """Full-layout (N, 584) witness -> the variant's committed columns.

    The RV32I layout is a strict prefix of the RV32IM layout (air DC /
    DC_I), so the conversion is a plain truncation."""
    if variant == "rv32im":
        return data
    return data[:, : DC_I.total]


def trace_segment(image: MemoryImage, seg: Segment, po2: int,
                  rng: Optional[np.random.Generator] = None) -> SegmentWitness:
    """Replay one segment and fill the full witness.

    seg.reads: word list consumed by READ ecalls during this segment.
    rng: source of the blinded zk rows (default: `zk_rng()`).
    Raises GuestFault on executions outside the v1 provable subset.
    """
    n = 1 << po2
    assert seg.cycles <= n - 1
    data = np.zeros((n, DC.total), dtype=np.int64)
    ctrl = build_ctrl_trace(image, po2)
    addr_to_trow = {a: i for i, (a, _) in
                    enumerate(sorted(image.words.items()))}

    regs = seg.pre_regs.astype(np.int64).copy()
    mem = dict(seg.pre_mem)
    pc = seg.pre_pc
    reads = list(seg.reads)
    # session-wide sequence numbers resume from the claim
    seqs = dict(seg.pre_seqs)
    seqs.setdefault("cpio", 0)
    pre_seqs = [seqs["commit"], seqs["read"], seqs["verify"], seqs["cpio"]]
    pre_regs_limbs = _reg_limbs(regs)
    pre_pc = pc

    mem_ops = []  # (clk, word_addr, is_write, value)
    io_rows = []  # (tag, seq, lo, hi); tag 8 rows land in pub.cpio
    halted = False

    clk = 0
    while clk < seg.cycles:
        row = data[clk]
        row[DC.pc] = pc
        row[DC.regs.start : DC.regs.stop] = _reg_limbs(regs)
        row[DC.active] = 1
        row[DC.halted] = 1 if halted else 0
        row[DC.commit_seq] = seqs["commit"]
        row[DC.read_seq] = seqs["read"]
        row[DC.verify_seq] = seqs["verify"]
        row[DC.cp_seq] = seqs["cpio"]
        if halted:
            raise GuestFault("cycle after halt")

        word = mem.get(pc & ~3)
        if word is None:
            raise GuestFault(f"fetch from unmapped pc {pc:#x}")
        if (pc & ~3) not in image.words or mem[pc & ~3] != image.words[pc & ~3]:
            raise GuestFault("self-modifying code is not provable")
        trow = decode_row(pc, word)
        sel = trow[3:13]
        f3sel = trow[13:21]
        alt = trow[21]
        imm_lo, imm_hi, imm_field = trow[22], trow[23], trow[24]
        rd, rs1, rs2 = trow[25], trow[26], trow[27]
        mext = trow[28]
        if not any(sel):
            raise GuestFault(f"unprovable instruction {word:#010x} at {pc:#x}")
        f3 = f3sel.index(1)

        row[DC.sel.start : DC.sel.stop] = sel
        row[DC.f3.start : DC.f3.stop] = f3sel
        row[DC.alt] = alt
        row[DC.imm_lo], row[DC.imm_hi], row[DC.imm_field] = imm_lo, imm_hi, imm_field
        row[DC.rd_oh.start + rd] = 1
        row[DC.rs1_oh.start + rs1] = 1
        row[DC.rs2_oh.start + rs2] = 1

        rs1v = int(regs[rs1]) & M32
        rs2v = int(regs[rs2]) & M32
        imm32 = (imm_lo | (imm_hi << 16)) & M32
        use_imm = sel[7] or sel[5] or sel[6] or sel[3]
        op2 = imm32 if use_imm else rs2v
        row[DC.rs1v.start], row[DC.rs1v.start + 1] = rs1v & 0xFFFF, rs1v >> 16
        row[DC.rs2v.start], row[DC.rs2v.start + 1] = rs2v & 0xFFFF, rs2v >> 16
        row[DC.op2.start], row[DC.op2.start + 1] = op2 & 0xFFFF, op2 >> 16

        is_m = bool(sel[8] and mext)
        is_mdiv = is_m and f3 >= 4  # any div/rem: a_bits carry q
        row[DC.is_m] = 1 if is_m else 0
        is_alu = sel[7] or sel[8]
        row[DC.is_shift_col] = 1 if (is_alu and not is_m
                                     and f3 in (1, 5)) else 0
        row[DC.is_slt_col] = 1 if (is_alu and not is_m
                                   and f3 in (2, 3)) else 0
        row[DC.is_logic_col] = 1 if (is_alu and not is_m
                                     and f3 in (4, 6, 7)) else 0
        bind_ab = is_alu or sel[4]
        if bind_ab and not is_mdiv:
            row[DC.a_bits.start : DC.a_bits.stop] = _bits(rs1v)
        if bind_ab:
            row[DC.b_bits.start : DC.b_bits.stop] = _bits(op2)

        rdv = 0
        next_pc = (pc + 4) & M32
        r32 = None  # value whose bits land in r_bits
        c0 = c1 = 0
        sh_set = False

        def addm():
            nonlocal r32, c0, c1
            s = rs1v + op2
            r32 = s & M32
            c0 = 1 if (rs1v & 0xFFFF) + (op2 & 0xFFFF) >= (1 << 16) else 0
            c1 = 1 if s >= (1 << 32) else 0

        def subm():
            nonlocal r32, c0, c1
            s = rs1v - op2
            r32 = s & M32
            # b + r = a + c*2^32 limbwise
            c0 = 1 if (op2 & 0xFFFF) + (r32 & 0xFFFF) >= (1 << 16) else 0
            c1 = 1 if op2 + r32 >= (1 << 32) else 0

        if sel[0]:  # LUI
            rdv = imm32
        elif sel[1]:  # AUIPC: rd = (pc + imm_u) mod 2^32
            rdv = (pc + imm32) & M32
            r32 = pc  # r_bits carry the pc limb decomposition
            row[DC.a_bits.start : DC.a_bits.stop] = _bits(rdv)
            c0 = 1 if (pc & 0xFFFF) + imm_lo >= (1 << 16) else 0
            c1 = 1 if pc + imm32 >= (1 << 32) else 0
        elif sel[2]:  # JAL
            r32 = (pc + 4) & M32
            rdv = r32
            next_pc = (pc + isa.sign_extend(
                int(_unmod(imm_field)), 32)) & M32
        elif sel[3]:  # JALR
            addm()
            target = r32
            if target & 3 or target >= (1 << 26):
                raise GuestFault("jalr target unaligned or out of range")
            next_pc = target
            rdv = (pc + 4) & M32
            row[DC.b_bits.start : DC.b_bits.stop] = _bits(rdv)
        elif sel[4]:  # BRANCH
            subm()
            lt_u = c1
            a31, b31 = (rs1v >> 31) & 1, (op2 >> 31) & 1
            lt_s = lt_u ^ a31 ^ b31
            z = (r32 & 0xFFFF) + (r32 >> 16)
            eqf = 1 if z == 0 else 0
            row[DC.eq] = eqf
            row[DC.z_inv] = pow(z % F.P, F.P - 2, F.P) if z else 0
            taken = {0: eqf, 1: 1 - eqf, 4: lt_s, 5: 1 - lt_s,
                     6: lt_u, 7: 1 - lt_u}[f3]
            row[DC.taken] = taken
            if taken:
                next_pc = (pc + isa.sign_extend(
                    int(_unmod(imm_field)), 32)) & M32
        elif sel[5] or sel[6]:  # LOAD / STORE (word and sub-word)
            addm()
            addr = r32
            size = {0: 1, 1: 2, 2: 4, 4: 1, 5: 2}.get(f3)
            if size is None or (sel[6] and f3 not in (0, 1, 2)):
                raise GuestFault("bad load/store width")
            if addr % size or addr >= (1 << 26):
                raise GuestFault("memory access unaligned or out of range")
            off = addr & 3
            base = addr & ~3
            waddr = base >> 2
            # sh_oh doubles as the byte-offset one-hot (AIR binds it to
            # the low address bits); mem-op times are 2*clk + phase so a
            # sub-word store's old-word read precedes its write.
            row[DC.sh_oh.start + off] = 1
            sh_set = True
            if sel[5]:
                w = mem.get(base, None)
                if w is None:
                    raise GuestFault(
                        "uninitialized read (first access must be a write "
                        "or an image word)")
                row[DC.b_bits.start : DC.b_bits.stop] = _bits(w)
                if f3 == 2:
                    rdv = w
                elif f3 in (0, 4):
                    bv = (w >> (8 * off)) & 0xFF
                    rdv = bv if f3 == 4 or not bv & 0x80 else (
                        bv | 0xFFFFFF00)
                else:  # 1 / 5: lh / lhu
                    hv = (w >> (8 * off)) & 0xFFFF
                    rdv = hv if f3 == 5 or not hv & 0x8000 else (
                        hv | 0xFFFF0000)
                mem_ops.append((2 * clk, waddr, 0, w))
            else:
                if f3 == 2:
                    merged = rs2v
                else:
                    # missing words read as zero (defined semantics;
                    # the paging-port publics bind the pre value)
                    old = mem.get(base, 0)
                    row[DC.b_bits.start : DC.b_bits.stop] = _bits(old)
                    if f3 == 0:
                        mask = 0xFF << (8 * off)
                        merged = (old & ~mask) | ((rs2v & 0xFF) << (8 * off))
                        row[DC.q8.start : DC.q8.stop] = \
                            _bits((rs2v >> 8) & 0xFF, 8)
                    else:
                        mask = 0xFFFF << (8 * off)
                        merged = (old & ~mask) | (
                            (rs2v & 0xFFFF) << (8 * off))
                    mem_ops.append((2 * clk, waddr, 0, old))
                mem[base] = merged
                row[DC.a_bits.start : DC.a_bits.stop] = _bits(merged)
                mem_ops.append((2 * clk + 1, waddr, 1, merged))
        elif is_m:  # M extension (all 8 ops in-circuit)
            a31m, b31m = (rs1v >> 31) & 1, (op2 >> 31) & 1
            is_div = f3 >= 4
            if is_div:
                if f3 in (5, 7):  # DIVU / REMU
                    if op2 != 0:
                        q, r = rs1v // op2, rs1v % op2
                    else:
                        q, r = 0, rs1v  # q free when b=0; witness picks 0
                else:  # DIV / REM (signed, truncating)
                    sa, sb = _signed(rs1v), _signed(op2)
                    if sb == 0:
                        q, r = M32, rs1v  # q = -1, r = a
                    elif sa == -(1 << 31) and sb == -1:
                        q, r = 0x80000000, 0  # overflow
                    else:
                        qs = abs(sa) // abs(sb)
                        if (sa < 0) != (sb < 0):
                            qs = -qs
                        q, r = qs & M32, (sa - qs * sb) & M32
                mul_a = q
                row[DC.a_bits.start : DC.a_bits.stop] = _bits(q)
            else:
                q = r = 0
                mul_a = rs1v
                row[DC.a_bits.start : DC.a_bits.stop] = _bits(rs1v)
            prod = mul_a * op2
            lo, hi = prod & M32, prod >> 32
            r32 = lo
            row[DC.m_hi_bits.start : DC.m_hi_bits.stop] = _bits(hi)
            # byte-product carry chain
            ab = [(mul_a >> (8 * i)) & 0xFF for i in range(4)]
            bb = [(op2 >> (8 * i)) & 0xFF for i in range(4)]
            rbytes = [(prod >> (8 * k)) & 0xFF for k in range(8)]
            carry = 0
            for k in range(7):
                ck = sum(ab[i] * bb[k - i]
                         for i in range(max(0, k - 3), min(4, k + 1)))
                t = ck + carry
                assert t & 0xFF == rbytes[k]
                carry = t >> 8
                assert carry < (1 << 11)
                row[DC.m_carry_bits.start + 11 * k :
                    DC.m_carry_bits.start + 11 * (k + 1)] = _bits(carry, 11)
            assert carry == rbytes[7]
            if is_div:
                row[DC.m_rem_bits.start : DC.m_rem_bits.stop] = _bits(r)
                bzero = 1 if op2 == 0 else 0
                row[DC.m_bzero] = bzero
                s = (op2 & 0xFFFF) + (op2 >> 16)
                row[DC.m_binv] = pow(s % F.P, F.P - 2, F.P) if s else 0
                # qb + r = a carry, limb 0 (shared by both families)
                k0 = ((lo & 0xFFFF) + (r & 0xFFFF)) >> 16
                row[DC.m_ca0] = k0
                if f3 in (5, 7):
                    if not bzero:
                        d = op2 - 1 - r
                        row[DC.m_d_bits.start : DC.m_d_bits.stop] = _bits(d)
                        row[DC.m_cb] = 1 if ((r & 0xFFFF) + (d & 0xFFFF) + 1
                                             ) >> 16 else 0
                    rdv = (M32 if bzero else q) if f3 == 5 else r
                else:  # DIV / REM signed bookkeeping
                    # sh_oh holds the dividend's bit decomposition
                    row[DC.sh_oh.start : DC.sh_oh.stop] = _bits(rs1v)
                    sh_set = True
                    k1 = ((lo >> 16) + (r >> 16) + k0 - (rs1v >> 16)) >> 16
                    row[DC.m_ca1] = k1
                    rho = (r >> 31) & 1
                    o = 1 if (rs1v == 0x80000000
                              and op2 == 0xFFFFFFFF) else 0
                    row[DC.m_s_bits.start + 2] = o
                    row[DC.m_g] = 1 - o
                    row[DC.m_g2] = 1 - bzero
                    if not o:
                        # high-word identity: H + alpha + k1 + 2^32 =
                        # rho + q31*b + b31*q + 2^32*e, limbed via s0
                        q31 = (q >> 31) & 1
                        U = q31 * (op2 & 0xFFFF) + b31m * (q & 0xFFFF)
                        V = q31 * (op2 >> 16) + b31m * (q >> 16)
                        num0 = ((hi & 0xFFFF) + a31m + k1
                                + (1 << 17) - rho - U)
                        assert num0 % (1 << 16) == 0
                        s0 = num0 >> 16
                        assert 0 <= s0 <= 3
                        c0, c1 = s0 & 1, s0 >> 1
                        e = ((hi >> 16) + s0 + (1 << 16) - V - 2) >> 16
                        assert 0 <= e <= 2
                        row[DC.m_s_bits.start] = e & 1
                        row[DC.m_s_bits.start + 1] = e >> 1
                    if not bzero:
                        # |r| < |b| comparison, by sign case (rho, b31)
                        if rho == 0 and b31m == 0:
                            dd = op2 - 1 - r
                            cA = ((r & 0xFFFF) + 1 + (dd & 0xFFFF)) >> 16
                            cB = 0
                        elif rho == 0 and b31m == 1:
                            dd = (1 << 32) - 1 - r - op2
                            cA = (((r & 0xFFFF) + (op2 & 0xFFFF) + 1
                                   + (dd & 0xFFFF)) >> 16) - 1
                            cB = 0
                        elif rho == 1 and b31m == 0:
                            dd = r + op2 - (1 << 32) - 1
                            g0 = ((r & 0xFFFF) + (op2 & 0xFFFF)
                                  + (1 << 16) - 1 - (dd & 0xFFFF)) >> 16
                            cA, cB = g0 & 1, g0 >> 1
                        else:
                            dd = r - 1 - op2
                            cA = ((op2 & 0xFFFF) + 1
                                  + (dd & 0xFFFF)) >> 16
                            cB = 0
                        assert 0 <= dd < (1 << 32)
                        row[DC.m_d_bits.start : DC.m_d_bits.stop] = \
                            _bits(dd)
                        row[DC.m_s_bits.start + 3] = cA
                        row[DC.m_s_bits.start + 4] = cB
                    rdv = q if f3 == 4 else r
            elif f3 in (0, 3):
                rdv = lo if f3 == 0 else hi
            else:  # MULH (1) / MULHSU (2): signed high word
                use_b = 1 if f3 == 1 else 0  # MULHSU: b unsigned
                corr = a31m * op2 + use_b * b31m * rs1v
                res = (hi - corr) & M32
                row[DC.m_rem_bits.start : DC.m_rem_bits.stop] = _bits(res)
                corr_lo = (a31m * (op2 & 0xFFFF)
                           + use_b * b31m * (rs1v & 0xFFFF))
                t0 = (corr_lo + (res & 0xFFFF) - (hi & 0xFFFF)) >> 16
                corr_hi = (a31m * (op2 >> 16)
                           + use_b * b31m * (rs1v >> 16))
                t1 = (corr_hi + (res >> 16) + t0 - (hi >> 16)) >> 16
                if f3 == 1:
                    assert 0 <= t0 <= 2 and 0 <= t1 <= 2
                    row[DC.m_ca0] = 1 if t0 >= 1 else 0
                    row[DC.m_cb] = 1 if t0 >= 2 else 0
                    c0 = 1 if t1 >= 1 else 0
                    c1 = 1 if t1 >= 2 else 0
                else:
                    assert 0 <= t0 <= 1 and 0 <= t1 <= 1
                    row[DC.m_ca0] = t0
                    c0 = t1
                rdv = res
        elif sel[7] or sel[8]:  # ALU
            if f3 == 0:
                if alt:
                    subm()
                else:
                    addm()
                rdv = r32
            elif f3 in (2, 3):
                subm()
                lt_u = c1
                a31, b31 = (rs1v >> 31) & 1, (op2 >> 31) & 1
                lt_s = lt_u ^ a31 ^ b31
                rdv = lt_s if f3 == 2 else lt_u
            elif f3 == 1:
                sh = op2 & 0x1F
                r32 = (rs1v << sh) & M32
                rdv = r32
                row[DC.sh_oh.start + sh] = 1
                sh_set = True
            elif f3 == 5:
                sh = op2 & 0x1F
                r32 = ((_signed(rs1v) >> sh) & M32) if alt else (rs1v >> sh)
                rdv = r32
                row[DC.sh_oh.start + sh] = 1
                sh_set = True
            else:  # logic
                r32 = {4: rs1v ^ op2, 6: rs1v | op2, 7: rs1v & op2}[f3]
                rdv = r32
        elif sel[9]:  # ECALL
            t0 = int(regs[5]) & M32
            if t0 > 5:
                raise GuestFault(f"unknown ecall {t0}")
            if t0 < 5:
                row[DC.k.start + t0] = 1
            a0 = int(regs[10]) & M32
            if t0 == 5:  # KECCAK coprocessor: 50-row burst. Row j reads
                # in-state word j (b_bits, mem2 port phase 0), writes
                # out-state word j (a_bits, mem port phase 1) at word
                # addr a0/4 + j, and publishes both words as cpio
                # entries — the in-circuit ecall ABI (air/rv32im.py).
                from .executor import keccak_f1600

                if a0 & 3 or a0 >= (1 << 26):
                    raise GuestFault("keccak state unaligned/out of range")
                in_words = []
                for i in range(KEC_WORDS):
                    w = mem.get(a0 + 4 * i)
                    if w is None:
                        raise GuestFault(
                            "uninitialized read (first access must be a "
                            "write or an image word)")
                    in_words.append(w)
                lanes = [in_words[2 * i] | (in_words[2 * i + 1] << 32)
                         for i in range(25)]
                out = keccak_f1600(lanes)
                out_words = []
                for v in out:
                    out_words += [v & M32, (v >> 32) & M32]
                a0_bits = _bits(a0)
                cp0 = seqs["cpio"]
                w0 = a0 >> 2
                for j in range(KEC_WORDS):
                    rj = data[clk + j]
                    if j:
                        rj[:] = data[clk]
                        rj[DC.cp_seq] = cp0 + 2 * j
                    rj[DC.k_kec] = 1
                    rj[DC.kec_cnt] = j
                    rj[DC.kec_last] = 1 if j == KEC_WORDS - 1 else 0
                    rj[DC.kec_linv] = _KEC_LINV[j]
                    rj[DC.r_bits.start : DC.r_bits.stop] = a0_bits
                    rj[DC.b_bits.start : DC.b_bits.stop] = \
                        _bits(in_words[j])
                    rj[DC.a_bits.start : DC.a_bits.stop] = \
                        _bits(out_words[j])
                    rj[DC.sh_oh.start] = 1
                    ck = clk + j
                    mem_ops.append((2 * ck, w0 + j, 0, in_words[j]))
                    mem_ops.append((2 * ck + 1, w0 + j, 1, out_words[j]))
                    io_rows.append((TAG["cpio"], cp0 + 2 * j,
                                    in_words[j] & 0xFFFF,
                                    in_words[j] >> 16))
                    io_rows.append((TAG["cpio"], cp0 + 2 * j + 1,
                                    out_words[j] & 0xFFFF,
                                    out_words[j] >> 16))
                    mem[a0 + 4 * j] = out_words[j]
                seqs["cpio"] = cp0 + 2 * KEC_WORDS
                # ctrl clk column ramps; fetch multiplicity counts all 50
                pc = (pc + 4) & M32
                clk += KEC_WORDS
                continue
            if t0 == 0:  # HALT
                halted = True
            elif t0 == 1:  # COMMIT
                io_rows.append((TAG["commit"], seqs["commit"],
                                a0 & 0xFFFF, a0 >> 16))
                seqs["commit"] += 1
            elif t0 == 2:  # READ
                if not reads:
                    raise GuestFault("segment read log exhausted")
                wv = reads.pop(0)
                rdv = wv
                io_rows.append((TAG["read"], seqs["read"],
                                wv & 0xFFFF, wv >> 16))
                seqs["read"] += 1
                regs[10] = wv
            elif t0 == 4:  # VERIFY
                io_rows.append((TAG["verify"], seqs["verify"],
                                a0 & 0xFFFF, a0 >> 16))
                seqs["verify"] += 1
            # t0 == 3 (LOG): no constrained effect

        if r32 is not None:
            row[DC.r_bits.start : DC.r_bits.stop] = _bits(r32)
        if not sh_set:
            row[DC.sh_oh.start] = 1
        row[DC.c0], row[DC.c1] = c0, c1
        row[DC.rdv.start], row[DC.rdv.start + 1] = rdv & 0xFFFF, rdv >> 16

        # apply register write
        wen = (sel[0] or sel[1] or sel[2] or sel[3] or sel[5] or sel[7]
               or sel[8])
        if wen and rd != 0:
            regs[rd] = rdv
        pc = next_pc
        clk += 1

    return _postprocess(image, seg, n, data, regs, pc, seqs, mem_ops,
                        io_rows, halted, pre_seqs, pre_regs_limbs, pre_pc,
                        addr_to_trow, ctrl, rng)


def _postprocess(image, seg, n, data, regs, pc, seqs, mem_ops, io_rows,
                 halted, pre_seqs, pre_regs_limbs, pre_pc, addr_to_trow,
                 ctrl, rng):
    """Shared tail of witness generation (Python + native cycle loops)."""
    if halted != bool(seg.is_final):
        # non-final segments pause un-halted; final ones must have halted
        raise GuestFault("segment halt state does not match plan")

    # padding rows: frozen state + default one-hots
    pad = data[seg.cycles : n]
    pad[:, DC.pc] = pc
    pad[:, DC.regs.start : DC.regs.stop] = _reg_limbs(regs)
    pad[:, DC.halted] = 1 if halted else 0
    pad[:, DC.commit_seq] = seqs["commit"]
    pad[:, DC.read_seq] = seqs["read"]
    pad[:, DC.verify_seq] = seqs["verify"]
    pad[:, DC.cp_seq] = seqs.get("cpio", 0)
    pad[:, DC.rd_oh.start] = 1
    pad[:, DC.rs1_oh.start] = 1
    pad[:, DC.rs2_oh.start] = 1
    pad[:, DC.sh_oh.start] = 1

    # fetch multiplicities
    for clk in range(seg.cycles):
        t = addr_to_trow[int(data[clk, DC.pc]) & ~3]
        data[t, DC.mult_fetch] += 1

    # committed degree-helper columns (vectorized; shared by the Python
    # and native cycle loops — see air/rv32im.py "shared adder"/"sx")
    a31 = data[:, DC.a_bits.start + 31]
    b31 = data[:, DC.b_bits.start + 31]
    data[:, DC.sx] = a31 ^ b31
    _sel = lambda i: data[:, DC.sel.start + i]
    _f3 = lambda i: data[:, DC.f3.start + i]
    alt_c = data[:, DC.alt]
    alu_nm = (_sel(7) + _sel(8)) * (1 - data[:, DC.is_m])
    data[:, DC.is_addm] = (alu_nm * _f3(0) * (1 - alt_c)
                           + _sel(5) + _sel(6) + _sel(3))
    data[:, DC.is_subm] = (alu_nm * (_f3(0) * alt_c + _f3(2) + _f3(3))
                           + _sel(4))
    data[:, DC.sh_sra] = data[:, DC.is_shift_col] * _f3(5) * alt_c

    # sorted memory log + paging-port columns
    zk = rv32im.zk_rows(n.bit_length() - 1)
    mem_ops.sort(key=lambda t: (t[1], t[0]))
    assert len(mem_ops) <= n - zk, \
        "too many memory ops for the real trace region"
    pre_val = {}  # word addr -> segment-entry value
    final_val = {}  # word addr -> last logged value
    prev_addr = None
    for i, (clk, waddr, is_w, val) in enumerate(mem_ops):
        data[i, DC.s_active] = 1
        data[i, DC.s_is_write] = is_w
        data[i, DC.s_addr] = waddr
        data[i, DC.s_clk] = clk
        data[i, DC.s_val.start] = val & 0xFFFF
        data[i, DC.s_val.start + 1] = val >> 16
        new = 1 if waddr != prev_addr else 0
        data[i, DC.s_new] = new
        if new:
            pv = int(seg.pre_mem.get(waddr << 2, 0))
            pre_val[waddr] = pv
            if not is_w and pv != val:
                raise GuestFault("init read does not match pre-memory")
        data[i, DC.s_pre_val.start] = pre_val[waddr] & 0xFFFF
        data[i, DC.s_pre_val.start + 1] = pre_val[waddr] >> 16
        if i > 0 and data[i - 1, DC.s_active]:
            d = (waddr - int(data[i - 1, DC.s_addr])) if new else (
                clk - int(data[i - 1, DC.s_clk]))
            assert d >= 1
            data[i, DC.s_dbits.start : DC.s_dbits.stop] = _bits(d - 1, 26)
        if i > 0 and data[i, DC.s_new]:
            data[i - 1, DC.s_last] = 1
        final_val[waddr] = val
        prev_addr = waddr
    if mem_ops:
        data[len(mem_ops) - 1, DC.s_last] = 1

    # paging-port public pages (pre/post words of every touched page)
    mem_pub = np.zeros((MEM_PAGES, MEM_PAGE_ELEMS), dtype=np.int64)
    pages = sorted({waddr // PAGE_WORDS for waddr in pre_val})
    assert len(pages) <= MEM_PAGES, "too many touched pages in one segment"
    for e, pg in enumerate(pages):
        mem_pub[e, 0] = pg
        mem_pub[e, 1] = 1
        for w in range(PAGE_WORDS):
            waddr = pg * PAGE_WORDS + w
            base = 2 + 5 * w
            if waddr in pre_val:
                pre = pre_val[waddr]
                post = final_val[waddr]
                mem_pub[e, base] = 1
                mem_pub[e, base + 1] = pre & 0xFFFF
                mem_pub[e, base + 2] = pre >> 16
                mem_pub[e, base + 3] = post & 0xFFFF
                mem_pub[e, base + 4] = post >> 16
            else:
                v = int(seg.pre_mem.get(waddr << 2, 0))
                mem_pub[e, base + 1] = v & 0xFFFF
                mem_pub[e, base + 2] = v >> 16
                mem_pub[e, base + 3] = v & 0xFFFF
                mem_pub[e, base + 4] = v >> 16

    # public values (tag-8 rows are keccak cpio word entries)
    cp_rows = [r for r in io_rows if r[0] == TAG["cpio"]]
    io_rows = [r for r in io_rows if r[0] != TAG["cpio"]]
    io = np.zeros((IO_MAX, 5), dtype=np.int64)
    assert len(io_rows) <= IO_MAX, "too many io words in one segment"
    for i, (tag, seq, lo, hi) in enumerate(io_rows):
        io[i] = [tag, seq, lo, hi, 1]
    cpio = np.zeros((CP_IO, 4), dtype=np.int64)
    assert len(cp_rows) <= CP_IO, "too many keccak words in one segment"
    for i, (_tag, seq, lo, hi) in enumerate(cp_rows):
        cpio[i] = [seq, lo, hi, 1]
    pub = dict(
        pre_pc=np.int64(pre_pc),
        post_pc=np.int64(pc),
        pre_regs=np.asarray(pre_regs_limbs, dtype=np.int64),
        post_regs=np.asarray(_reg_limbs(regs), dtype=np.int64),
        halted=np.int64(1 if halted else 0),
        pre_seqs=np.asarray(pre_seqs, dtype=np.int64),
        post_seqs=np.asarray([seqs["commit"], seqs["read"], seqs["verify"],
                              seqs.get("cpio", 0)], dtype=np.int64),
        io=io,
        cpio=cpio,
        mem=mem_pub,
    )

    # --- ZK blinding: the last zk rows of the data trace are free
    # random field elements (docs/ZK_BLINDING_DESIGN.md). Point-class
    # constraints only bind real rows (prover divides their composition
    # terms by Z_H / P_Z), transition/boundary families are ctrl-gated
    # off this region, and the accum group is recomputed from the
    # randomized data — so every committed column polynomial carries zk
    # rows of entropy and the revealed openings are simulatable.
    if zk:
        rng = zk_rng() if rng is None else rng
        data[n - zk:] = rng.integers(0, F.P, size=(zk, data.shape[1]),
                                     dtype=np.int64)
    return SegmentWitness(data=data, ctrl=ctrl, pub=pub)


def trace_segment_native(image: MemoryImage, seg: Segment, po2: int,
                         rng: Optional[np.random.Generator] = None
                         ) -> SegmentWitness:
    """C++ cycle loop (native/witness_gen.cpp) + shared Python tail.

    Bit-identical to trace_segment (diffed in tests); ~100x faster on the
    per-cycle fill, keeping TPU chips fed at large po2.
    """
    import ctypes

    from .. import native

    lib = native.witness_lib()
    n = 1 << po2
    assert seg.cycles <= n - 1
    data = np.zeros((n, DC.total), dtype=np.int64)
    ctrl = build_ctrl_trace(image, po2)
    addr_to_trow = {a: i for i, (a, _) in
                    enumerate(sorted(image.words.items()))}

    layout = np.array([
        DC.regs.start, DC.pc, DC.sel.start, DC.f3.start, DC.alt, DC.imm_lo,
        DC.imm_hi, DC.imm_field, DC.rd_oh.start, DC.rs1_oh.start,
        DC.rs2_oh.start, DC.rs1v.start, DC.rs2v.start, DC.op2.start,
        DC.rdv.start, DC.a_bits.start, DC.b_bits.start, DC.r_bits.start,
        DC.sh_oh.start, DC.c0, DC.c1, DC.eq, DC.z_inv, DC.taken, DC.k.start,
        DC.commit_seq, DC.read_seq, DC.verify_seq, DC.active, DC.halted,
        DC.is_m, DC.is_shift_col, DC.is_slt_col, DC.is_logic_col,
        DC.m_hi_bits.start,
        DC.q8.start,
        DC.m_carry_bits.start, DC.m_rem_bits.start, DC.m_d_bits.start,
        DC.m_ca0, DC.m_ca1, DC.m_cb, DC.m_bzero, DC.m_binv,
        DC.m_s_bits.start, DC.m_g, DC.m_g2,
        DC.k_kec, DC.kec_cnt, DC.kec_last, DC.kec_linv, DC.cp_seq,
    ], dtype=np.int32)

    img_items = sorted(image.words.items())
    img_addrs = np.array([a for a, _ in img_items], dtype=np.uint32)
    img_words = np.array([w for _, w in img_items], dtype=np.uint32)
    mem_items = sorted(seg.pre_mem.items())
    mem_addrs = np.array([a for a, _ in mem_items], dtype=np.uint32)
    mem_vals = np.array([v for _, v in mem_items], dtype=np.uint32)
    reads = np.array(list(seg.reads), dtype=np.uint32)
    regs = np.ascontiguousarray(seg.pre_regs, dtype=np.uint32).copy()
    seqs_arr = np.array([seg.pre_seqs["commit"], seg.pre_seqs["read"],
                         seg.pre_seqs["verify"],
                         seg.pre_seqs.get("cpio", 0)], dtype=np.uint64)
    pre_seqs = [int(x) for x in seqs_arr]
    pre_regs_limbs = _reg_limbs(regs)
    mem_ops_out = np.zeros((n, 4), dtype=np.int64)
    io_rows_out = np.zeros((n, 4), dtype=np.int64)
    counts = np.zeros(2, dtype=np.int32)
    post_pc = np.zeros(1, dtype=np.uint32)
    err = ctypes.create_string_buffer(256)

    u32p = np.ctypeslib.ndpointer  # noqa: N806 (brevity)
    rc = lib.bt_trace_cycles(
        img_addrs.ctypes.data_as(ctypes.c_void_p),
        img_words.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(len(img_items)),
        ctypes.c_uint32(seg.pre_pc),
        regs.ctypes.data_as(ctypes.c_void_p),
        mem_addrs.ctypes.data_as(ctypes.c_void_p),
        mem_vals.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(len(mem_items)),
        reads.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(len(reads)),
        seqs_arr.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(seg.cycles), ctypes.c_int(n),
        ctypes.c_int(DC.total),
        layout.ctypes.data_as(ctypes.c_void_p),
        data.ctypes.data_as(ctypes.c_void_p),
        mem_ops_out.ctypes.data_as(ctypes.c_void_p),
        io_rows_out.ctypes.data_as(ctypes.c_void_p),
        counts.ctypes.data_as(ctypes.c_void_p),
        post_pc.ctypes.data_as(ctypes.c_void_p),
        err, ctypes.c_int(256))
    if rc != 0:
        raise GuestFault(err.value.decode() or "native witness gen failed")
    halted = bool(err.raw[0])
    mem_ops = [tuple(int(x) for x in row) for row in mem_ops_out[: counts[0]]]
    io_rows = [tuple(int(x) for x in row) for row in io_rows_out[: counts[1]]]
    seqs = dict(commit=int(seqs_arr[0]), read=int(seqs_arr[1]),
                verify=int(seqs_arr[2]), cpio=int(seqs_arr[3]))
    return _postprocess(image, seg, n, data, regs, int(post_pc[0]), seqs,
                        mem_ops, io_rows, halted, pre_seqs, pre_regs_limbs,
                        seg.pre_pc, addr_to_trow, ctrl, rng)


def _reg_limbs(regs):
    out = np.zeros(64, dtype=np.int64)
    for k in range(32):
        v = int(regs[k]) & M32
        out[2 * k] = v & 0xFFFF
        out[2 * k + 1] = v >> 16
    return out


def _unmod(imm_field: int) -> int:
    """Field-encoded signed immediate -> signed python int."""
    return imm_field if imm_field < F.P // 2 else imm_field - F.P


def to_public_values(pub: dict, device="cpu") -> PublicValues:
    """Canonical int dict -> Montgomery PublicValues on `device`."""
    return PublicValues(**{f.name: F.fp(pub[f.name], device)
                           for f in dataclasses.fields(PublicValues)})
