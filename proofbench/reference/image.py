"""A program's image table (the rv32im ctrl trace), whose committed LDE
root is the program's image id.

Frozen copy of `decode_row` and `build_ctrl_trace` of
`boundless_tpu_torch/zkvm/witness.py`.
"""

from __future__ import annotations

import numpy as np

from . import field as F
from . import isa
from . import rv32im
from .rv32im import CC

M32 = 0xFFFFFFFF


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


def build_ctrl_trace(words: dict, po2: int) -> np.ndarray:
    """Ctrl-group trace (canonical int64): selectors + decoded image table.

    Its Merkle-committed LDE root is the program's image id for proofs.
    """
    n = 1 << po2
    zk = rv32im.zk_rows(po2)
    rows = sorted(words.items())
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
