"""Two-pass RV32IM mini-assembler.

The build image has no RISC-V toolchain, so guest programs (the analogues of
the reference's `crates/guest/util` echo/identity/loop guests and
`prover/crates/sample-guest`) are written in assembly and assembled here.

Supports: labels, all RV32IM instructions from isa.py, pseudo-ops
(li, mv, j, ret, call, nop, beqz, bnez), `.word`, `.ascii`, `.align`.

The port's own copy of `boundless_tpu/zkvm/asm.py`.
"""

from __future__ import annotations

from . import isa


class AsmError(Exception):
    pass


def _reg(tok: str) -> int:
    tok = tok.strip().rstrip(",")
    if tok not in isa.REG_NAMES:
        raise AsmError(f"unknown register {tok!r}")
    return isa.REG_NAMES[tok]


def _imm(tok: str, labels, pc) -> int:
    tok = tok.strip().rstrip(",")
    if tok in labels:
        return labels[tok]
    try:
        return int(tok, 0)
    except ValueError as e:
        raise AsmError(f"bad immediate {tok!r}") from e


def _parse_mem(tok: str):
    """"imm(reg)" -> (imm, reg)."""
    tok = tok.strip()
    i = tok.index("(")
    off = tok[:i] or "0"
    reg = tok[i + 1 : tok.index(")")]
    return off, _reg(reg)


def assemble(source: str, base: int = 0x1000):
    """Assemble to a list of 32-bit words starting at `base`."""
    lines = []
    for raw in source.splitlines():
        line = raw.split("#")[0].strip()
        if line:
            lines.append(line)

    # Pass 1: measure sizes, collect labels.
    labels = {}
    pc = base

    def size_of(line: str) -> int:
        if line.endswith(":"):
            return 0
        parts = line.split(None, 1)
        mnem = parts[0]
        rest = parts[1] if len(parts) > 1 else ""
        if mnem == ".word":
            return 4 * len(rest.split(","))
        if mnem == ".ascii":
            s = rest.strip().strip('"').encode().decode("unicode_escape")
            return (len(s) + 3) // 4 * 4
        if mnem == ".align":
            return 0  # handled in pass 2 via padding words (assume aligned)
        if mnem == "li":
            return 8  # worst case lui+addi; keep fixed for simplicity
        if mnem == "call":
            return 8
        return 4

    for line in lines:
        if line.endswith(":"):
            labels[line[:-1]] = pc
        else:
            pc += size_of(line)

    # Pass 2: encode.
    words = []
    pc = base

    def emit(w):
        nonlocal pc
        words.append(w & 0xFFFFFFFF)
        pc += 4

    for line in lines:
        if line.endswith(":"):
            continue
        parts = line.split(None, 1)
        mnem = parts[0]
        args = [a.strip() for a in parts[1].split(",")] if len(parts) > 1 else []
        if mnem == ".word":
            for a in args:
                emit(int(a, 0))
        elif mnem == ".ascii":
            s = parts[1].strip().strip('"').encode().decode("unicode_escape").encode()
            for i in range(0, len(s), 4):
                emit(int.from_bytes(s[i : i + 4].ljust(4, b"\0"), "little"))
        elif mnem == "nop":
            emit(isa.enc_i(isa.OP_IMM, 0, 0, 0, 0))
        elif mnem == "li":
            rd = _reg(args[0])
            v = _imm(args[1], labels, pc) & 0xFFFFFFFF
            lo = isa.sign_extend(v, 12)
            hi = (v - lo) & 0xFFFFFFFF
            emit(isa.enc_u(isa.OP_LUI, rd, hi))
            emit(isa.enc_i(isa.OP_IMM, rd, 0, rd, lo))
        elif mnem == "mv":
            emit(isa.enc_i(isa.OP_IMM, _reg(args[0]), 0, _reg(args[1]), 0))
        elif mnem == "j":
            emit(isa.enc_j(isa.OP_JAL, 0, _imm(args[0], labels, pc) - pc))
        elif mnem == "jal" and len(args) == 1:
            emit(isa.enc_j(isa.OP_JAL, 1, _imm(args[0], labels, pc) - pc))
        elif mnem == "jal":
            emit(isa.enc_j(isa.OP_JAL, _reg(args[0]),
                           _imm(args[1], labels, pc) - pc))
        elif mnem == "call":
            target = _imm(args[0], labels, pc)
            off = target - pc
            lo = isa.sign_extend(off & 0xFFF, 12)
            hi = (off - lo) & 0xFFFFFFFF
            emit(isa.enc_u(isa.OP_AUIPC, 6, hi))
            emit(isa.enc_i(isa.OP_JALR, 1, 0, 6, lo))
        elif mnem == "ret":
            emit(isa.enc_i(isa.OP_JALR, 0, 0, 1, 0))
        elif mnem == "jalr":
            if len(args) == 1:
                emit(isa.enc_i(isa.OP_JALR, 1, 0, _reg(args[0]), 0))
            else:
                off, rs = _parse_mem(args[1])
                emit(isa.enc_i(isa.OP_JALR, _reg(args[0]), 0, rs,
                               _imm(off, labels, pc)))
        elif mnem in ("beqz", "bnez"):
            f3 = isa.BRANCH_OPS["beq" if mnem == "beqz" else "bne"]
            off = _imm(args[1], labels, pc) - pc
            if not -4096 <= off < 4096:
                raise AsmError(f"branch target out of range ({off}) in "
                               f"{line!r} — use a local `j` trampoline")
            emit(isa.enc_b(isa.OP_BRANCH, f3, _reg(args[0]), 0, off))
        elif mnem in isa.BRANCH_OPS:
            off = _imm(args[2], labels, pc) - pc
            if not -4096 <= off < 4096:
                raise AsmError(f"branch target out of range ({off}) in "
                               f"{line!r} — use a local `j` trampoline")
            emit(isa.enc_b(isa.OP_BRANCH, isa.BRANCH_OPS[mnem], _reg(args[0]),
                           _reg(args[1]), off))
        elif mnem in isa.R_OPS:
            f3, f7 = isa.R_OPS[mnem]
            emit(isa.enc_r(isa.OP_REG, _reg(args[0]), f3, _reg(args[1]),
                           _reg(args[2]), f7))
        elif mnem in isa.I_OPS:
            emit(isa.enc_i(isa.OP_IMM, _reg(args[0]), isa.I_OPS[mnem],
                           _reg(args[1]), _imm(args[2], labels, pc)))
        elif mnem in isa.SHIFT_I_OPS:
            f3, f7 = isa.SHIFT_I_OPS[mnem]
            sh = _imm(args[2], labels, pc) & 0x1F
            emit(isa.enc_i(isa.OP_IMM, _reg(args[0]), f3, _reg(args[1]),
                           (f7 << 5) | sh))
        elif mnem in isa.LOAD_OPS:
            off, rs = _parse_mem(args[1])
            emit(isa.enc_i(isa.OP_LOAD, _reg(args[0]), isa.LOAD_OPS[mnem], rs,
                           _imm(off, labels, pc)))
        elif mnem in isa.STORE_OPS:
            off, rs = _parse_mem(args[1])
            emit(isa.enc_s(isa.OP_STORE, isa.STORE_OPS[mnem], rs,
                           _reg(args[0]), _imm(off, labels, pc)))
        elif mnem == "lui":
            emit(isa.enc_u(isa.OP_LUI, _reg(args[0]),
                           _imm(args[1], labels, pc) << 12))
        elif mnem == "auipc":
            emit(isa.enc_u(isa.OP_AUIPC, _reg(args[0]),
                           _imm(args[1], labels, pc) << 12))
        elif mnem == "ecall":
            emit(isa.enc_i(isa.OP_SYSTEM, 0, 0, 0, 0))
        else:
            raise AsmError(f"unknown mnemonic {mnem!r} in line {line!r}")
    return words, labels
