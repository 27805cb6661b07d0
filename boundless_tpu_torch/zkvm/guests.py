"""Built-in guest programs (assembled in-repo).

Counterparts of the reference's test guests (`crates/guest/util`: echo,
identity, loop — reference `echo/src/main.rs:19-26`, `loop/src/main.rs:17-34`,
`identity/src/main.rs:27-37`) and the bento `sample-guest` iteration loads.

I/O ABI is word-granular (see executor.py): READ pops one input word into
a0; COMMIT appends a0 to the journal; VERIFY pushes one assumption-digest
word (8 calls per digest).

The port's own copy of `boundless_tpu/zkvm/guests.py`: the same sources
assemble to the same words, built on the port's `asm` and `MemoryImage`.
"""

from __future__ import annotations

from . import asm
from .executor import MemoryImage

# echo: first input word = payload word count n; journal := the n payload
# words. Pure register machine (no RAM) — provable by the v1 AIR.
ECHO_SRC = """
start:
    li t0, 2
    ecall               # a0 = n
    mv s2, a0
    li s3, 0
loop:
    beq s3, s2, done
    li t0, 2
    ecall               # a0 = next payload word
    li t0, 1
    ecall               # commit it
    addi s3, s3, 1
    j loop
done:
    li t0, 0
    li a0, 0
    ecall
"""

# loop: input word 0 = iteration count; spin; commit the count.
LOOP_SRC = """
start:
    li t0, 2
    ecall               # a0 = iterations
    mv s2, a0
    li s3, 0
spin:
    beq s3, s2, done
    addi s3, s3, 1
    j spin
done:
    mv a0, s2
    li t0, 1
    ecall               # commit count
    li t0, 0
    li a0, 0
    ecall
"""

# identity: read 8 digest words; VERIFY each (records one assumption);
# commit each (journal = the digest). The composition primitive.
IDENTITY_SRC = """
start:
    li s2, 8
    li s3, 0
loop:
    beq s3, s2, done
    li t0, 2
    ecall               # read word
    mv s4, a0
    li t0, 4
    ecall               # verify word
    mv a0, s4
    li t0, 1
    ecall               # commit word
    addi s3, s3, 1
    j loop
done:
    li t0, 0
    li a0, 0
    ecall
"""

# muldiv: read a, b; commit mul/mulhu/divu/remu results (M extension —
# executor-only until the AIR grows M support).
MULDIV_SRC = """
start:
    li t0, 2
    ecall
    mv a2, a0           # a
    li t0, 2
    ecall
    mv a3, a0           # b
    mul a4, a2, a3
    mulhu a5, a2, a3
    divu a6, a2, a3
    remu a7, a2, a3
    mv a0, a4
    li t0, 1
    ecall
    mv a0, a5
    li t0, 1
    ecall
    mv a0, a6
    li t0, 1
    ecall
    mv a0, a7
    li t0, 1
    ecall
    li t0, 0
    li a0, 0
    ecall
"""

# signed_m: read a, b; commit mulh/mulhsu/div/rem results (signed M
# extension in-circuit; edge cases driven from the test inputs).
SIGNED_M_SRC = """
start:
    li t0, 2
    ecall
    mv a2, a0           # a
    li t0, 2
    ecall
    mv a3, a0           # b
    mulh a4, a2, a3
    mulhsu a5, a2, a3
    div a6, a2, a3
    rem a7, a2, a3
    mv a0, a4
    li t0, 1
    ecall
    mv a0, a5
    li t0, 1
    ecall
    mv a0, a6
    li t0, 1
    ecall
    mv a0, a7
    li t0, 1
    ecall
    li t0, 0
    li a0, 0
    ecall
"""


# memtest: exercises RAM (sw/lw): stores input words to a buffer, reads
# them back in reverse, commits. Tests the sorted-memory argument.
SUBWORD_SRC = """
_start:
    li s4, 0x20000
    li t2, 0x04030201
    sw t2, 0(s4)
    lb a0, 1(s4)        # byte1 = 0x02
    li t0, 1
    ecall
    li t3, 0x8080
    sh t3, 2(s4)        # word -> 0x80800201
    lh a0, 2(s4)        # sign-extends to 0xFFFF8080
    li t0, 1
    ecall
    lhu a0, 2(s4)       # 0x8080
    li t0, 1
    ecall
    lbu a0, 3(s4)       # 0x80
    li t0, 1
    ecall
    lb a0, 3(s4)        # 0xFFFFFF80
    li t0, 1
    ecall
    li t4, 0x5AB
    sb t4, 0(s4)        # stores low byte 0xAB -> 0x808002AB
    lw a0, 0(s4)
    li t0, 1
    ecall
    li t0, 0
    li a0, 0
    ecall
"""


AUIPC_SRC = """
_start:
    auipc s2, 0xfffff   # pc=0x1000: 0xfffff000 + 0x1000 wraps to 0 (c1=1)
    auipc s0, 0         # s0 = 0x1004
    auipc s1, 0x12345   # s1 = 0x12345000 + 0x1008
    auipc s3, 0xf       # pc=0x100c: low-limb carry (0x100c + 0xf000)
    sub a0, s1, s0
    li t0, 1
    ecall               # commit 0x12345004
    mv a0, s2
    li t0, 1
    ecall               # commit 0 (2^32 wrap)
    mv a0, s3
    li t0, 1
    ecall               # commit 0x1000c
    li t0, 0
    li a0, 0
    ecall
"""


MEMTEST_SRC = """
start:
    li t0, 2
    ecall               # n
    mv s2, a0
    li s4, 0x20000      # buffer
    li s3, 0
store_loop:
    beq s3, s2, read_phase
    li t0, 2
    ecall               # next word
    slli t1, s3, 2
    add t1, t1, s4
    sw a0, 0(t1)
    addi s3, s3, 1
    j store_loop
read_phase:
    mv s3, s2
read_loop:
    beqz s3, done
    addi s3, s3, -1
    slli t1, s3, 2
    add t1, t1, s4
    lw a0, 0(t1)
    li t0, 1
    ecall               # commit (reverse order)
    j read_loop
done:
    li t0, 0
    li a0, 0
    ecall
"""


def build(src: str, base: int = 0x1000) -> MemoryImage:
    words, _ = asm.assemble(src, base=base)
    return MemoryImage.from_words(words, base=base)


def echo() -> MemoryImage:
    return build(ECHO_SRC)


def loop_guest() -> MemoryImage:
    return build(LOOP_SRC)


def identity() -> MemoryImage:
    return build(IDENTITY_SRC)


def muldiv() -> MemoryImage:
    return build(MULDIV_SRC)


def memtest() -> MemoryImage:
    return build(MEMTEST_SRC)


def auipc_guest() -> MemoryImage:
    return build(AUIPC_SRC)


def subword_guest() -> MemoryImage:
    return build(SUBWORD_SRC)


def signed_m_guest() -> MemoryImage:
    return build(SIGNED_M_SRC)


def words(ints):
    """Pack a list of u32 ints into input bytes."""
    return b"".join((int(w) & 0xFFFFFFFF).to_bytes(4, "little") for w in ints)


# keccak: zero a 50-word state, run the keccak coprocessor ecall, commit
# the first two output words (executor/coproc functional path; proving via
# the keccak circuit is staged).
KECCAK_SRC = """
start:
    li s4, 0x30000      # state buffer (50 words)
    li s3, 0
    li s2, 50
zero_loop:
    beq s3, s2, permute
    slli t1, s3, 2
    add t1, t1, s4
    sw zero, 0(t1)
    addi s3, s3, 1
    j zero_loop
permute:
    mv a0, s4
    li t0, 5            # KECCAK
    ecall
    lw a0, 0(s4)
    li t0, 1
    ecall               # commit word 0 (low half of lane 0)
    lw a0, 4(s4)
    li t0, 1
    ecall               # commit word 1 (high half of lane 0)
    li t0, 0
    li a0, 0
    ecall
"""


def keccak_guest() -> MemoryImage:
    return build(KECCAK_SRC)


# assessor: the market fulfillment guest (reference
# crates/guest/assessor/assessor-guest/src/main.rs:24-115 role, reshaped
# for this zkVM's composition primitives). Input stream (READ ecalls):
#
#   n_fills
#   per fill:
#     8 words  app claim digest  -> each VERIFY'd (binds the app proof
#                                   as an assumption) and committed
#     1 word   predicate kind    (0 = claim-match: the VERIFY binding IS
#                                 the check; 1 = prefix-match)
#     kind 1 only:
#       L (total journal words), E (compare words), then L journal words
#       where each of the first E is followed by its expected word —
#       reading the journal folds it into the assessor claim's input
#       chain, and a mismatch faults the guest (no proof exists, the
#       reference guest's panic semantics).
#
# The committed journal (AssessorJournal analogue) is
# [n_fills, fill_0 digest words + kind, ...]. ECDSA signature recovery
# stays host-side (secp256k1 bignum in-guest is roadmap — the remaining
# gap to BASELINE config 3; docs/PARITY.md).
ASSESSOR_SRC = """
start:
    li t0, 2
    ecall               # n_fills
    mv s1, a0
    li t0, 1
    ecall               # commit n_fills
fill_loop:
    beqz s1, done
    li s2, 8
dw_loop:
    beqz s2, pred
    li t0, 2
    ecall               # read digest word
    mv s4, a0
    li t0, 4
    ecall               # VERIFY word (assumption binding)
    mv a0, s4
    li t0, 1
    ecall               # commit word
    addi s2, s2, -1
    j dw_loop
pred:
    li t0, 2
    ecall               # predicate kind
    mv s5, a0
    li t0, 1
    ecall               # commit kind
    beqz s5, next_fill
    li t0, 2
    ecall               # L journal words
    mv s6, a0
    li t0, 2
    ecall               # E compare words
    mv s7, a0
    blt s6, s7, fault
cmp_loop:
    beqz s6, next_fill
    li t0, 2
    ecall               # journal word
    mv s8, a0
    addi s6, s6, -1
    beqz s7, cmp_loop
    li t0, 2
    ecall               # expected word
    bne a0, s8, fault
    addi s7, s7, -1
    j cmp_loop
fault:
    li t0, 6
    ecall               # unknown ecall: guest faults, no proof exists
next_fill:
    addi s1, s1, -1
    j fill_loop
done:
    li t0, 0
    li a0, 0
    ecall
"""


def assessor() -> MemoryImage:
    return build(ASSESSOR_SRC)
