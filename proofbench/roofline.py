"""The kernels' yardstick: the least time a launch's work can take on one
H100, counted from the launch's shapes, never from the kernel's code or
the card's clocks, so that no kernel change can move its own yardstick.

A launch's least time is the larger of its bytes at the card's memory
bandwidth and its field operations, as 32-bit instructions, at the card's
issue rate. Each input byte is read once and each output byte written
once. The operations are the algorithm's:

* a size-m NTT of one column: (m/2) log2 m butterflies, each one product
  and two sums; a multiplier table applied as the tile loads, stores or
  turns (the four-step's twiddles, a coset shift, a scale): one product
  an element it touches;
* a Poseidon2 permutation (width 24, 4 + 21 + 4 rounds, x^7 S-box):
  1,356 products and 2,352 sums (`P2_PRODUCTS`, `P2_SUMS`), and one sum
  for each word a sponge absorbs.

Constants (NVIDIA H100 SXM5 data sheet; the CUDA C++ Programming Guide's
throughput table for compute capability 9.0):
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # HBM3 bandwidth, 3.35 TB/s
SMS = 132  # streaming multiprocessors
BOOST_HZ = 1.98e9  # the largest boost clock, 1,980 MHz
# 4 warp schedulers an SM, each issuing one 32-lane instruction a clock:
# the most 32-bit instructions an SM can start a clock, of any kind
LANES_PER_SM_CLOCK = 128
ISSUE_PER_S = SMS * LANES_PER_SM_CLOCK * BOOST_HZ
# Baby Bear (p = 15 * 2^27 + 1) in Montgomery form on 32-bit words:
# a product is mul.lo, mul.hi, m = lo * p', mul.hi(m, p), a subtraction
# and one min-correction; a sum is an add (or sub) and one min-correction
INSTR_PER_PRODUCT = 6
INSTR_PER_SUM = 2

# Poseidon2 over Baby Bear, width 24: the external layer is six 4x4
# blocks of 14 sums, 20 sums of the blocks' totals and 24 of their
# broadcast (128); a full round adds 24 constants, 24 S-boxes of 4
# products and the external layer; a partial round adds one constant,
# one S-box, 24 products by the internal diagonal, 23 sums of the total
# and 24 of its broadcast; one external layer comes first.
P2_WIDTH, P2_RATE, P2_DIGEST = 24, 16, 8
P2_FULL, P2_PARTIAL = 8, 21
_EXT_SUMS = 6 * 14 + 20 + 24
P2_PRODUCTS = P2_FULL * 24 * 4 + P2_PARTIAL * (4 + 24)
P2_SUMS = _EXT_SUMS + P2_FULL * (24 + _EXT_SUMS) + P2_PARTIAL * (1 + 23 + 24)
WORD = 4  # bytes of a field word


def least_seconds(instructions: float, nbytes: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, instructions / ISSUE_PER_S)


def instructions(products: float, sums: float) -> float:
    return products * INSTR_PER_PRODUCT + sums * INSTR_PER_SUM


def ntt_work(rows_in: int, lanes: int, m: int, n2: int = 0,
             load: tuple = (0, 0), store: tuple = (0, 0),
             rows_out: int = 0) -> tuple:
    """(instructions, bytes) of one sub-transform launch: a size-m NTT of
    `lanes` columns whose first `rows_in` rows are read. `n2` > 0: the
    result turns through an (m, n2) twiddle table and every one of the
    m * lanes words is stored; else `rows_out` rows are stored. `load` /
    `store`: the (A, B) table lengths of a multiplier applied as the tile
    loads / stores (0, 0 when there is none)."""
    log_m = m.bit_length() - 1
    butterflies = (m // 2) * log_m * lanes
    products = butterflies
    out_words = m * lanes if n2 else rows_out * lanes
    table_words = m * n2
    if n2:
        products += m * lanes
    if load[0]:
        products += rows_in * lanes
        table_words += sum(load)
    if store[0]:
        products += out_words
        table_words += sum(store)
    nbytes = (rows_in * lanes + out_words + table_words) * WORD
    return instructions(products, 2 * butterflies), nbytes


def sponge_work(rows: int, cols: int, init: bool, out_words: int) -> tuple:
    """(instructions, bytes) of one sponge launch: each of `rows` rows of
    `cols` words absorbed at rate 16 (at least one permutation a row),
    from an initial state when `init`."""
    blocks = max(1, -(-cols // P2_RATE))
    perms = rows * blocks
    instr = instructions(perms * P2_PRODUCTS,
                         perms * P2_SUMS + rows * cols)
    nbytes = (rows * cols + (rows * P2_WIDTH if init else 0)
              + rows * out_words) * WORD
    return instr, nbytes


def tree_work(nodes: int) -> tuple:
    """(instructions, bytes) of a tree top over `nodes` digests: every
    level above them, nodes - 1 two-to-one hashes of one block each."""
    perms = nodes - 1
    instr = instructions(perms * P2_PRODUCTS,
                         perms * (P2_SUMS + 2 * P2_DIGEST))
    nbytes = (nodes + perms) * P2_DIGEST * WORD
    return instr, nbytes
