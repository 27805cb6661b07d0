"""rv32im segment AIR on torch tensors.

Counterpart of `boundless_tpu/air/rv32im.py`. The column layout, the LogUp
port definitions and `Rv32imAir.constraints` are the reference's, line for
line: they are written against the `alg` surface and numpy constants only,
and here run on the torch algebras of `air/dsl.py`. The parts that called
JAX directly are rewritten in torch: `public_logup_sum` and `accum_trace`
(over `dsl.Rows.of_trace`, with the exact prefix sum
`dsl.logup_running_sum` in place of the reference's associative scan).
The reference's fused-kernel public-input hooks
(`pallas_pub_pack`/`unpack`) are here as
`cons_pub_pack`/`cons_pub_unpack`, for the CUDA constraint kernel
(`air/cons_eval.py`, `kernels/cons.py`), which this AIR's proofs on the
card run (`fused_cons`). The wire-algebra branch (`is_prog`,
`_public_logup_sum_prog`) lets the recursion lift program evaluate
`constraints` in-circuit (`recursion/programs.py`).

Variants: `Rv32imAir(True)` is the full RV32IM layout (584 data columns,
keccak burst machinery), `Rv32imAir(False)` the RV32I prefix (392).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import field as F
from ..core import ntt as NTT
from . import dsl
from .dsl import ExtVal, Rows, VecVal

# ---------------------------------------------------------------------------
# Column layout
# ---------------------------------------------------------------------------


class DataCols:
    """Data-group column layout.

    Two variants share one allocation order: the RV32I layout
    (with_m=False, 392 columns) is a strict PREFIX of the RV32IM layout
    (584 columns) — witness generation always fills the full layout and
    truncates for RV32I programs (zkvm/prove.py picks the variant from
    the image's decoded instructions; proving a non-M program commits
    192 fewer columns, the dominant prover cost driver).
    """

    def __init__(self, with_m: bool = True):
        self.with_m = with_m
        a = dsl.Alloc()
        self.regs = a.get(64)  # reg k limb l at regs.start + 2k + l
        self.pc = a.get()
        self.sel = a.get(10)  # LUI AUIPC JAL JALR BR LOAD STORE ALUI ALUR ECALL
        self.f3 = a.get(8)
        self.alt = a.get()
        self.imm_lo = a.get()
        self.imm_hi = a.get()
        self.imm_field = a.get()
        self.rd_oh = a.get(32)
        self.rs1_oh = a.get(32)
        self.rs2_oh = a.get(32)
        self.rs1v = a.get(2)
        self.rs2v = a.get(2)
        self.op2 = a.get(2)
        self.rdv = a.get(2)
        self.a_bits = a.get(32)
        self.b_bits = a.get(32)
        self.r_bits = a.get(32)
        self.sh_oh = a.get(32)
        self.c0 = a.get()
        self.c1 = a.get()
        self.eq = a.get()
        self.z_inv = a.get()
        self.taken = a.get()
        self.k = a.get(5)  # ecall kind one-hot: halt commit read log verify
        self.commit_seq = a.get()
        self.read_seq = a.get()
        self.verify_seq = a.get()
        self.active = a.get()
        self.halted = a.get()
        self.s_active = a.get()
        self.s_is_write = a.get()
        self.s_new = a.get()
        self.s_addr = a.get()  # word address
        self.s_clk = a.get()
        self.s_val = a.get(2)
        self.s_dbits = a.get(26)
        self.mult_fetch = a.get()
        self.mult_init = a.get()  # dead (paging publics replaced the
        #                           image-table init lookup); kept so the
        #                           layout prefix stays stable
        self.is_m = a.get()  # decoded M-extension flag (fetch-bound)
        self.is_shift_col = a.get()  # == is_alu*(1-is_m)*(f3_1+f3_5)
        self.is_slt_col = a.get()  # == is_alu*(1-is_m)*(f3_2+f3_3)
        self.is_logic_col = a.get()  # == is_alu*(1-is_m)*(f3_4+f3_6+f3_7)
        # --- RAM paging port (cross-segment continuity; zkvm/paging.py) ---
        # s_pre_val: the word's value at segment entry, witnessed on
        # first-access rows (s_new). For first READS it must equal s_val
        # (constraint); for first writes it is bound to the pre-memory
        # PageTree root by the lift program's in-circuit page walk.
        self.s_pre_val = a.get(2)
        # s_last: committed last-access-of-address flag (emits the final
        # word value through the `final` LogUp port).
        self.s_last = a.get()
        # SB stores witness the high byte of rs2's low limb here
        self.q8 = a.get(8)
        # --- committed degree helpers (ZK blinding degree budget) ---
        # With blinded zk tail rows, point-class constraint families must
        # stay at degree <= 4 (their composition term divides by
        # Z_H / P_Z, gaining deg Z — prover/stark.py). These committed
        # columns shave one degree off the former deg-5 families; each
        # has a point-class definition constraint of degree <= 4.
        self.sx = a.get()  # a31 XOR b31 (signed-compare helper)
        self.is_addm = a.get()  # shared-adder "add mode" selector
        self.is_subm = a.get()  # shared-adder "sub mode" selector
        self.sh_sra = a.get()  # is_shift * f3_5 * alt (sra direction)
        if not with_m:
            self.pad = a.get(392 - a.n)
            self.total = a.n
            return
        # --- M extension ---
        # product machinery: 8x8-bit byte partial products with carry
        # chain (sums < 2^18 < p, so the integer identity never wraps)
        self.m_hi_bits = a.get(32)  # product high word bits
        self.m_carry_bits = a.get(77)  # 7 carries x 11 bits
        self.m_rem_bits = a.get(32)  # divu/remu remainder bits
        self.m_d_bits = a.get(32)  # witness for r < b (r + d + 1 = b)
        self.m_ca0 = a.get()  # qb+r=a carry limb0
        self.m_ca1 = a.get()  # qb+r=a carry limb1 (signed div)
        self.m_cb = a.get()  # r+d+1=b carry
        self.m_bzero = a.get()  # divisor-is-zero flag
        self.m_binv = a.get()  # inverse witness for (b0+b1)
        # --- signed M (MULH/MULHSU/DIV/REM) ---
        # s_bits: [e0, e1] high-identity 2^32 carry, [2] overflow flag o
        # (a = -2^31, b = -1), [3, 4] |r| < |b| comparison carries
        self.m_s_bits = a.get(8)
        self.m_g = a.get()  # committed gate selS * (1 - o)
        self.m_g2 = a.get()  # committed gate selS * (1 - bzero)
        # --- keccak-ecall burst (rv32im variant only; in-circuit coproc
        # binding, reference executor.rs:281-292 Coprocessor callback) ---
        # A KECCAK ecall occupies 50 trace rows ("burst"): row j reads
        # in-state word j (mem2 port, phase 0; value in b_bits) and
        # writes out-state word j (mem port, phase 1; value in a_bits) at
        # word address a0/4 + j, and emits two PUBLIC cpio LogUp entries
        # (seq = cp_seq, in word) / (seq = cp_seq + 1, out word). The
        # lift program re-hashes the public cpio table into per-
        # permutation claim digests and folds the claim's coproc chain —
        # the guest's ecall chain is thereby IN-CIRCUIT end to end.
        self.k_kec = a.get()      # keccak-ecall burst row flag (bool)
        self.kec_cnt = a.get()    # burst row counter 0..49
        self.kec_last = a.get()   # bool == (kec_cnt == 49) (forced)
        self.kec_linv = a.get()   # inverse witness for (kec_cnt - 49)
        self.cp_seq = a.get()     # session cpio ENTRY counter (2/row)
        # pad for tp-sharding divisibility (unconstrained zero cols)
        self.pad = a.get(584 - a.n)
        self.total = a.n


class CtrlCols:
    def __init__(self):
        a = dsl.Alloc()
        self.is_first = a.get()
        # trans gate: 1 on rows 0..N-Z-2 (transitions between REAL rows
        # only; Z = zk_rows(po2) blinded tail rows are fully free).
        self.not_last = a.get()
        # 1 exactly at row N-Z-1 (the last real row): all boundary
        # claims (post pc/regs/seqs, LogUp S_pub) bind there.
        self.is_last = a.get()
        self.clk = a.get()
        # decoded image table (static per program; ctrl root == image_id)
        self.t_active = a.get()
        self.t_pc = a.get()  # byte address of this word
        self.t_word = a.get(2)  # raw word limbs (for init reads)
        self.t_sel = a.get(10)
        self.t_f3 = a.get(8)
        self.t_alt = a.get()
        self.t_imm_lo = a.get()
        self.t_imm_hi = a.get()
        self.t_imm_field = a.get()
        self.t_rd = a.get()
        self.t_rs1 = a.get()
        self.t_rs2 = a.get()
        self.t_mext = a.get()  # instruction is an M-extension op (f7 bit 0)
        self.pad = a.get(40 - a.n)  # pad for tp-mesh divisibility
        self.total = a.n


class AccumCols:
    # mem  = instruction-side access at time 2*clk + is_write (the final
    #        value: loaded word / merged stored word)
    # mem2 = the extra old-word *read* (time 2*clk) that a sub-word store
    #        performs before its write — one instruction, two log rows
    # cpio_in/cpio_out (rv32im variant only) = the keccak-burst public
    #        word entries (in-state / out-state), bound to pub.cpio
    BASE_PORTS = ("fetch", "fetch_tbl", "mem", "mem2", "mem_sorted",
                  "init", "final", "commit", "read", "verify")
    SIGNS = {"fetch": +1, "fetch_tbl": -1, "mem": +1, "mem2": +1,
             "mem_sorted": -1, "init": +1, "final": +1, "commit": +1,
             "read": +1, "verify": +1, "cpio_in": +1, "cpio_out": +1}

    def __init__(self, kec: bool = True):
        self.PORTS = self.BASE_PORTS + (("cpio_in", "cpio_out")
                                        if kec else ())
        self.inv = {p: 4 * i for i, p in enumerate(self.PORTS)}
        self.running = 4 * len(self.PORTS)
        self.total = 4 * len(self.PORTS) + 4
        pad_to = 56 if kec else 48
        self.pad = pad_to - self.total
        self.total = pad_to


DC = DataCols()
DC_I = DataCols(with_m=False)
CC = CtrlCols()
AC = AccumCols()
AC_I = AccumCols(kec=False)


def zk_rows(po2: int) -> int:
    """Blinded tail rows per segment (ZK region; docs/ZK_BLINDING_DESIGN).

    Every committed column polynomial reveals <= queries + 2 evaluations
    (query openings + DEEP taps); Z free random rows per column make the
    revealed tuple simulatable. 128 covers the production proof system
    (100 queries); small test traces scale down (N/4 >= queries + 2 for
    every ProofSystem used in CI)."""
    return min(128, (1 << po2) // 4)

TAG = {"fetch": 1, "mem": 2, "init": 3, "commit": 4, "read": 5, "verify": 6,
       "final": 7, "cpio": 8}

IO_MAX = 64  # public io rows (journal + input + assumption words) per segment
# keccak-coprocessor public word budget (rv32im variant): each keccak
# ecall publishes its 50 in-state + 50 out-state words as cpio entries
# (seq, lo, hi, mask); the executor flushes a segment when a burst would
# exceed the budget. CI-scale sizing — production raises CP_PERMS with
# po2 (docs/PROTOCOL.md coproc section).
KEC_WORDS = 50  # u32 words per keccak state (25 lanes x 2)
CP_PERMS = 2    # permutations per segment (public budget)
CP_IO = CP_PERMS * 2 * KEC_WORDS  # cpio entries (in + out words)
# Paging port geometry (must match zkvm/paging.py): touched pages per
# segment, 64 words each. Every touched word's first-access (pre) and
# final (post) values are PUBLIC, bound to the sorted RAM log by the
# init/final LogUp ports; the lift program hashes the pages and walks
# the sparse memory Merkle tree to derive post_mem_root in-circuit.
# The executor splits a segment when it would touch more pages.
MEM_PAGES = 8
PAGE_WORDS = 64
# per page entry: [page_idx, pmask] + 64 x [wmask, pre_lo, pre_hi,
#                                           post_lo, post_hi]
MEM_PAGE_ELEMS = 2 + PAGE_WORDS * 5
NUM_DPOWS = 28


@dataclasses.dataclass
class PublicValues:
    """Public claim values (Montgomery int32 tensors).

    io rows: (tag, seq, lo, hi, mask) — tag is TAG['commit'|'read'|'verify'].
    """

    pre_pc: torch.Tensor
    post_pc: torch.Tensor
    pre_regs: torch.Tensor  # (64,)
    post_regs: torch.Tensor  # (64,)
    halted: torch.Tensor
    pre_seqs: torch.Tensor  # (4,) commit, read, verify, cpio-entries
    post_seqs: torch.Tensor  # (4,)
    io: torch.Tensor  # (IO_MAX, 5)
    cpio: torch.Tensor  # (CP_IO, 4) keccak word entries (seq, lo, hi, mask)
    mem: torch.Tensor  # (MEM_PAGES, MEM_PAGE_ELEMS) paging-port pages


# ---------------------------------------------------------------------------
# Shared LogUp port computation
# ---------------------------------------------------------------------------


def _pack(alg, gamma, dpows, tag: int, comps_group):
    """gamma - (tag + Σ_j delta^{j+1} * x_j); comps_group is a group."""
    if hasattr(alg, "gsize"):  # degree and wire algebras
        g = alg.gsize(comps_group)
    else:
        g = comps_group.shape[-1] if not alg.is_ext else comps_group.shape[0]
    base = alg.esub(gamma, alg.ext_const([tag, 0, 0, 0]))
    acc = alg.gweighted_ext(comps_group, dpows[1 : g + 1])
    return alg.esub(alg.bc(base, acc), acc)


def _ports(alg, row, gamma, dpows, dc=DC):
    """(packs, sels) for every LogUp port, from a row accessor.

    `row` provides .data(i)/.ctrl(i)/.datab(idx)/.ctrlb(idx) (scalar and
    block access). Works pointwise over the LDE domain (BaseAlg), on the
    raw trace (accum_trace), and at the DEEP point (ExtAlg). `dc` is the
    variant's column layout; the rv32im variant adds the keccak-burst
    cpio ports and burst-aware mem-port expressions.
    """
    m, add, sub = alg.mul, alg.add, alg.sub
    one = alg.one()
    d = row
    kec = dc.with_m  # keccak burst machinery rides the rv32im variant

    sel_blk = d.datab(DC.sel)
    is_load = d.data(DC.sel.start + 5)
    is_store = d.data(DC.sel.start + 6)
    active = d.data(DC.active)
    pc = d.data(DC.pc)
    clk = d.ctrl(CC.clk)
    rdv = [d.data(DC.rdv.start + i) for i in range(2)]
    rs2v = [d.data(DC.rs2v.start + i) for i in range(2)]
    r_blk = d.datab(DC.r_bits)

    def idx_of(oh_slice):
        return alg.gweighted(d.datab(oh_slice), np.arange(32))

    addr_word = alg.gweighted(
        r_blk, np.array([1 << (i - 2) if 2 <= i < 26 else 0
                         for i in range(32)], dtype=np.int64))

    # exec fetch pack: [pc, sel10, f3sel8, alt, imm_lo, imm_hi, imm_field,
    #                   rd, rs1, rs2, is_m]
    fetch_comps = alg.gconcat([
        alg.stack([pc]), sel_blk, d.datab(DC.f3),
        alg.stack([d.data(DC.alt), d.data(DC.imm_lo), d.data(DC.imm_hi),
                   d.data(DC.imm_field), idx_of(DC.rd_oh),
                   idx_of(DC.rs1_oh), idx_of(DC.rs2_oh),
                   d.data(DC.is_m)])])
    tbl_comps = alg.gconcat([
        alg.stack([d.ctrl(CC.t_pc)]), d.ctrlb(CC.t_sel), d.ctrlb(CC.t_f3),
        alg.stack([d.ctrl(CC.t_alt), d.ctrl(CC.t_imm_lo),
                   d.ctrl(CC.t_imm_hi), d.ctrl(CC.t_imm_field),
                   d.ctrl(CC.t_rd), d.ctrl(CC.t_rs1), d.ctrl(CC.t_rs2),
                   d.ctrl(CC.t_mext)])])

    def reg(kk, limb):
        return d.data(DC.regs.start + 2 * kk + limb)

    # Access values ride the free bit blocks: loads put the fetched word
    # in b_bits, stores put the (merged) stored word in a_bits — uniform
    # across word and sub-word widths (rdv/rs2v relate to them through
    # the width/sign-extension constraints in `constraints`).
    W_LO16 = np.array([1 << i if i < 16 else 0 for i in range(32)],
                      dtype=np.int64)
    W_HI16 = np.array([1 << (i - 16) if i >= 16 else 0 for i in range(32)],
                      dtype=np.int64)
    a_blk = d.datab(DC.a_bits)
    b_blk = d.datab(DC.b_bits)
    BL_, BH_ = alg.gweighted(b_blk, W_LO16), alg.gweighted(b_blk, W_HI16)
    AL_, AH_ = alg.gweighted(a_blk, W_LO16), alg.gweighted(a_blk, W_HI16)
    # keccak burst rows act like a one-word store with an extra old-word
    # read (the sub-word-store shape): read in-word (b_bits) at phase 0
    # via mem2, write out-word (a_bits) at phase 1 via mem, at word
    # address a0/4 + kec_cnt (r_bits carry a0's 32-bit decomposition).
    if kec:
        k_kec = d.data(dc.k_kec)
        kec_cnt = d.data(dc.kec_cnt)
        cp_seq = d.data(dc.cp_seq)
        addr_eff = add(addr_word, m(k_kec, kec_cnt))
        mval = [add(add(m(is_load, BL_), m(is_store, AL_)), m(k_kec, AL_)),
                add(add(m(is_load, BH_), m(is_store, AH_)), m(k_kec, AH_))]
        t_main = add(add(add(clk, clk), is_store), k_kec)
        is_write = add(is_store, k_kec)
    else:
        addr_eff = addr_word
        mval = [add(m(is_load, BL_), m(is_store, AL_)),
                add(m(is_load, BH_), m(is_store, AH_))]
        # Time is 2*clk + phase (read=0, write=1): a sub-word store's
        # old-word read strictly precedes its write in the sorted log.
        t_main = add(add(clk, clk), is_store)
        is_write = is_store
    t_read = add(clk, clk)
    mem_comps = alg.stack([addr_eff, t_main, mval[0], mval[1], is_write])
    mem2_comps = alg.stack([addr_eff, t_read, BL_, BH_, alg.zero()])
    f3b = [d.data(DC.f3.start + i) for i in range(8)]
    is_subw_store = m(is_store, add(f3b[0], f3b[1]))
    srt_comps = alg.stack([d.data(DC.s_addr), d.data(DC.s_clk),
                           d.data(DC.s_val.start), d.data(DC.s_val.start + 1),
                           d.data(DC.s_is_write)])
    init_comps = alg.stack([d.data(DC.s_addr),
                            d.data(DC.s_pre_val.start),
                            d.data(DC.s_pre_val.start + 1)])
    final_comps = alg.stack([d.data(DC.s_addr), d.data(DC.s_val.start),
                             d.data(DC.s_val.start + 1)])
    commit_comps = alg.stack([d.data(DC.commit_seq), reg(10, 0), reg(10, 1)])
    read_comps = alg.stack([d.data(DC.read_seq), rdv[0], rdv[1]])
    verify_comps = alg.stack([d.data(DC.verify_seq), reg(10, 0), reg(10, 1)])

    packs = {
        "fetch": _pack(alg, gamma, dpows, TAG["fetch"], fetch_comps),
        "fetch_tbl": _pack(alg, gamma, dpows, TAG["fetch"], tbl_comps),
        "mem": _pack(alg, gamma, dpows, TAG["mem"], mem_comps),
        "mem2": _pack(alg, gamma, dpows, TAG["mem"], mem2_comps),
        "mem_sorted": _pack(alg, gamma, dpows, TAG["mem"], srt_comps),
        "init": _pack(alg, gamma, dpows, TAG["init"], init_comps),
        "final": _pack(alg, gamma, dpows, TAG["final"], final_comps),
        "commit": _pack(alg, gamma, dpows, TAG["commit"], commit_comps),
        "read": _pack(alg, gamma, dpows, TAG["read"], read_comps),
        "verify": _pack(alg, gamma, dpows, TAG["verify"], verify_comps),
    }
    k_blk = d.datab(DC.k)
    sels = {
        "fetch": active,
        "fetch_tbl": d.data(DC.mult_fetch),
        "mem": (add(add(is_load, is_store), k_kec) if kec
                else add(is_load, is_store)),
        "mem2": add(is_subw_store, k_kec) if kec else is_subw_store,
        "mem_sorted": d.data(DC.s_active),
        "init": m(d.data(DC.s_active), d.data(DC.s_new)),
        "final": d.data(DC.s_last),
        "commit": d.data(DC.k.start + 1),
        "read": d.data(DC.k.start + 2),
        "verify": d.data(DC.k.start + 4),
    }
    if kec:
        cpio_in_comps = alg.stack([cp_seq, BL_, BH_])
        cpio_out_comps = alg.stack([add(cp_seq, one), AL_, AH_])
        packs["cpio_in"] = _pack(alg, gamma, dpows, TAG["cpio"],
                                 cpio_in_comps)
        packs["cpio_out"] = _pack(alg, gamma, dpows, TAG["cpio"],
                                  cpio_out_comps)
        sels["cpio_in"] = k_kec
        sels["cpio_out"] = k_kec
    return packs, sels


def _broadcast_ext(x, shape):
    return x.expand(tuple(shape) + (4,))


def public_logup_sum(pub: PublicValues, gamma, delta):
    """S_pub: io rows + keccak cpio words + paging-port words, each
    mask / (gamma - pack), summed in the extension."""
    dev = pub.io.device
    dpows = NTT.ext_powers(delta, 4)

    def entries(tag_col, cols, mask):
        """Σ mask / (gamma - (tag + Σ_j delta^{j+1} cols[j]))."""
        acc = F.ext_from_base(tag_col)
        for j, x in enumerate(cols):
            acc = F.ext_add(acc, F.ext_scale(
                _broadcast_ext(dpows[j + 1], acc.shape[:-1]), x))
        den = F.ext_sub(_broadcast_ext(gamma, acc.shape[:-1]), acc)
        terms = F.ext_scale(F.ext_inv(den), mask)
        return F.sum_mod(terms.reshape(-1, 4), 0)

    io = pub.io
    total = entries(io[:, 0], [io[:, 1], io[:, 2], io[:, 3]], io[:, 4])

    # keccak cpio entries (tag constant; masks are zero for rv32i runs)
    cp = pub.cpio
    total = F.ext_add(total, entries(
        torch.full_like(cp[:, 0], F.mont(TAG["cpio"])),
        [cp[:, 0], cp[:, 1], cp[:, 2]], cp[:, 3]))

    # paging ports: each wmask'd word slot folds an init (pre value) and a
    # final (post value) term at addr = page_idx*64 + w
    page_idx = pub.mem[:, 0]
    words = pub.mem[:, 2:].reshape(MEM_PAGES, PAGE_WORDS, 5)
    wmask = words[..., 0]
    w_off = F.fp(np.arange(PAGE_WORDS), dev)
    addr = F.add(F.mul(page_idx, F.const(PAGE_WORDS, dev))[:, None],
                 w_off[None, :])
    for tag_name, lo_i, hi_i in (("init", 1, 2), ("final", 3, 4)):
        tag = torch.full_like(addr, F.mont(TAG[tag_name]))
        total = F.ext_add(total, entries(
            tag, [addr, words[..., lo_i], words[..., hi_i]], wmask))
    return total


def _public_logup_sum_prog(alg, pub, gamma, delta):
    """S_pub in the wire algebra (recursion/programs.ProgAlg): pub.io is a
    list of IO_MAX [tag, seq, lo, hi, mask] wire rows, pub.cpio of [seq,
    lo, hi, mask] rows and pub.mem of MEM_PAGES page entries (the lift
    program's `_WireRv32Pub`). The recursion circuit evaluates the formula
    of `public_logup_sum` with one INV op per row; pad rows have den =
    gamma != 0, so the inverse exists."""
    p = alg.p
    dpows = alg.ext_powers(delta, 4)
    total = None
    for row in pub.io:
        tag, seq, lo, hi, mask = row
        acc = tag
        for j, x in enumerate((seq, lo, hi)):
            acc = p.add(acc, p.mul(dpows[j + 1], x))
        inv_w = p.inv(p.sub(gamma, acc))
        term = p.mul(mask, inv_w)
        total = term if total is None else p.add(total, term)
    for row in pub.cpio:
        seq, lo, hi, mask = row
        acc = p.addc(p.add(p.mul(dpows[1], seq),
                           p.add(p.mul(dpows[2], lo),
                                 p.mul(dpows[3], hi))),
                     (TAG["cpio"], 0, 0, 0))
        total = p.add(total, p.mul(mask, p.inv(p.sub(gamma, acc))))
    for page in pub.mem:
        base = p.mul(page["page_idx"], p.const(PAGE_WORDS))
        for w, slot in enumerate(page["words"]):
            wmask, pre_lo, pre_hi, post_lo, post_hi = slot
            addr = p.addc(base, (w, 0, 0, 0)) if w else base
            for tag_name, lo_w, hi_w in (("init", pre_lo, pre_hi),
                                         ("final", post_lo, post_hi)):
                acc = p.addc(p.add(p.mul(dpows[1], addr),
                                   p.add(p.mul(dpows[2], lo_w),
                                         p.mul(dpows[3], hi_w))),
                             (TAG[tag_name], 0, 0, 0))
                total = p.add(total, p.mul(wmask, p.inv(p.sub(gamma, acc))))
    return total


# ---------------------------------------------------------------------------
# The AIR
# ---------------------------------------------------------------------------


class _KernelPub:
    """Boundary publics as views of the constraint kernel's packed public
    vector (`Rv32imAir.cons_pub_unpack`). Only the leaves `constraints`
    reads directly; io/mem enter solely through the precomputed S_pub."""

    __slots__ = ("pre_pc", "post_pc", "halted", "pre_seqs", "post_seqs",
                 "pre_regs", "post_regs")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


class Rv32imAir(dsl.Air):
    ctrl_cols = CC.total
    globals_count = 2  # gamma, delta
    max_degree = 5
    ctrl_dynamic = True  # ctrl trace (image table) is a prover input

    def __init__(self, with_m: bool = True):
        self.with_m = with_m
        self.dc = DC if with_m else DC_I
        self.ac = AC if with_m else AC_I
        self.accum_cols = self.ac.total
        self.name = "rv32im" if with_m else "rv32i"
        self.data_cols = self.dc.total

    def zk_rows(self, po2: int) -> int:
        """Blinded tail rows (module-level zk_rows; ZK on by default)."""
        return zk_rows(po2)

    # --- fused constraint-kernel hooks (air/cons_eval.py) ---
    # The kernel evaluates `constraints` traced once into a program whose
    # row-independent inputs (globals, S_pub, boundary publics) travel as
    # one packed vector, so the program never depends on a public value.
    fused_cons = True  # the reference's `pallas_cons_ok`
    PUB_VEC_WORDS = 256

    def cons_pub_pack(self, pub: PublicValues, globals_):
        """(globals, S_pub, boundary publics) -> (256,) Montgomery int32."""
        s_pub = public_logup_sum(pub, globals_[0], globals_[1])
        parts = [globals_.reshape(-1), s_pub.reshape(-1)]
        for leaf in (pub.pre_pc, pub.post_pc, pub.halted, pub.pre_seqs,
                     pub.post_seqs, pub.pre_regs, pub.post_regs):
            parts.append(leaf.reshape(-1).to(F.I32))
        flat = torch.cat(parts)
        assert flat.shape[0] <= self.PUB_VEC_WORDS
        return torch.nn.functional.pad(
            flat, (0, self.PUB_VEC_WORDS - flat.shape[0]))

    def cons_pub_unpack(self, sm):
        """A packed vector's words (any indexable of `PUB_VEC_WORDS`
        values) -> (globals list, publics view, S_pub); ext values are
        4-tuples of words."""
        ext = lambda i: tuple(sm[i: i + 4])  # noqa: E731
        pub = _KernelPub(
            pre_pc=sm[12], post_pc=sm[13], halted=sm[14],
            pre_seqs=sm[15:19], post_seqs=sm[19:23],
            pre_regs=sm[23:87], post_regs=sm[87:151])
        return [ext(0), ext(4)], pub, ext(8)

    def accum_trace(self, ctrl, data, globals_):
        """LogUp inverse columns per port, then the signed running sum."""
        gamma, delta = globals_[0], globals_[1]
        dpows = NTT.ext_powers(delta, NUM_DPOWS)
        n = data.shape[0]
        ac = self.ac
        packs, sels = _ports(dsl.BaseAlg(data.device),
                             Rows.of_trace(ctrl, data), gamma, dpows, self.dc)
        out = torch.zeros((n, ac.total), dtype=F.I32, device=data.device)
        total = torch.zeros((n, 4), dtype=F.I32, device=data.device)
        stacked = torch.stack([packs[p].expand(n, 4) for p in ac.PORTS])
        invs = F.ext_inv(stacked)  # one batched inversion, (ports, N, 4)
        for i, port in enumerate(ac.PORTS):
            inv = F.ext_scale(invs[i], sels[port])
            out[:, ac.inv[port]: ac.inv[port] + 4] = inv
            total = F.ext_add(total,
                              inv if ac.SIGNS[port] > 0 else F.ext_neg(inv))
        out[:, ac.running: ac.running + 4] = dsl.logup_running_sum(total)
        return out

    # All heavy constraint families below are *grouped*: one op per family,
    # however many columns it spans.
    def constraints(self, alg, now, nxt, globals_, pub: PublicValues):
        gamma, delta = globals_[0], globals_[1]
        dpows = alg.ext_powers(delta, NUM_DPOWS)
        d = Rows(now)
        nx = Rows(nxt)
        # Constraint classes for the blinded zk tail (prover/stark.py):
        # trans-class families carry an is_first/is_last/not_last ctrl
        # gate (0 on zk rows), so they vanish there and divide by the
        # full Z_H; point-class families hold on REAL rows only and
        # divide by Z_H / P_Z. `c.append` = point (default),
        # `c.append_t` = trans. The class list is exposed as
        # `air._zclass` after each constraints() call (same order).

        class _ConsList(list):
            def append(self, v):
                self.zclass.append(False)
                super(_ConsList, self).append(v)

            def append_t(self, v):
                self.zclass.append(True)
                super(_ConsList, self).append(v)

        c = _ConsList()
        c.zclass = []
        m, add, sub = alg.mul, alg.add, alg.sub
        gm, ga, gs = alg.gmul, alg.gadd, alg.gsub
        B = alg.B
        one = alg.one()

        def dsum(vals):
            acc = None
            for v in vals:
                acc = v if acc is None else add(acc, v)
            return acc if acc is not None else alg.zero()

        sel = [d.data(DC.sel.start + i) for i in range(10)]
        (is_lui, is_auipc, is_jal, is_jalr, is_br, is_load, is_store,
         is_alui, is_alur, is_ecall) = sel
        f3 = [d.data(DC.f3.start + i) for i in range(8)]
        alt = d.data(DC.alt)
        k = [d.data(DC.k.start + i) for i in range(5)]
        k_halt, k_commit, k_read, k_log, k_verify = k
        active = d.data(DC.active)
        halted = d.data(DC.halted)
        pc = d.data(DC.pc)
        is_first = d.ctrl(CC.is_first)
        not_last = d.ctrl(CC.not_last)
        is_last = d.ctrl(CC.is_last)

        a_blk = d.datab(DC.a_bits)
        b_blk = d.datab(DC.b_bits)
        r_blk = d.datab(DC.r_bits)
        sh_blk = d.datab(DC.sh_oh)
        rd_blk = d.datab(DC.rd_oh)
        rs1_blk = d.datab(DC.rs1_oh)
        rs2_blk = d.datab(DC.rs2_oh)

        dc = self.dc

        # ---- boolean constraints (single grouped VecVal) ----
        bool_cols = (list(range(DC.sel.start, DC.sel.stop))
                     + list(range(DC.f3.start, DC.f3.stop))
                     + [DC.alt]
                     + list(range(DC.rd_oh.start, DC.rd_oh.stop))
                     + list(range(DC.rs1_oh.start, DC.rs1_oh.stop))
                     + list(range(DC.rs2_oh.start, DC.rs2_oh.stop))
                     + list(range(DC.a_bits.start, DC.a_bits.stop))
                     + list(range(DC.b_bits.start, DC.b_bits.stop))
                     + list(range(DC.r_bits.start, DC.r_bits.stop))
                     + list(range(DC.sh_oh.start, DC.sh_oh.stop))
                     + [DC.c0, DC.c1, DC.eq, DC.taken]
                     + list(range(DC.k.start, DC.k.stop))
                     + [DC.active, DC.halted, DC.s_active, DC.s_is_write,
                        DC.s_new]
                     + list(range(DC.s_dbits.start, DC.s_dbits.stop))
                     + [DC.is_m, DC.is_shift_col, DC.is_slt_col,
                        DC.is_logic_col]
                     + list(range(dc.q8.start, dc.q8.stop))
                     + ([dc.k_kec, dc.kec_last] if self.with_m else [])
                     + (([DC.m_ca0, DC.m_ca1, DC.m_cb, DC.m_bzero]
                         + list(range(DC.m_hi_bits.start,
                                      DC.m_hi_bits.stop))
                         + list(range(DC.m_carry_bits.start,
                                      DC.m_carry_bits.stop))
                         + list(range(DC.m_rem_bits.start,
                                      DC.m_rem_bits.stop))
                         + list(range(DC.m_d_bits.start, DC.m_d_bits.stop))
                         + list(range(DC.m_s_bits.start, DC.m_s_bits.stop)))
                        if self.with_m else []))
        bools = d.datab(bool_cols)
        ones_g = alg.gconst(np.ones(len(bool_cols), dtype=np.int64))
        c.append(VecVal(gm(bools, gs(bools, ones_g))))

        # ---- one-hot sums / class structure ----
        c.append(sub(alg.gsum(rd_blk), one))
        c.append(sub(alg.gsum(rs1_blk), one))
        c.append(sub(alg.gsum(rs2_blk), one))
        # sh_oh is one-hot only where it IS a one-hot (shift amount /
        # load-store byte offset); signed div reuses the block as the
        # dividend's bit decomposition, so the sum is gated.
        sh_users = dsum([d.data(DC.is_shift_col),
                         d.data(DC.sel.start + 5),
                         d.data(DC.sel.start + 6)])
        c.append(m(sh_users, sub(alg.gsum(sh_blk), one)))
        c.append(sub(alg.gsum(d.datab(DC.sel)), active))
        if self.with_m:
            k_kec = d.data(dc.k_kec)
            c.append(sub(add(alg.gsum(d.datab(DC.k)), k_kec), is_ecall))
        else:
            c.append(sub(alg.gsum(d.datab(DC.k)), is_ecall))

        # ---- register reads; reg0 pinned ----
        def reg(kk, limb, rows=d):
            return rows.data(DC.regs.start + 2 * kk + limb)

        reg_lo_idx = [DC.regs.start + 2 * kk for kk in range(32)]
        reg_hi_idx = [DC.regs.start + 2 * kk + 1 for kk in range(32)]
        regs_lo = d.datab(reg_lo_idx)
        regs_hi = d.datab(reg_hi_idx)
        rs1v = [d.data(DC.rs1v.start + i) for i in range(2)]
        rs2v = [d.data(DC.rs2v.start + i) for i in range(2)]
        op2 = [d.data(DC.op2.start + i) for i in range(2)]
        rdv = [d.data(DC.rdv.start + i) for i in range(2)]
        for limb, regs_l in ((0, regs_lo), (1, regs_hi)):
            c.append(sub(rs1v[limb], alg.gsum(gm(rs1_blk, regs_l))))
            c.append(sub(rs2v[limb], alg.gsum(gm(rs2_blk, regs_l))))
        c.append(reg(0, 0))
        c.append(reg(0, 1))

        # ---- op2 select ----
        imm_lo, imm_hi = d.data(DC.imm_lo), d.data(DC.imm_hi)
        imm_field = d.data(DC.imm_field)
        use_imm = dsum([is_alui, is_load, is_store, is_jalr])
        for limb, imm in ((0, imm_lo), (1, imm_hi)):
            c.append(sub(op2[limb], add(m(use_imm, imm),
                                        m(sub(one, use_imm), rs2v[limb]))))

        # ---- bit bindings (grouped weighted sums) ----
        W_LO = np.array([1 << i if i < 16 else 0 for i in range(32)],
                        dtype=np.int64)
        W_HI = np.array([1 << (i - 16) if i >= 16 else 0 for i in range(32)],
                        dtype=np.int64)
        W_HI26 = np.array([1 << (i - 16) if 16 <= i < 26 else 0
                           for i in range(32)], dtype=np.int64)
        is_m = d.data(DC.is_m)
        is_alu = add(is_alui, is_alur)
        alu_nm = m(is_alu, sub(one, is_m))  # non-M alu rows
        is_mdiv = m(is_m, add(f3[5], f3[7]))  # unsigned div/rem
        selS = m(is_m, add(f3[4], f3[6]))  # signed div/rem
        is_anydiv = m(is_m, dsum([f3[4], f3[5], f3[6], f3[7]]))
        # a-bits bind rs1v except on div/rem rows (there they carry the
        # quotient witness); b-bits always bind op2.
        bind_a = add(add(is_alui, is_br), m(is_alur, sub(one, is_anydiv)))
        bind_b = dsum([is_alui, is_alur, is_br])
        c.append(m(bind_a, sub(rs1v[0], alg.gweighted(a_blk, W_LO))))
        c.append(m(bind_a, sub(rs1v[1], alg.gweighted(a_blk, W_HI))))
        c.append(m(bind_b, sub(op2[0], alg.gweighted(b_blk, W_LO))))
        c.append(m(bind_b, sub(op2[1], alg.gweighted(b_blk, W_HI))))
        RL = alg.gweighted(r_blk, W_LO)
        RH = alg.gweighted(r_blk, W_HI)

        # ---- shared adder ----
        # is_addm / is_subm are COMMITTED columns (DC.is_addm/is_subm)
        # with point-class degree-4 definitions: with blinded zk rows the
        # adder identities below must stay point-class degree <= 4
        # (docs/ZK_BLINDING_DESIGN.md), and the inline selector
        # expressions are themselves degree 4.
        c0b, c1b = d.data(DC.c0), d.data(DC.c1)
        is_addm = d.data(DC.is_addm)
        is_subm = d.data(DC.is_subm)
        c.append(sub(is_addm, add(m(alu_nm, m(f3[0], sub(one, alt))),
                                  dsum([is_load, is_store, is_jalr]))))
        c.append(sub(is_subm, add(m(alu_nm, add(m(f3[0], alt),
                                                add(f3[2], f3[3]))),
                                  is_br)))
        c16 = alg.const(1 << 16)
        cFFFF = alg.const(0xFFFF)
        c.append(m(is_addm, sub(add(rs1v[0], op2[0]), add(RL, m(c0b, c16)))))
        c.append(m(is_addm, sub(add(add(rs1v[1], op2[1]), c0b),
                                add(RH, m(c1b, c16)))))
        c.append(m(is_subm, sub(add(op2[0], RL), add(rs1v[0], m(c0b, c16)))))
        c.append(m(is_subm, sub(add(add(op2[1], RH), c0b),
                                add(rs1v[1], m(c1b, c16)))))

        # ---- logic ops (grouped over 32 bits) ----
        # committed bool keeps the per-bit constraint within degree 5
        is_logic = d.data(DC.is_logic_col)
        c.append(sub(is_logic, m(alu_nm, dsum([f3[4], f3[6], f3[7]]))))
        ab = gm(a_blk, b_blk)
        apb = ga(a_blk, b_blk)
        x_xor = gs(apb, ga(ab, ab))
        x_or = gs(apb, ab)
        expect = ga(gm(B(f3[4]), x_xor), ga(gm(B(f3[6]), x_or),
                                            gm(B(f3[7]), ab)))
        c.append(VecVal(gm(B(is_logic), gs(r_blk, expect))))

        # ---- shifts (barrel: 32 grouped shifted accumulations) ----
        # is_shift_col is a committed bool == alu_nm*(f3_1 + f3_5) so the
        # per-bit shift constraints stay within the degree-5 budget.
        is_shift = d.data(DC.is_shift_col)
        c.append(sub(is_shift, m(alu_nm, add(f3[1], f3[5]))))
        # sh_sra is a COMMITTED column (= is_shift * f3_5 * alt, the only
        # degree-3 direction selector): srl = is_shift*f3_5 - sh_sra stays
        # degree 2, keeping the barrel family point-class degree <= 4.
        is_sra = d.data(DC.sh_sra)
        c.append(sub(is_sra, m(is_shift, m(f3[5], alt))))
        is_sll = m(is_shift, f3[1])
        is_srl = sub(m(is_shift, f3[5]), is_sra)
        shamt = alg.gweighted(b_blk, np.array(
            [1 << i if i < 5 else 0 for i in range(32)], dtype=np.int64))
        sh_idx = alg.gweighted(sh_blk, np.arange(32))
        c.append(m(is_shift, sub(sh_idx, shamt)))
        e_sll = None
        e_srl = None
        e_sra = None
        for s in range(32):
            oh_s = B(d.data(DC.sh_oh.start + s))
            t1 = gm(oh_s, alg.gshift_sll(a_blk, s))
            t2 = gm(oh_s, alg.gshift_srl(a_blk, s))
            t3 = gm(oh_s, alg.gshift_sra(a_blk, s))
            e_sll = t1 if e_sll is None else ga(e_sll, t1)
            e_srl = t2 if e_srl is None else ga(e_srl, t2)
            e_sra = t3 if e_sra is None else ga(e_sra, t3)
        expect = ga(gm(B(is_sll), e_sll),
                    ga(gm(B(is_srl), e_srl), gm(B(is_sra), e_sra)))
        c.append(VecVal(gs(gm(B(is_shift), r_blk), expect)))

        # ---- comparisons / branches ----
        lt_u = c1b
        a31 = d.data(DC.a_bits.start + 31)
        b31 = d.data(DC.b_bits.start + 31)
        two = alg.const(2)
        # sx = a31 XOR b31 is COMMITTED (DC.sx, degree-2 definition) so
        # lt_s stays degree 2 and the branch/slt families point-class
        # degree <= 4 under blinding.
        sx = d.data(DC.sx)
        c.append(sub(sx, sub(add(a31, b31), m(two, m(a31, b31)))))
        lt_s = sub(add(lt_u, sx), m(two, m(lt_u, sx)))
        eq = d.data(DC.eq)
        z_inv = d.data(DC.z_inv)
        z = add(RL, RH)
        c.append(m(is_br, m(eq, z)))
        c.append(m(is_br, sub(add(eq, m(z, z_inv)), one)))
        taken = d.data(DC.taken)
        c.append(m(is_br, sub(taken, dsum([
            m(f3[0], eq), m(f3[1], sub(one, eq)),
            m(f3[4], lt_s), m(f3[5], sub(one, lt_s)),
            m(f3[6], lt_u), m(f3[7], sub(one, lt_u))]))))

        # ---- rdv definitions ----
        alu_arith = m(alu_nm, dsum([f3[0], f3[1], f3[4], f3[5], f3[6],
                                    f3[7]]))
        slt_sel = d.data(DC.is_slt_col)  # committed bool (degree budget)
        c.append(sub(slt_sel, m(alu_nm, add(f3[2], f3[3]))))
        c.append(m(alu_arith, sub(rdv[0], RL)))
        c.append(m(alu_arith, sub(rdv[1], RH)))
        slt_val = add(m(f3[2], lt_s), m(f3[3], lt_u))
        c.append(m(slt_sel, sub(rdv[0], slt_val)))
        c.append(m(slt_sel, rdv[1]))
        c.append(m(is_lui, sub(rdv[0], imm_lo)))
        c.append(m(is_lui, sub(rdv[1], imm_hi)))
        RH26 = alg.gweighted(r_blk, W_HI26)
        c.append(m(is_jal, sub(rdv[0], RL)))
        c.append(m(is_jal, sub(rdv[1], RH)))
        c.append(m(is_jal, sub(add(pc, alg.const(4)),
                               add(RL, m(c16, RH26)))))
        # jalr: rdv = pc + 4, range-bound through b_bits (free on jalr rows:
        # bind_ab excludes jalr; the adder consumes op2 limbs, not bits).
        BL = alg.gweighted(b_blk, W_LO)
        BH26 = alg.gweighted(b_blk, W_HI26)
        c.append(m(is_jalr, sub(rdv[0], BL)))
        c.append(m(is_jalr, sub(rdv[1], BH26)))
        c.append(m(is_jalr, sub(add(pc, alg.const(4)), add(BL, m(c16, BH26)))))
        hi_mask = np.array([1 if i >= 26 else 0 for i in range(32)],
                           dtype=np.int64)
        c.append(VecVal(gm(B(is_jalr), gm(b_blk, alg.gconst(hi_mask)))))

        # auipc: rd = (pc + imm_u) mod 2^32 via 16-bit limb adds.
        # On auipc rows r_bits are free (bind_a/b, jal/jalr, addr_users
        # all exclude auipc) and hold the pc decomposition pc = RL +
        # 2^16*RH26 (hi bits zeroed by the address-structure constraint
        # below, which includes is_auipc); a_bits hold the result bits;
        # c0/c1 are the limb carries (c1, the 2^32 overflow, is
        # discarded).  Every limb sum < 2^17 < p, so the field identity
        # is the integer identity.  Reference semantics:
        # risc0 rv32im circuit AUIPC op (SURVEY.md §2.4).
        AL = alg.gweighted(a_blk, W_LO)
        AH = alg.gweighted(a_blk, W_HI)
        c.append(m(is_auipc, sub(pc, add(RL, m(c16, RH26)))))
        c.append(m(is_auipc, sub(add(RL, imm_lo), add(AL, m(c0b, c16)))))
        c.append(m(is_auipc, sub(add(add(RH26, imm_hi), c0b),
                                 add(AH, m(c1b, c16)))))
        c.append(m(is_auipc, sub(rdv[0], AL)))
        c.append(m(is_auipc, sub(rdv[1], AH)))

        def byte_of(blk, j):
            w = np.zeros(32, dtype=np.int64)
            w[8 * j : 8 * j + 8] = [1 << i for i in range(8)]
            return alg.gweighted(blk, w)

        if self.with_m:
            # ---- M extension (full: MUL/MULH/MULHSU/MULHU/DIV/DIVU/REM/REMU) ----
            # 8x8-bit byte products with an 11-bit carry chain: every column
            # sum < 2^18 < p, so the integer identity cannot wrap mod p.
            # The RV32I variant (self.with_m == False) has no M columns: the
            # whole family is absent and is_m is pinned to zero, so M-bearing
            # executions are unprovable under it (the prover picks the
            # variant per program; both lift programs are in the recursion
            # allowed set).
            hi_blk = d.datab(DC.m_hi_bits) if self.with_m else None

            A = [byte_of(a_blk, j) for j in range(4)]
            Bb = [byte_of(b_blk, j) for j in range(4)]
            Rb = ([byte_of(r_blk, j) for j in range(4)]
                  + [byte_of(hi_blk, j) for j in range(4)])
            carry_blk = d.datab(DC.m_carry_bits)

            def carry_of(k):  # k in 1..7
                w = np.zeros(77, dtype=np.int64)
                w[11 * (k - 1) : 11 * k] = [1 << i for i in range(11)]
                return alg.gweighted(carry_blk, w)

            carries = [alg.zero()] + [carry_of(k) for k in range(1, 8)]
            c256 = alg.const(256)
            for k in range(7):
                ck = dsum([m(A[i], Bb[k - i])
                           for i in range(max(0, k - 3), min(4, k + 1))])
                c.append(m(is_m, sub(add(ck, carries[k]),
                                     add(Rb[k], m(c256, carries[k + 1])))))
            c.append(m(is_m, sub(carries[7], Rb[7])))
            # MUL (lo) / MULHU (hi) results
            HL = alg.gweighted(hi_blk, W_LO)
            HH = alg.gweighted(hi_blk, W_HI)
            c.append(m(m(is_m, f3[0]), sub(rdv[0], RL)))
            c.append(m(m(is_m, f3[0]), sub(rdv[1], RH)))
            c.append(m(m(is_m, f3[3]), sub(rdv[0], HL)))
            c.append(m(m(is_m, f3[3]), sub(rdv[1], HH)))
            # DIVU/REMU: a_bits carry the quotient q; the product machinery
            # gives q*b in (r_bits, hi_bits); identity q*b + r == a, r < b.
            rem_blk = d.datab(DC.m_rem_bits)
            RemL = alg.gweighted(rem_blk, W_LO)
            RemH = alg.gweighted(rem_blk, W_HI)
            ca0 = d.data(DC.m_ca0)
            c.append(m(is_mdiv, sub(add(RL, RemL), add(rs1v[0], m(ca0, c16)))))
            c.append(m(is_mdiv, sub(add(add(RH, RemH), ca0), rs1v[1])))
            c.append(m(is_mdiv, HL))
            c.append(m(is_mdiv, HH))
            # divisor-zero flag via inverse gadget on (b0 + b1); shared by
            # the unsigned and signed division families
            bzero = d.data(DC.m_bzero)
            binv = d.data(DC.m_binv)
            sB = add(op2[0], op2[1])
            c.append(m(is_anydiv, m(bzero, sB)))
            c.append(m(is_anydiv, sub(add(bzero, m(sB, binv)), one)))
            # r < b (unless b == 0): r + d + 1 == b with 32-bit d
            d_blk = d.datab(DC.m_d_bits)
            DL_ = alg.gweighted(d_blk, W_LO)
            DH_ = alg.gweighted(d_blk, W_HI)
            cb = d.data(DC.m_cb)
            nz = m(is_mdiv, sub(one, bzero))
            c.append(m(nz, sub(add(add(RemL, DL_), one),
                               add(op2[0], m(cb, c16)))))
            c.append(m(nz, sub(add(add(RemH, DH_), cb), op2[1])))
            # DIVU result: q, or 2^32-1 when b == 0 (RISC-V spec)
            sel_divu = m(is_m, f3[5])
            QL = alg.gweighted(a_blk, W_LO)
            QH = alg.gweighted(a_blk, W_HI)
            c.append(m(sel_divu, sub(rdv[0], add(m(sub(one, bzero), QL),
                                                 m(bzero, cFFFF)))))
            c.append(m(sel_divu, sub(rdv[1], add(m(sub(one, bzero), QH),
                                                 m(bzero, cFFFF)))))
            # REMU result: r (covers b == 0, where the identity forces r == a)
            sel_remu = m(is_m, f3[7])
            c.append(m(sel_remu, sub(rdv[0], RemL)))
            c.append(m(sel_remu, sub(rdv[1], RemH)))

            # ---- signed M: MULH / MULHSU ----
            # two's-complement correction: the signed 64-bit product is
            # P - 2^32*(a31*b_u + b31*a_u) + 2^64*a31*b31, so the signed
            # high word is (H - a31*b_u - b31*a_u) mod 2^32.  The result
            # rides m_rem_bits (free on mul rows); the mod-2^32 wrap uses
            # small carries t0 (ca0+cb) and t1 (c0+c1), each forced into
            # {0..2} by the limb ranges (every sum < 3*2^16 << p).
            # Reference semantics: risc0 rv32im circuit MULH/MULHSU
            # (SURVEY.md §2.4).
            AL_m = alg.gweighted(a_blk, W_LO)
            AH_m = alg.gweighted(a_blk, W_HI)
            BL_m = alg.gweighted(b_blk, W_LO)
            BH_m = alg.gweighted(b_blk, W_HI)
            ca0_c = d.data(DC.m_ca0)
            cb_c = d.data(DC.m_cb)
            c0b_, c1b_ = c0b, c1b
            sel_mulh = m(is_m, f3[1])
            sel_mulhsu = m(is_m, f3[2])
            t0h = add(ca0_c, cb_c)
            t1h = add(c0b_, c1b_)
            c.append(m(sel_mulh, sub(add(add(m(a31, BL_m), m(b31, AL_m)), RemL),
                                     add(HL, m(c16, t0h)))))
            c.append(m(sel_mulh, sub(add(add(m(a31, BH_m), m(b31, AH_m)),
                                         add(RemH, t0h)),
                                     add(HH, m(c16, t1h)))))
            c.append(m(sel_mulh, sub(rdv[0], RemL)))
            c.append(m(sel_mulh, sub(rdv[1], RemH)))
            c.append(m(sel_mulhsu, sub(add(m(a31, BL_m), RemL),
                                       add(HL, m(c16, ca0_c)))))
            c.append(m(sel_mulhsu, sub(add(m(a31, BH_m), add(RemH, ca0_c)),
                                       add(HH, m(c16, c0b_)))))
            c.append(m(sel_mulhsu, sub(rdv[0], RemL)))
            c.append(m(sel_mulhsu, sub(rdv[1], RemH)))

            # ---- signed M: DIV / REM ----
            # a_bits carry the two's-complement quotient q_u, m_rem_bits the
            # remainder r_u, sh_oh the dividend's (rs1) bit decomposition
            # (the one-hot sum is gated off these rows).  The byte
            # multiplier above supplies P = q_u*b_u in full 64 bits; the
            # exact signed identity q_s*b_s + r_s = a_s is enforced mod
            # 2^64 via sign-correction limbs — sound because every
            # magnitude is < 2^63, so the congruence is integer equality.
            # Special cases per the RISC-V M spec: b == 0 -> q = -1, r = a
            # (identity then forces r = a; q forced below); overflow
            # (-2^31 / -1) -> q = -2^31, r = 0 via the committed o flag.
            # Reference semantics: risc0 rv32im circuit DIV/REM
            # (SURVEY.md §2.4).
            sbit = [d.data(DC.m_s_bits.start + i) for i in range(8)]
            G = d.data(DC.m_g)
            G2 = d.data(DC.m_g2)
            alpha = d.data(DC.sh_oh.start + 31)
            rho = d.data(DC.m_rem_bits.start + 31)
            o_flag = sbit[2]
            c.append(sub(G, m(selS, sub(one, o_flag))))
            c.append(sub(G2, m(selS, sub(one, bzero))))
            # dividend decomposition: sh_oh bits == rs1 (gives alpha = sign a)
            c.append(m(selS, sub(rs1v[0], alg.gweighted(sh_blk, W_LO))))
            c.append(m(selS, sub(rs1v[1], alg.gweighted(sh_blk, W_HI))))
            # low 32 bits: P_lo + r = a + 2^32*k, carries k0/k1
            k1s = d.data(DC.m_ca1)
            c.append(m(selS, sub(add(RL, RemL), add(rs1v[0], m(c16, ca0_c)))))
            c.append(m(selS, sub(add(add(RH, RemH), ca0_c),
                                 add(rs1v[1], m(c16, k1s)))))
            # high 32 bits, gated G = selS*(1-o):
            #   H + alpha + k1 + 2^32 = rho + corr + 2^32*e,
            #   corr = q31*b_u + b31*q_u  (q31 = a_bits[31] here)
            # limbed with s0 in {0..3} (c0 + 2*c1) and e in {0..2}
            Ucorr = add(m(a31, op2[0]), m(b31, AL_m))
            Vcorr = add(m(a31, op2[1]), m(b31, AH_m))
            s0s = add(c0b_, add(c1b_, c1b_))
            e_s = add(sbit[0], add(sbit[1], sbit[1]))
            c217 = alg.const(1 << 17)
            c.append(m(G, sub(add(add(HL, add(alpha, k1s)), c217),
                              add(add(rho, Ucorr), m(c16, s0s)))))
            c.append(m(G, sub(add(add(HH, s0s), c16),
                              add(add(Vcorr, two), m(c16, e_s)))))
            # sign(r) == sign(a) unless r == 0
            c.append(m(selS, m(sub(alpha, rho), RemL)))
            c.append(m(selS, m(sub(alpha, rho), RemH)))
            # b == 0 forces q = -1 (all 32 quotient bits set)
            c32_ = alg.const(32)
            c.append(m(selS, m(bzero, sub(c32_, alg.gsum(a_blk)))))
            # o == 1 forces a == -2^31, b == -1, q == -2^31, r == 0
            low31 = np.array([1 if i < 31 else 0 for i in range(32)],
                             dtype=np.int64)
            sh_low31 = alg.gweighted(sh_blk, low31)
            a_low31 = alg.gweighted(a_blk, low31)
            c.append(m(selS, m(o_flag, add(sh_low31, sub(one, alpha)))))
            c.append(m(selS, m(o_flag, sub(c32_, alg.gsum(b_blk)))))
            c.append(m(selS, m(o_flag, add(a_low31, sub(one, a31)))))
            c.append(m(selS, m(o_flag, add(RemL, RemH))))
            # |r| < |b| when b != 0, by sign case (rho, b31); slack D rides
            # m_d_bits, carries ride s_bits[3..5)
            cA, cB = sbit[3], sbit[4]
            n_rho, n_tau = sub(one, rho), sub(one, b31)
            case00 = m(n_rho, n_tau)  # r >= 0, b > 0:  r + 1 + D = b
            case01 = m(n_rho, b31)    # r >= 0, b < 0:  r + b + 1 + D = 2^32
            case10 = m(rho, n_tau)    # r < 0,  b > 0:  r + b = 2^32 + 1 + D
            case11 = m(rho, b31)      # r < 0,  b < 0:  b + 1 + D = r
            c.append(m(G2, m(case00, sub(add(add(RemL, one), DL_),
                                         add(op2[0], m(c16, cA))))))
            c.append(m(G2, m(case00, sub(add(add(RemH, DH_), cA), op2[1]))))
            c.append(m(G2, m(case01, sub(add(add(add(RemL, op2[0]), one), DL_),
                                         m(c16, add(one, cA))))))
            c.append(m(G2, m(case01, sub(add(add(add(RemH, op2[1]), DH_),
                                             add(one, cA)),
                                         c16))))
            g0p = add(cA, add(cB, cB))
            c.append(m(G2, m(case10, sub(add(add(RemL, op2[0]), c16),
                                         add(add(one, DL_), m(c16, g0p))))))
            c.append(m(G2, m(case10, sub(add(add(RemH, op2[1]), g0p),
                                         add(add(DH_, c16), one)))))
            c.append(m(G2, m(case11, sub(add(add(op2[0], one), DL_),
                                         add(RemL, m(c16, cA))))))
            c.append(m(G2, m(case11, sub(add(add(op2[1], DH_), cA), RemH))))
            # DIV result: q; REM result: r (both cover the special cases)
            sel_div = m(is_m, f3[4])
            sel_rem = m(is_m, f3[6])
            c.append(m(sel_div, sub(rdv[0], AL_m)))
            c.append(m(sel_div, sub(rdv[1], AH_m)))
            c.append(m(sel_rem, sub(rdv[0], RemL)))
            c.append(m(sel_rem, sub(rdv[1], RemH)))

        else:
            # no M machinery: executed instructions must not
            # be M-extension ops (fetch binds is_m to t_mext)
            c.append(is_m)

        # ---- address structure ----
        addr_users = dsum([is_jalr, is_load, is_store])
        hi_gate = dsum([addr_users, is_jal, is_auipc]
                       + ([d.data(dc.k_kec)] if self.with_m else []))
        c.append(VecVal(gm(B(hi_gate), gm(r_blk, alg.gconst(hi_mask)))))
        # alignment by access width (f3: 0=b 1=h 2=w 4=bu 5=hu):
        # jalr/word -> 4-aligned, half -> 2-aligned, byte -> free
        is_word = m(add(is_load, is_store), f3[2])
        is_half = add(m(is_load, add(f3[1], f3[5])), m(is_store, f3[1]))
        c.append(m(dsum([is_jalr, is_word, is_half]),
                   d.data(DC.r_bits.start)))
        c.append(m(add(is_jalr, is_word), d.data(DC.r_bits.start + 1)))
        # no undefined width classes
        c.append(m(is_load, dsum([f3[3], f3[6], f3[7]])))
        c.append(m(is_store, dsum([f3[3], f3[4], f3[5], f3[6], f3[7]])))
        ADDR_BYTES = add(RL, m(c16, RH26))

        # ---- loads/stores: word plumbing + sub-word extraction/merge ----
        # Loads put the fetched word in b_bits; stores put the (merged)
        # stored word in a_bits (both blocks are free on these rows).
        # The mem LogUp port reads those blocks (see _ports), so the
        # sorted-log consistency argument works at word granularity for
        # every width; sub-word stores additionally read the old word
        # through the mem2 port at time 2*clk (write at 2*clk + 1).
        # sh_oh doubles as the byte-offset one-hot, bound to the low
        # address bits for every load/store (offset 0 for word ops).
        addr_low = add(d.data(DC.r_bits.start),
                       add(d.data(DC.r_bits.start + 1),
                           d.data(DC.r_bits.start + 1)))
        c.append(m(add(is_load, is_store), sub(sh_idx, addr_low)))
        shs = [d.data(DC.sh_oh.start + j) for j in range(4)]
        BH = alg.gweighted(b_blk, W_HI)
        is_lw = m(is_load, f3[2])
        is_sw = m(is_store, f3[2])
        c.append(m(is_lw, sub(rdv[0], BL)))
        c.append(m(is_lw, sub(rdv[1], BH)))
        c.append(m(is_sw, sub(AL, rs2v[0])))
        c.append(m(is_sw, sub(AH, rs2v[1])))
        bbytes = [byte_of(b_blk, j) for j in range(4)]
        abytes = [byte_of(a_blk, j) for j in range(4)]
        selbyte_b = dsum([m(s_, v) for s_, v in zip(shs, bbytes)])
        sbit_b = dsum([m(s_, d.data(DC.b_bits.start + 8 * j + 7))
                       for j, s_ in enumerate(shs)])
        is_lb = m(is_load, f3[0])
        is_lbu = m(is_load, f3[4])
        cFF00 = alg.const(0xFF00)
        c.append(m(is_lbu, sub(rdv[0], selbyte_b)))
        c.append(m(is_lbu, rdv[1]))
        c.append(m(is_lb, sub(rdv[0], add(selbyte_b, m(cFF00, sbit_b)))))
        c.append(m(is_lb, sub(rdv[1], m(cFFFF, sbit_b))))
        is_lh = m(is_load, f3[1])
        is_lhu = m(is_load, f3[5])
        selhalf_b = add(m(shs[0], BL), m(shs[2], BH))
        hbit_b = add(m(shs[0], d.data(DC.b_bits.start + 15)),
                     m(shs[2], d.data(DC.b_bits.start + 31)))
        c.append(m(is_lhu, sub(rdv[0], selhalf_b)))
        c.append(m(is_lhu, rdv[1]))
        c.append(m(is_lh, sub(rdv[0], selhalf_b)))
        c.append(m(is_lh, sub(rdv[1], m(cFFFF, hbit_b))))
        # SB: unselected bytes preserved; selected byte = rs2 low byte
        # (rs2v[0] = sel_byte + 256*Q8, Q8 an 8-bit witness block)
        is_sb = m(is_store, f3[0])
        is_sh = m(is_store, f3[1])
        for j in range(4):
            c.append(m(is_sb, m(sub(one, shs[j]),
                                sub(abytes[j], bbytes[j]))))
        q8_idx = list(range(dc.q8.start, dc.q8.stop))
        Q8 = alg.gweighted(d.datab(q8_idx),
                           np.array([1 << i for i in range(8)],
                                    dtype=np.int64))
        selbyte_a = dsum([m(s_, v) for s_, v in zip(shs, abytes)])
        c.append(m(is_sb, sub(rs2v[0], add(selbyte_a,
                                           m(alg.const(256), Q8)))))
        # SH: unselected half preserved; selected half = rs2 low limb
        c.append(m(is_sh, m(shs[0], sub(AH, BH))))
        c.append(m(is_sh, m(shs[2], sub(AL, BL))))
        c.append(m(is_sh, sub(rs2v[0], add(m(shs[0], AL),
                                           m(shs[2], AH)))))

        # ---- pc transition ----
        pc4 = add(pc, alg.const(4))
        pc_imm = add(pc, imm_field)
        if self.with_m:
            # keccak burst rows hold pc until the last burst row
            ecall_pc = add(m(sub(is_ecall, d.data(dc.k_kec)), pc4),
                           m(d.data(dc.k_kec),
                             add(m(d.data(dc.kec_last), pc4),
                                 m(sub(one, d.data(dc.kec_last)), pc))))
        else:
            ecall_pc = m(is_ecall, pc4)
        pc_next = dsum([
            m(is_jal, pc_imm),
            m(is_jalr, ADDR_BYTES),
            m(is_br, add(m(taken, pc_imm), m(sub(one, taken), pc4))),
            m(dsum([is_lui, is_auipc, is_load, is_store, is_alui,
                    is_alur]),
              pc4),
            ecall_pc,
        ])
        pc_n = nx.data(DC.pc)
        c.append_t(m(not_last, sub(pc_n, add(m(active, pc_next),
                                             m(sub(one, active), pc)))))

        # ---- register transitions (grouped per limb over 32 regs) ----
        wen = dsum([is_lui, is_auipc, is_jal, is_jalr, is_load, is_alui,
                    is_alur])
        e10 = np.zeros(32, dtype=np.int64)
        e10[10] = 1
        not0 = np.ones(32, dtype=np.int64)
        not0[0] = 0
        w_oh = ga(gm(B(wen), rd_blk), gm(B(k_read), alg.gconst(e10)))
        w_oh = gm(w_oh, alg.gconst(not0))  # never write x0
        nxt_lo = nx.datab(reg_lo_idx)
        nxt_hi = nx.datab(reg_hi_idx)
        for limb, (now_l, nxt_l) in ((0, (regs_lo, nxt_lo)),
                                     (1, (regs_hi, nxt_hi))):
            delta_w = gm(w_oh, gs(B(rdv[limb]), now_l))
            c.append_t(VecVal(gm(B(not_last),
                                 gs(nxt_l, ga(now_l,
                                              gm(B(active), delta_w))))))

        # ---- ecall kind binding (t0 = reg 5) ----
        kind_val = alg.gweighted(d.datab(DC.k), np.arange(5))
        if self.with_m:
            # KECCAK = 5: one-hot sum == is_ecall makes k_kec the only
            # way to reach kind 5, so keccak ecall rows are FORCED into
            # the burst machinery (and vice versa).
            kind_val = add(kind_val, m(alg.const(5), d.data(dc.k_kec)))
        c.append(m(is_ecall, sub(reg(5, 0), kind_val)))
        c.append(m(is_ecall, reg(5, 1)))

        if self.with_m:
            # ---- keccak burst structure ----
            kb = d.data(dc.k_kec)
            cnt = d.data(dc.kec_cnt)
            last = d.data(dc.kec_last)
            linv = d.data(dc.kec_linv)
            kb_n = nx.data(dc.k_kec)
            cnt_n = nx.data(dc.kec_cnt)
            # last == (cnt == 49), forced both ways by the iszero gadget
            d49 = sub(cnt, alg.const(49))
            c.append(m(kb, m(last, d49)))
            c.append(m(kb, sub(add(last, m(d49, linv)), one)))
            # mid-burst rows continue: next row is a burst row with
            # cnt + 1; any fresh burst row starts at cnt == 0
            mid = m(kb, sub(one, last))
            c.append_t(m(not_last, m(mid, sub(kb_n, one))))
            c.append_t(m(not_last,
                         m(kb_n, sub(cnt_n, m(mid, add(cnt, one))))))
            # a burst cannot straddle the segment boundary
            c.append_t(m(is_last, mid))
            # r_bits carry a0's full 32-bit decomposition (word-aligned,
            # < 2^26 via the address-structure gate below)
            c.append(m(kb, sub(reg(10, 0), RL)))
            c.append(m(kb, sub(reg(10, 1), RH)))
            c.append(m(kb, d.data(DC.r_bits.start)))
            c.append(m(kb, d.data(DC.r_bits.start + 1)))

        # ---- seq counters / halt / active ----
        for seq_col, kk in ((DC.commit_seq, k_commit), (DC.read_seq, k_read),
                            (DC.verify_seq, k_verify)):
            c.append_t(m(not_last, sub(nx.data(seq_col),
                                       add(d.data(seq_col),
                                           m(active, kk)))))
        if self.with_m:
            # cpio entry counter: +2 per burst row (in + out words)
            c.append_t(m(not_last, sub(nx.data(dc.cp_seq),
                                       add(d.data(dc.cp_seq),
                                           add(kb, kb)))))
        c.append_t(m(not_last, sub(nx.data(DC.halted),
                                   add(halted, m(active, k_halt)))))
        c.append(m(halted, active))
        c.append_t(m(not_last, m(nx.data(DC.active), sub(one, active))))
        c.append_t(m(is_first, halted))

        # ---- sorted memory log ----
        s_active = d.data(DC.s_active)
        s_active_n = nx.data(DC.s_active)
        s_w_n = nx.data(DC.s_is_write)
        s_new = d.data(DC.s_new)
        s_new_n = nx.data(DC.s_new)
        s_addr, s_addr_n = d.data(DC.s_addr), nx.data(DC.s_addr)
        s_clk, s_clk_n = d.data(DC.s_clk), nx.data(DC.s_clk)
        s_val = [d.data(DC.s_val.start + i) for i in range(2)]
        s_val_n = [nx.data(DC.s_val.start + i) for i in range(2)]
        dd = add(m(s_new_n, sub(s_addr_n, s_addr)),
                 m(sub(one, s_new_n), sub(s_clk_n, s_clk)))
        dsum_bits = alg.gweighted(
            nx.datab(DC.s_dbits),
            np.array([1 << i for i in range(26)], dtype=np.int64))
        # Gate on s_active_n alone: the prefix constraint below
        # (s_active_n * (1 - s_active) == 0) already forces "next active
        # => current active", so including s_active here is redundant —
        # and it pushed the read-consistency constraint to degree 6,
        # aliasing on the rate-1/4 LDE (caught by air/degree.py; any
        # guest with a non-empty, non-full memory log failed to verify).
        gate = m(not_last, s_active_n)
        c.append_t(m(gate, sub(sub(dd, one), dsum_bits)))
        c.append_t(m(gate, m(sub(one, s_new_n), sub(s_addr_n, s_addr))))
        for limb in range(2):
            c.append_t(m(gate, m(sub(one, s_w_n),
                                 m(sub(one, s_new_n),
                                   sub(s_val_n[limb], s_val[limb])))))
        c.append_t(m(not_last, m(s_active_n, sub(one, s_active))))
        c.append_t(m(is_first, m(s_active, sub(s_new, one))))

        # ---- paging port bindings ----
        # first READ of an address must see its segment-entry value
        # (first writes leave s_pre_val free: the lift program binds it
        # to the pre-memory PageTree root via the page walk)
        s_w = d.data(DC.s_is_write)
        s_pre = [d.data(DC.s_pre_val.start + i) for i in range(2)]
        for limb in range(2):
            c.append(m(m(s_active, s_new),
                       m(sub(one, s_w), sub(s_val[limb], s_pre[limb]))))
        # s_last == s_active * (next inactive ? 1 : s_new_next); split form
        # keeps the value boolean even if a prover sets s_new on inactive
        # rows (s_new is unconstrained there)
        s_last_c = d.data(DC.s_last)
        c.append_t(m(not_last, sub(s_last_c,
                                   m(s_active, add(m(s_active_n, s_new_n),
                                                   sub(one, s_active_n))))))
        c.append_t(m(is_last, sub(s_last_c, s_active)))

        # ---- LogUp ports: inv * pack == sel ----
        ac = self.ac
        packs, sels = _ports(alg, d, gamma, dpows, dc)
        for port in ac.PORTS:
            inv = alg.read_ext(now.accum, ac.inv[port])
            c.append(ExtVal(alg.esub(alg.emul(inv, packs[port]),
                                     alg.lift(sels[port]))))

        # ---- running sum transition + boundaries ----
        def signed_total(accum_accessor):
            acc = None
            for port in ac.PORTS:
                iv = alg.read_ext(accum_accessor, ac.inv[port])
                if ac.SIGNS[port] < 0:
                    iv = alg.eneg(iv)
                acc = iv if acc is None else alg.eadd(acc, iv)
            return acc

        R_now = alg.read_ext(now.accum, ac.running)
        R_nxt = alg.read_ext(nxt.accum, ac.running)
        t_now = signed_total(now.accum)
        t_next = signed_total(nxt.accum)
        c.append_t(ExtVal(alg.escale(
            alg.esub(alg.esub(R_nxt, R_now), t_next), not_last)))
        c.append_t(ExtVal(alg.escale(alg.esub(R_now, t_now), is_first)))
        if getattr(alg, "is_prog", False):
            s_pub = _public_logup_sum_prog(alg, pub, gamma, delta)
        elif getattr(alg, "s_pub_const", None) is not None:
            # the degree algebra has no field values
            s_pub = alg.s_pub_const
        else:
            s_pub = public_logup_sum(pub, gamma, delta)
        c.append_t(ExtVal(alg.escale(
            alg.esub(R_now, alg.bc(s_pub, R_now)), is_last)))

        # ---- multiplicities only on active table rows ----
        t_act = d.ctrl(CC.t_active)
        c.append(m(d.data(DC.mult_fetch), sub(one, t_act)))

        # ---- claim boundaries (grouped over all 64 reg limbs) ----
        regs_full = d.datab(slice(DC.regs.start, DC.regs.stop))
        c.append_t(VecVal(gm(B(is_first),
                             gs(regs_full, alg.gpub(pub.pre_regs)))))
        c.append_t(VecVal(gm(B(is_last),
                             gs(regs_full, alg.gpub(pub.post_regs)))))
        c.append_t(m(is_first, sub(pc, alg.pubval(pub.pre_pc))))
        c.append_t(m(is_last, sub(pc, alg.pubval(pub.post_pc))))
        c.append_t(m(is_last, sub(halted, alg.pubval(pub.halted))))
        seq_binds = [(DC.commit_seq, k_commit), (DC.read_seq, k_read),
                     (DC.verify_seq, k_verify)]
        if self.with_m:
            kb_ = d.data(dc.k_kec)
            seq_binds.append((dc.cp_seq, add(kb_, kb_)))
        for i, (seq_col, kk) in enumerate(seq_binds):
            s_now = d.data(seq_col)
            c.append_t(m(is_first, sub(s_now, alg.pubval(pub.pre_seqs[i]))))
            c.append_t(m(is_last, sub(add(s_now, m(active, kk)),
                                      alg.pubval(pub.post_seqs[i]))))
        self._zclass = list(c.zclass)
        return c
