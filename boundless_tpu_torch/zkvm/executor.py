"""rv32im executor: cycle-accurate interpreter with segmentation.

Counterpart of the upstream prover's `ExecutorImpl::run_with_callback`
host loop (upstream `prover/crates/workflow/src/tasks/executor.rs:721-786`):
runs the guest, counts cycles, cuts the execution into 2^po2-cycle segments
(continuations), records the per-segment witness needed by the segment
prover, and implements the guest<->host ABI (journal commit, input reads,
assumption verification for composition).

Guest ABI (our own, documented — guests are assembled in-repo, see asm.py).
I/O is **word-granular** so the circuit can bind it to public word tables
without in-circuit hashing (see air/rv32im.py):
  ecall with t0 =
    0 HALT        a0 = exit code (journal finalized)
    1 COMMIT      a0 = 32-bit word appended to the journal
    2 READ        a0 <- next input word (input is a u32-word stream;
                  reading past the end is a guest fault — by convention
                  input[0] carries the payload word count)
    3 LOG         a0 = ptr, a1 = len   host log bytes (debug only;
                  unconstrained in-circuit)
    4 VERIFY      a0 = one word of an assumption claim digest (8 calls
                  push a full digest; composition — resolved at the
                  resolve stage, SURVEY §3.1)
    5 KECCAK      a0 = ptr to a 50-word (25 x u64 LE) state: host applies
                  keccak-f[1600] in place and records a coprocessor claim
                  (proved by the coproc stream's keccak circuit + union
                  tree — reference tasks/{keccak,union}.rs; circuit staged)
  Every ecall costs 1 cycle.

The port's own copy of `boundless_tpu/zkvm/executor.py`: the same data
classes, keccak-f[1600] and interpreter, with every lazy import pointed at
this package (the blinded-tail size and paging budgets of `air/rv32im.py`,
the keccak claim digest of `core/poseidon2_np.py`, the g++/ctypes loader
of `native/`), so nothing of the JAX package is ever reached.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Optional

import numpy as np

from . import isa

HALT, COMMIT, READ, LOG, VERIFY, KECCAK = range(6)

# keccak-f[1600] round constants / rotations (FIPS 202)
_KECCAK_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_KECCAK_ROT = [
    [0, 36, 3, 41, 18], [1, 44, 10, 45, 2], [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56], [27, 20, 39, 8, 14],
]
_M64 = (1 << 64) - 1


def keccak_f1600(state):
    """keccak-f[1600] on a 25-int state (x + 5y indexing), pure Python."""
    a = list(state)
    for rc in _KECCAK_RC:
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ (((c[(x + 1) % 5] << 1)
                               | (c[(x + 1) % 5] >> 63)) & _M64)
             for x in range(5)]
        a = [(a[i] ^ d[i % 5]) for i in range(25)]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                r = _KECCAK_ROT[x][y]
                v = a[x + 5 * y]
                b[y + 5 * ((2 * x + 3 * y) % 5)] = \
                    ((v << r) | (v >> (64 - r))) & _M64
        # chi
        a = [b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) & _M64
                             & b[(x + 2) % 5 + 5 * y])
             for y in range(5) for x in range(5)]
        # iota
        a[0] ^= rc
    return a

M32 = 0xFFFFFFFF


class _PageBudgetStop(Exception):
    """Internal: segment page budget reached; flush and re-execute."""


class GuestFault(Exception):
    pass


@dataclasses.dataclass
class MemoryImage:
    """Program image: sparse word memory + entry point."""

    words: dict  # addr -> u32 (word-aligned addresses)
    entry: int

    @staticmethod
    def from_words(words, base: int = 0x1000, entry: Optional[int] = None):
        mem = {base + 4 * i: w & M32 for i, w in enumerate(words)}
        return MemoryImage(words=mem, entry=entry if entry is not None else base)

    def image_id(self) -> bytes:
        """Canonical digest binding the program (role of risc0's image ID)."""
        h = hashlib.sha256()
        h.update(b"boundless-tpu.image.v1")
        h.update(self.entry.to_bytes(4, "little"))
        for addr in sorted(self.words):
            h.update(addr.to_bytes(4, "little"))
            h.update(self.words[addr].to_bytes(4, "little"))
        return h.digest()


@dataclasses.dataclass
class Segment:
    """One continuation segment: everything needed to prove it in isolation."""

    index: int
    po2: int
    pre_pc: int
    pre_regs: np.ndarray  # (32,) u32
    pre_mem: dict  # full word store (addr&~3 -> u32) at segment start
    cycles: int  # actual user cycles executed in this segment
    # I/O interactions consumed during this segment (for witness re-run):
    reads: list  # input words returned by READ during the segment
    pre_seqs: dict  # session commit/read/verify counters at segment start
    is_final: bool
    image_id: bytes
    # cross-segment RAM continuity (paging.py): 64-word pages touched by
    # load/store in this segment, and the full word store at segment end
    touched_pages: list = None
    post_mem: dict = None
    # keccak permutations executed in this segment (each is a 50-row
    # burst with public cpio entries; forces the rv32im AIR variant)
    kec_perms: int = 0


@dataclasses.dataclass
class SessionResult:
    segments: list
    journal: bytes
    exit_code: int
    total_cycles: int
    assumptions: list  # list of 32-byte claim digests from VERIFY ecalls
    log: bytes
    image_id: bytes


def keccak_perm_digest(pre_lanes, post_lanes) -> bytes:
    """Canonical 32-byte claim digest of one permutation: Poseidon2 of
    the 200 concatenated 16-bit limbs (pre state || post state) — the
    digest the keccak circuit's public table re-derives (air/keccak.py).
    """
    from ..core import poseidon2_np as P2NP

    limbs = [((int(v) >> (16 * s)) & 0xFFFF)
             for v in pre_lanes for s in range(4)]
    limbs += [((int(v) >> (16 * s)) & 0xFFFF)
              for v in post_lanes for s in range(4)]
    digest = P2NP.hash_elems_np(limbs)
    return b"".join(int(w).to_bytes(4, "little") for w in digest)


def _signed(v):
    return v - (1 << 32) if v & 0x80000000 else v


def fast_execute(image: "MemoryImage", input_bytes: bytes = b"",
                 max_cycles: int = 1 << 36):
    """Native exec-only run (C++ full-RV32IM interpreter): the preflight
    hot path (reference PreflightLayer / pricing). Returns
    (total_cycles, exit_code, journal_bytes). Faults raise GuestFault.
    """
    import ctypes

    from .. import native

    lib = native.executor_lib()
    items = sorted(image.words.items())
    addrs = np.array([a for a, _ in items], dtype=np.uint32)
    words_arr = np.array([w for _, w in items], dtype=np.uint32)
    inputs = np.array(
        [int.from_bytes(input_bytes[i : i + 4].ljust(4, b"\0"), "little")
         for i in range(0, len(input_bytes), 4)], dtype=np.uint32)
    journal_cap = 1 << 20
    journal = np.zeros(journal_cap, dtype=np.uint32)
    total = np.zeros(1, dtype=np.uint64)
    exit_code = np.zeros(1, dtype=np.int32)
    jlen = np.zeros(1, dtype=np.int32)
    err = ctypes.create_string_buffer(256)
    rc = lib.bt_execute(
        addrs.ctypes.data_as(ctypes.c_void_p),
        words_arr.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(len(items)), ctypes.c_uint32(image.entry),
        inputs.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(len(inputs)),
        ctypes.c_uint64(max_cycles),
        total.ctypes.data_as(ctypes.c_void_p),
        exit_code.ctypes.data_as(ctypes.c_void_p),
        journal.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(journal_cap),
        jlen.ctypes.data_as(ctypes.c_void_p), err, ctypes.c_int(256))
    if rc != 0:
        raise GuestFault(err.value.decode() or "native execution failed")
    journal_bytes = b"".join(int(w).to_bytes(4, "little")
                             for w in journal[: int(jlen[0])])
    return int(total[0]), int(exit_code[0]), journal_bytes


class Executor:
    """Functional rv32im interpreter with continuation segmentation."""

    def __init__(self, image: MemoryImage, input_bytes: bytes = b"",
                 segment_po2: int = 14, max_cycles: int = 1 << 36):
        self.image = image
        self.mem = dict(image.words)
        self.regs = np.zeros(32, dtype=np.uint64)
        self.pc = image.entry
        self.input_words = [
            int.from_bytes(input_bytes[i : i + 4].ljust(4, b"\0"), "little")
            for i in range(0, len(input_bytes), 4)]
        self.input_pos = 0
        self.journal_words = []
        self.verify_words = []
        self.log = bytearray()
        self.assumptions = []
        self.keccak_claims = []  # 32-byte claim digest per permutation
        self.keccak_states = []  # input lanes per permutation (prover feed)
        self.cp_entries = 0  # session cpio ENTRY counter (100 per perm)
        self._seg_cycles = 0
        self._seg_cp_entries = 0
        self._ecall_cost = 1
        self.segment_po2 = segment_po2
        # Reserve the blinded zk tail (air/rv32im.zk_rows) plus a few
        # control rows: instruction rows AND the sorted memory log must
        # both fit in the real region.
        from ..air.rv32im import zk_rows

        self._zk = zk_rows(segment_po2)
        self.segment_limit = (1 << segment_po2) - self._zk - 4
        # Sorted-log budget: every memory access is one log row (sub-word
        # stores two). _touch conservatively charges 2 per access, so
        # memory-heavy segments flush before the log could overflow the
        # real region.
        self.mem_op_budget = (1 << segment_po2) - self._zk - 8
        self.mem_op_count = 0
        self.max_cycles = max_cycles
        self.exit_code = None
        self.touched_words = set()  # byte-aligned word addrs, per segment
        self.touched_pages = set()  # 64-word page indices, per segment

    # --- memory helpers (byte-addressed API over word store) ---
    def _load_word(self, addr):
        return self.mem.get(addr & ~3, 0)

    def _store_word(self, addr, value):
        self.mem[addr & ~3] = value & M32

    def _touch(self, addr):
        if self.mem_op_count + 2 > self.mem_op_budget:
            # Raised BEFORE any state mutation (same discipline as the
            # page-budget stop below): the segment flushes cleanly.
            raise _PageBudgetStop()
        self.mem_op_count += 2
        pg = (addr >> 2) // 64
        if pg not in self.touched_pages:
            from ..air.rv32im import MEM_PAGES

            if len(self.touched_pages) >= MEM_PAGES:
                # Raised BEFORE any machine-state mutation of the current
                # instruction (loads/stores precede reg/pc/io updates in
                # step/_ecall), so the segment flushes cleanly and the
                # instruction re-executes in the next segment.
                raise _PageBudgetStop()
            self.touched_pages.add(pg)
        self.touched_words.add(addr & ~3)

    def load(self, addr, size, signed):
        self._touch(addr)
        w = self._load_word(addr)
        sh = (addr & 3) * 8
        if size == 1:
            v = (w >> sh) & 0xFF
            return (isa.sign_extend(v, 8) & M32) if signed else v
        if size == 2:
            if addr & 1:
                raise GuestFault(f"misaligned halfword load at {addr:#x}")
            v = (w >> sh) & 0xFFFF
            return (isa.sign_extend(v, 16) & M32) if signed else v
        if addr & 3:
            raise GuestFault(f"misaligned word load at {addr:#x}")
        return w

    def store(self, addr, size, value):
        self._touch(addr)
        if size == 4:
            if addr & 3:
                raise GuestFault(f"misaligned word store at {addr:#x}")
            self._store_word(addr, value)
            return
        w = self._load_word(addr)
        sh = (addr & 3) * 8
        if size == 2 and (addr & 1):
            raise GuestFault(f"misaligned halfword store at {addr:#x}")
        mask = ((1 << (8 * size)) - 1) << sh
        self._store_word(addr, (w & ~mask) | ((value << sh) & mask))

    def read_bytes(self, ptr, length):
        return bytes(self.load(ptr + i, 1, False) for i in range(length))

    # --- main loop ---
    def run(self, native: Optional[bool] = None) -> SessionResult:
        """Execute to completion, cutting segments.

        `native=True` drives the C++ per-segment interpreter
        (native/executor.cpp bt_run_segment — the cycle-hot half; ~100x
        the Python loop, required for multi-Mcycle guests like the
        ECDSA assessor). Default: native when available, Python
        fallback. Both paths are bit-identical (diffed in tests).
        """
        if native is None:
            native = os.environ.get("BT_NATIVE_EXEC", "1") == "1"
        if native:
            try:
                return self._run_native()
            except GuestFault:
                raise
            except Exception:  # noqa: BLE001 — toolchain/load issues only
                pass
        segments = []
        total = 0
        while self.exit_code is None:
            seg = self._run_segment(len(segments))
            segments.append(seg)
            total += seg.cycles
            if total > self.max_cycles:
                raise GuestFault("session cycle limit exceeded")
        journal = b"".join(w.to_bytes(4, "little") for w in self.journal_words)
        return SessionResult(
            segments=segments, journal=journal,
            exit_code=self.exit_code, total_cycles=total,
            assumptions=self.assumptions, log=bytes(self.log),
            image_id=self.image.image_id())

    def _run_native(self) -> SessionResult:
        """C++ segment loop (bt_run_segment); session state stays here."""
        import ctypes

        from .. import native
        from ..air.rv32im import CP_IO, MEM_PAGES

        lib = native.executor_lib()
        inputs = np.asarray(self.input_words, dtype=np.uint32)
        input_pos = np.array([self.input_pos], dtype=np.int64)
        regs = np.ascontiguousarray(self.regs, dtype=np.uint32).copy()
        n = 1 << self.segment_po2
        rcap = jcap = vcap = n
        wcap = 2 * n + 64
        lcap = 1 << 16
        kcap = max(4, CP_IO // 100 + 1)
        reads_o = np.zeros(rcap, dtype=np.uint32)
        journal_o = np.zeros(jcap, dtype=np.uint32)
        verify_o = np.zeros(vcap, dtype=np.uint32)
        log_o = np.zeros(lcap, dtype=np.uint8)
        waddr_o = np.zeros(wcap, dtype=np.uint32)
        wval_o = np.zeros(wcap, dtype=np.uint32)
        kec_o = np.zeros(25 * kcap, dtype=np.uint64)
        tp_o = np.zeros(MEM_PAGES + 2, dtype=np.int64)
        outc = np.zeros(1, dtype=np.int64)
        post_pc = np.zeros(1, dtype=np.uint32)
        halted = np.zeros(1, dtype=np.int32)
        exit_code = np.zeros(1, dtype=np.int32)
        nr = np.zeros(1, dtype=np.int32)
        nj = np.zeros(1, dtype=np.int32)
        nv = np.zeros(1, dtype=np.int32)
        nl = np.zeros(1, dtype=np.int32)
        nw = np.zeros(1, dtype=np.int32)
        nk = np.zeros(1, dtype=np.int32)
        ntp = np.zeros(1, dtype=np.int32)
        err = ctypes.create_string_buffer(256)
        vp = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731

        segments = []
        total = 0
        while self.exit_code is None:
            pre_pc = self.pc
            pre_regs = regs.copy()
            pre_mem = dict(self.mem)
            pre_seqs = dict(commit=len(self.journal_words),
                            read=int(input_pos[0]),
                            verify=len(self.verify_words),
                            cpio=self.cp_entries)
            items = sorted(self.mem.items())
            maddr = np.array([a for a, _ in items], dtype=np.uint32)
            mval = np.array([v for _, v in items], dtype=np.uint32)
            rc = lib.bt_run_segment(
                vp(maddr), vp(mval), ctypes.c_int(len(items)),
                ctypes.c_uint32(self.pc), vp(regs),
                vp(inputs), ctypes.c_int(len(inputs)), vp(input_pos),
                ctypes.c_int64(self.segment_limit),
                ctypes.c_int64(self.mem_op_budget),
                ctypes.c_int(MEM_PAGES), ctypes.c_int(CP_IO),
                vp(outc), vp(post_pc), vp(halted), vp(exit_code),
                vp(reads_o), ctypes.c_int(rcap), vp(nr),
                vp(journal_o), ctypes.c_int(jcap), vp(nj),
                vp(verify_o), ctypes.c_int(vcap), vp(nv),
                vp(log_o), ctypes.c_int(lcap), vp(nl),
                vp(waddr_o), vp(wval_o), ctypes.c_int(wcap), vp(nw),
                vp(kec_o), ctypes.c_int(kcap), vp(nk),
                vp(tp_o), ctypes.c_int(tp_o.shape[0]), vp(ntp),
                err, ctypes.c_int(256))
            if rc != 0:
                raise GuestFault(err.value.decode()
                                 or "native segment execution failed")
            cycles = int(outc[0])
            # apply session effects
            for i in range(int(nj[0])):
                self.journal_words.append(int(journal_o[i]))
            for i in range(int(nv[0])):
                w = int(verify_o[i])
                self.verify_words.append(w)
                if len(self.verify_words) % 8 == 0:
                    self.assumptions.append(b"".join(
                        x.to_bytes(4, "little")
                        for x in self.verify_words[-8:]))
            self.log += bytes(log_o[: int(nl[0])])
            for i in range(int(nk[0])):
                pre_lanes = [int(x) for x in kec_o[25 * i : 25 * i + 25]]
                post = keccak_f1600(pre_lanes)
                self.keccak_states.append(pre_lanes)
                self.keccak_claims.append(
                    keccak_perm_digest(pre_lanes, post))
            self.cp_entries += 100 * int(nk[0])
            for i in range(int(nw[0])):
                self.mem[int(waddr_o[i])] = int(wval_o[i])
            self.pc = int(post_pc[0])
            if halted[0]:
                self.exit_code = int(exit_code[0])
            seg = Segment(
                index=len(segments), po2=self.segment_po2, pre_pc=pre_pc,
                pre_regs=pre_regs.astype(np.uint32), pre_mem=pre_mem,
                cycles=cycles,
                reads=[int(x) for x in reads_o[: int(nr[0])]],
                pre_seqs=pre_seqs, is_final=self.exit_code is not None,
                image_id=self.image.image_id(),
                touched_pages=sorted(int(x) for x in tp_o[: int(ntp[0])]),
                post_mem=dict(self.mem), kec_perms=int(nk[0]))
            segments.append(seg)
            total += cycles
            if total > self.max_cycles:
                raise GuestFault("session cycle limit exceeded")
        self.regs = regs.astype(np.uint64)
        self.input_pos = int(input_pos[0])
        journal = b"".join(w.to_bytes(4, "little")
                           for w in self.journal_words)
        return SessionResult(
            segments=segments, journal=journal,
            exit_code=self.exit_code, total_cycles=total,
            assumptions=self.assumptions, log=bytes(self.log),
            image_id=self.image.image_id())

    def _run_segment(self, index) -> Segment:
        pre_pc = self.pc
        pre_regs = self.regs.copy().astype(np.uint32)
        pre_mem = dict(self.mem)
        pre_seqs = dict(commit=len(self.journal_words), read=self.input_pos,
                        verify=len(self.verify_words),
                        cpio=self.cp_entries)
        pre_perms = len(self.keccak_claims)
        reads = []
        cycles = 0
        self.touched_words = set()
        self.touched_pages = set()
        self.mem_op_count = 0
        self._seg_cycles = 0
        self._seg_cp_entries = 0
        # A segment may touch at most MEM_PAGES 64-word pages (the paging
        # port's public budget, air/rv32im.py): an access that would
        # exceed the budget raises _PageBudgetStop before mutating state,
        # flushing the segment; the instruction re-runs in the next one
        # (the reference reaches the same end by charging page-in/out
        # cycles per segment).
        while cycles < self.segment_limit and self.exit_code is None:
            try:
                cost = self.step(reads)
            except _PageBudgetStop:
                break
            cycles += cost
            self._seg_cycles = cycles
        if cycles == 0:
            raise GuestFault("instruction exceeds the segment page budget")
        touched_pages = sorted(self.touched_pages)
        return Segment(index=index, po2=self.segment_po2, pre_pc=pre_pc,
                       pre_regs=pre_regs, pre_mem=pre_mem, cycles=cycles,
                       reads=reads, pre_seqs=pre_seqs,
                       is_final=self.exit_code is not None,
                       image_id=self.image.image_id(),
                       touched_pages=touched_pages,
                       post_mem=dict(self.mem),
                       kec_perms=len(self.keccak_claims) - pre_perms)

    def step(self, reads_log=None):
        """Execute one instruction. Returns its cycle cost (1, or 50 for
        a keccak-coprocessor burst — air/rv32im.py)."""
        self._ecall_cost = 1
        word = self._load_word(self.pc)
        if self.pc & 3:
            raise GuestFault(f"misaligned pc {self.pc:#x}")
        d = isa.decode(word)
        op = d["op"]
        regs = self.regs
        rs1 = int(regs[d["rs1"]]) & M32
        rs2 = int(regs[d["rs2"]]) & M32
        rd = d["rd"]
        next_pc = (self.pc + 4) & M32
        val = None

        if op == isa.OP_LUI:
            val = d["imm_u"]
        elif op == isa.OP_AUIPC:
            val = (self.pc + d["imm_u"]) & M32
        elif op == isa.OP_JAL:
            val = next_pc
            next_pc = (self.pc + d["imm_j"]) & M32
        elif op == isa.OP_JALR:
            val = next_pc
            next_pc = (rs1 + d["imm_i"]) & M32 & ~1
        elif op == isa.OP_BRANCH:
            taken = {
                0b000: rs1 == rs2, 0b001: rs1 != rs2,
                0b100: _signed(rs1) < _signed(rs2),
                0b101: _signed(rs1) >= _signed(rs2),
                0b110: rs1 < rs2, 0b111: rs1 >= rs2,
            }[d["f3"]]
            if taken:
                next_pc = (self.pc + d["imm_b"]) & M32
        elif op == isa.OP_LOAD:
            addr = (rs1 + d["imm_i"]) & M32
            size = {0b000: 1, 0b001: 2, 0b010: 4, 0b100: 1, 0b101: 2}[d["f3"]]
            signed = d["f3"] in (0b000, 0b001)
            val = self.load(addr, size, signed)
        elif op == isa.OP_STORE:
            addr = (rs1 + d["imm_s"]) & M32
            size = {0b000: 1, 0b001: 2, 0b010: 4}[d["f3"]]
            self.store(addr, size, rs2)
        elif op == isa.OP_IMM:
            val = self._alu(d["f3"], rs1, d["imm_i"] & M32,
                            (d["imm_i"] >> 5) & 0x7F if d["f3"] in (1, 5) else 0,
                            imm_mode=True)
        elif op == isa.OP_REG:
            val = self._alu(d["f3"], rs1, rs2, d["f7"], imm_mode=False)
        elif op == isa.OP_SYSTEM:
            self._ecall(reads_log)
        elif op == isa.OP_FENCE:
            pass
        else:
            raise GuestFault(f"illegal instruction {word:#010x} at pc {self.pc:#x}")

        if val is not None and rd != 0:
            regs[rd] = np.uint64(val & M32)
        self.pc = next_pc
        return self._ecall_cost

    def _alu(self, f3, a, b, f7, imm_mode):
        if f7 == 0b0000001 and not imm_mode:  # M extension
            sa, sb = _signed(a), _signed(b)
            if f3 == 0b000:
                return (a * b) & M32
            if f3 == 0b001:
                return ((sa * sb) >> 32) & M32
            if f3 == 0b010:
                return ((sa * b) >> 32) & M32
            if f3 == 0b011:
                return ((a * b) >> 32) & M32
            if f3 == 0b100:  # div
                if b == 0:
                    return M32
                if sa == -(1 << 31) and sb == -1:
                    return a
                return int(abs(sa) // abs(sb) * (1 if (sa < 0) == (sb < 0) else -1)) & M32
            if f3 == 0b101:  # divu
                return M32 if b == 0 else (a // b) & M32
            if f3 == 0b110:  # rem
                if b == 0:
                    return a
                if sa == -(1 << 31) and sb == -1:
                    return 0
                q = abs(sa) // abs(sb) * (1 if (sa < 0) == (sb < 0) else -1)
                return (sa - q * sb) & M32
            if f3 == 0b111:  # remu
                return a if b == 0 else (a % b) & M32
        sh = b & 0x1F
        if f3 == 0b000:
            if not imm_mode and f7 == 0b0100000:
                return (a - b) & M32
            return (a + b) & M32
        if f3 == 0b001:
            return (a << sh) & M32
        if f3 == 0b010:
            return 1 if _signed(a) < _signed(b) else 0
        if f3 == 0b011:
            return 1 if a < b else 0
        if f3 == 0b100:
            return a ^ b
        if f3 == 0b101:
            if f7 & 0b0100000:
                return (_signed(a) >> sh) & M32
            return a >> sh
        if f3 == 0b110:
            return a | b
        if f3 == 0b111:
            return a & b
        raise GuestFault("bad alu")

    def _ecall(self, reads_log):
        code = int(self.regs[5]) & M32  # t0
        a0 = int(self.regs[10]) & M32
        a1 = int(self.regs[11]) & M32
        if code == HALT:
            self.exit_code = a0
        elif code == COMMIT:
            self.journal_words.append(a0)
        elif code == READ:
            if self.input_pos >= len(self.input_words):
                raise GuestFault("guest read past end of input")
            word = self.input_words[self.input_pos]
            self.input_pos += 1
            self.regs[10] = np.uint64(word)
            if reads_log is not None:
                reads_log.append(word)
        elif code == LOG:
            self.log += self.read_bytes(a0, a1)
        elif code == VERIFY:
            self.verify_words.append(a0)
            if len(self.verify_words) % 8 == 0:
                digest = b"".join(w.to_bytes(4, "little")
                                  for w in self.verify_words[-8:])
                self.assumptions.append(digest)
        elif code == KECCAK:
            # The burst occupies 50 trace rows and publishes 100 cpio
            # entries (air/rv32im.py keccak-ecall burst). Reserve every
            # budget up front: a mid-ecall stop would fire after some
            # stores already mutated memory (loads precede stores, so
            # the page budget is safe, but the op budget charges stores).
            from ..air.rv32im import CP_IO, KEC_WORDS

            if self.mem_op_count + 200 > self.mem_op_budget:
                raise _PageBudgetStop()
            if self._seg_cycles + KEC_WORDS > self.segment_limit:
                if self._seg_cycles == 0:
                    raise GuestFault(
                        "keccak burst does not fit in one segment "
                        "(segment_po2 too small)")
                raise _PageBudgetStop()
            if self._seg_cp_entries + 2 * KEC_WORDS > CP_IO:
                raise _PageBudgetStop()
            self._seg_cp_entries += 2 * KEC_WORDS
            self.cp_entries += 2 * KEC_WORDS
            self._ecall_cost = KEC_WORDS
            lanes = []
            for i in range(25):
                lo = self.load(a0 + 8 * i, 4, False)
                hi = self.load(a0 + 8 * i + 4, 4, False)
                lanes.append(lo | (hi << 32))
            pre_lanes = list(lanes)
            lanes = keccak_f1600(lanes)
            for i, v in enumerate(lanes):
                self.store(a0 + 8 * i, 4, v & M32)
                self.store(a0 + 8 * i + 4, 4, (v >> 32) & M32)
            # circuit-friendly claim: Poseidon2 over the 16-bit limb
            # vectors — the SAME digest the keccak segment proof's
            # public state table derives (air/keccak.py; consumed by the
            # coproc union/resolve stream)
            self.keccak_states.append(pre_lanes)
            self.keccak_claims.append(
                keccak_perm_digest(pre_lanes, lanes))
        else:
            raise GuestFault(f"unknown ecall {code}")
