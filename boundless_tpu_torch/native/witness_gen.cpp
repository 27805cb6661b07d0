// rv32im witness generation: native per-cycle trace fill.
//
// C++ counterpart of zkvm/witness.py::trace_segment's cycle loop — the
// role the reference assigns to risc0-circuit-rv32im-sys's host witness
// generation (SURVEY.md §2.4: "witness-gen host-side feeding device trace
// buffers"). Must stay bit-identical to the Python replay; the test suite
// diffs both outputs.
//
// Every row of the data trace but the memory log's columns and the blinded
// zk rows is written here, once: each cycle row with its degree-helper
// columns (sx, is_addm, is_subm, sh_sra) while it is in cache, then the
// padding rows [cycles, n_rows) with the frozen state, then each image-table
// row's fetch multiplicity (mult_fetch), counted in the loop. data_out may
// hold an earlier trace (zkvm/prove.py reuses one host buffer a concurrent
// proof): each row is cleared just before it is filled, so the rows come out
// as from a zeroed array.
//
// Build: g++ -O2 -shared -fPIC -o libbt_witness.so witness_gen.cpp
// Loaded via ctypes (no pybind11 in the image).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint64_t FP = 2013265921ull;  // Baby Bear
constexpr uint32_t M32 = 0xFFFFFFFFu;

// Column layout offsets, passed from Python (order fixed; see witness.py).
struct Layout {
  int32_t regs, pc, sel, f3, alt, imm_lo, imm_hi, imm_field;
  int32_t rd_oh, rs1_oh, rs2_oh, rs1v, rs2v, op2, rdv;
  int32_t a_bits, b_bits, r_bits, sh_oh, c0, c1, eq, z_inv, taken;
  int32_t k, commit_seq, read_seq, verify_seq, active, halted;
  int32_t is_m, is_shift_col, is_slt_col, is_logic_col;
  int32_t m_hi_bits, q8, m_carry_bits;
  int32_t m_rem_bits, m_d_bits, m_ca0, m_ca1, m_cb, m_bzero, m_binv;
  int32_t m_s_bits, m_g, m_g2;
  int32_t k_kec, kec_cnt, kec_last, kec_linv, cp_seq;
  int32_t sx, is_addm, is_subm, sh_sra, mult_fetch;
};

// keccak-f[1600] (mirrors executor.cpp; KECCAK ecall witness rows)
constexpr uint64_t KRC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};
constexpr int KROT[5][5] = {{0, 36, 3, 41, 18},
                            {1, 44, 10, 45, 2},
                            {62, 6, 43, 15, 61},
                            {28, 55, 25, 21, 56},
                            {27, 20, 39, 8, 14}};

void keccakf(uint64_t a[25]) {
  for (int r = 0; r < 24; r++) {
    uint64_t c[5], d[5], b[25];
    for (int x = 0; x < 5; x++)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
    for (int x = 0; x < 5; x++) {
      uint64_t t = c[(x + 1) % 5];
      d[x] = c[(x + 4) % 5] ^ ((t << 1) | (t >> 63));
    }
    for (int i = 0; i < 25; i++) a[i] ^= d[i % 5];
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++) {
        int rr = KROT[x][y];
        uint64_t v = a[x + 5 * y];
        b[y + 5 * ((2 * x + 3 * y) % 5)] =
            rr ? ((v << rr) | (v >> (64 - rr))) : v;
      }
    for (int y = 0; y < 5; y++)
      for (int x = 0; x < 5; x++)
        a[x + 5 * y] =
            b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y]);
    a[0] ^= KRC[r];
  }
}

// Inverses mod FP of 0..INV_MAX (0 for 0): every inverse the witness takes
// is of a sum of two 16-bit limbs (z_inv, m_binv) or of a burst row's
// distance to its last (kec_linv), so a table built once replaces the
// exponentiations. inv[i] = -(FP / i) * inv[FP % i].
constexpr uint32_t INV_MAX = 2 * 0xFFFF;
const std::vector<uint32_t>& small_inverses() {
  static const std::vector<uint32_t> inv = [] {
    std::vector<uint32_t> t(INV_MAX + 1, 0);
    t[1] = 1;
    for (uint32_t i = 2; i <= INV_MAX; i++)
      t[i] = (uint32_t)((FP - FP / i) * t[FP % i] % FP);
    return t;
  }();
  return inv;
}

int32_t sext(uint32_t v, int bits) {
  uint32_t m = 1u << (bits - 1);
  v &= (1u << bits) - 1;
  return (int32_t)((v ^ m) - m);
}

struct Decoded {
  int sel[10] = {0};
  int f3 = 0;
  int alt = 0;
  int mext = 0;
  uint32_t imm_lo = 0, imm_hi = 0;
  uint64_t imm_field = 0;
  int rd = 0, rs1 = 0, rs2 = 0;
  bool valid = false;
};

// Mirrors witness.py::decode_row exactly.
Decoded decode(uint32_t word) {
  Decoded d;
  uint32_t op = word & 0x7F;
  d.rd = (word >> 7) & 0x1F;
  d.f3 = (word >> 12) & 0x7;
  d.rs1 = (word >> 15) & 0x1F;
  d.rs2 = (word >> 20) & 0x1F;
  int32_t imm_i = sext(word >> 20, 12);
  int32_t imm_s = sext(((word >> 25) << 5) | ((word >> 7) & 0x1F), 12);
  int32_t imm_b = sext((((word >> 31) & 1) << 12) | (((word >> 7) & 1) << 11) |
                           (((word >> 25) & 0x3F) << 5) |
                           (((word >> 8) & 0xF) << 1),
                       13);
  uint32_t imm_u = word & 0xFFFFF000u;
  int32_t imm_j = sext((((word >> 31) & 1) << 20) |
                           (((word >> 12) & 0xFF) << 12) |
                           (((word >> 20) & 1) << 11) |
                           (((word >> 21) & 0x3FF) << 1),
                       21);
  auto set_imm32 = [&](uint32_t v) {
    d.imm_lo = v & 0xFFFF;
    d.imm_hi = v >> 16;
  };
  d.valid = true;
  switch (op) {
    case 0b0110111:  // LUI
      d.sel[0] = 1;
      set_imm32(imm_u);
      d.rs1 = d.rs2 = 0;
      break;
    case 0b0010111:  // AUIPC
      d.sel[1] = 1;
      set_imm32(imm_u);
      d.rs1 = d.rs2 = 0;
      break;
    case 0b1101111:  // JAL
      d.sel[2] = 1;
      d.imm_field = ((int64_t)imm_j % (int64_t)FP + FP) % FP;
      d.rs1 = d.rs2 = 0;
      break;
    case 0b1100111:  // JALR
      d.sel[3] = 1;
      set_imm32((uint32_t)imm_i);
      d.rs2 = 0;
      break;
    case 0b1100011:  // BRANCH
      d.sel[4] = 1;
      d.imm_field = ((int64_t)imm_b % (int64_t)FP + FP) % FP;
      d.rd = 0;
      break;
    case 0b0000011:  // LOAD
      d.sel[5] = 1;
      set_imm32((uint32_t)imm_i);
      d.rs2 = 0;
      break;
    case 0b0100011:  // STORE
      d.sel[6] = 1;
      set_imm32((uint32_t)imm_s);
      d.rd = 0;
      break;
    case 0b0010011:  // ALU-IMM
      d.sel[7] = 1;
      if (d.f3 == 1 || d.f3 == 5) {
        d.imm_lo = (word >> 20) & 0x1F;
        d.alt = (word >> 30) & 1;
      } else {
        set_imm32((uint32_t)imm_i);
      }
      d.rs2 = 0;
      break;
    case 0b0110011:  // ALU-REG
      d.sel[8] = 1;
      d.alt = (word >> 30) & 1;
      d.mext = (word >> 25) & 1;
      break;
    case 0b1110011:  // SYSTEM
      d.sel[9] = 1;
      d.rd = d.rs1 = d.rs2 = 0;
      d.f3 = 0;
      break;
    default:
      d.valid = false;
  }
  return d;
}

void fail(char* err, int len, const char* msg) { snprintf(err, len, "%s", msg); }

// The machine state a row carries: pc, register limbs, halted, the four
// sequence counters (commit, read, verify, cpio).
void write_state(int64_t* r, const Layout& L, uint32_t pc,
                 const uint32_t* regs, bool halted, const uint64_t* seqs) {
  r[L.pc] = pc;
  for (int i = 0; i < 32; i++) {
    r[L.regs + 2 * i] = regs[i] & 0xFFFF;
    r[L.regs + 2 * i + 1] = regs[i] >> 16;
  }
  r[L.halted] = halted ? 1 : 0;
  r[L.commit_seq] = (int64_t)seqs[0];
  r[L.read_seq] = (int64_t)seqs[1];
  r[L.verify_seq] = (int64_t)seqs[2];
  r[L.cp_seq] = (int64_t)seqs[3];
}

// The committed degree-helper columns of a filled row, from its own cells
// (air/rv32im.py "shared adder"/"sx"; witness.py's replay tail computes the
// same over whole columns).
void write_helpers(int64_t* r, const Layout& L) {
  int64_t alt = r[L.alt];
  int64_t alu_nm = (r[L.sel + 7] + r[L.sel + 8]) * (1 - r[L.is_m]);
  r[L.sx] = r[L.a_bits + 31] ^ r[L.b_bits + 31];
  r[L.is_addm] = alu_nm * r[L.f3] * (1 - alt) + r[L.sel + 5] + r[L.sel + 6] +
                 r[L.sel + 3];
  r[L.is_subm] =
      alu_nm * (r[L.f3] * alt + r[L.f3 + 2] + r[L.f3 + 3]) + r[L.sel + 4];
  r[L.sh_sra] = r[L.is_shift_col] * r[L.f3 + 5] * alt;
}

}  // namespace

extern "C" int bt_trace_cycles(
    const uint32_t* img_addrs, const uint32_t* img_words, int n_img,
    uint32_t pre_pc, uint32_t* regs /*32 in-out*/, const uint32_t* mem_addrs,
    const uint32_t* mem_vals, int n_mem, const uint32_t* reads, int n_reads,
    uint64_t* seqs /*4 in-out: commit, read, verify, cpio*/, int cycles,
    int n_rows,
    int data_cols, const int32_t* layout_arr, int64_t* data_out,
    int64_t* mem_ops_out /*(cap,4)*/, int64_t* io_rows_out /*(cap,4)*/,
    int32_t* counts /*2 out: n_mem_ops, n_io*/, uint32_t* post_pc,
    char* err, int err_len) {
  Layout L;
  std::memcpy(&L, layout_arr, sizeof(L));
  if (n_img > n_rows) return fail(err, err_len, "image table exceeds rows"), 1;
  std::unordered_map<uint32_t, uint32_t> mem;
  // address -> its image-table row (img_addrs is sorted: the ctrl table's
  // order), whose fetches land in fetches[row]
  std::unordered_map<uint32_t, int> img;
  std::vector<int64_t> fetches(n_img, 0);
  const std::vector<uint32_t>& inv = small_inverses();
  mem.reserve(n_mem * 2);
  for (int i = 0; i < n_mem; i++) mem[mem_addrs[i]] = mem_vals[i];
  for (int i = 0; i < n_img; i++) img[img_addrs[i]] = i;
  uint32_t pc = pre_pc;
  int read_pos = 0;
  int n_ops = 0, n_io = 0;
  bool halted = false;

  auto row = [&](int clk) { return data_out + (int64_t)clk * data_cols; };

  int clk = 0;
  while (clk < cycles) {
    int64_t* r = row(clk);
    std::memset(r, 0, (size_t)data_cols * sizeof(int64_t));
    write_state(r, L, pc, regs, halted, seqs);
    r[L.active] = 1;
    if (halted) return fail(err, err_len, "cycle after halt"), 1;

    auto it = mem.find(pc & ~3u);
    if (it == mem.end()) return fail(err, err_len, "fetch unmapped pc"), 1;
    auto ig = img.find(pc & ~3u);
    if (ig == img.end() || img_words[ig->second] != it->second)
      return fail(err, err_len, "self-modifying code is not provable"), 1;
    int64_t& fetched = fetches[ig->second];
    fetched++;
    uint32_t word = it->second;
    Decoded d = decode(word);
    if (!d.valid)
      return fail(err, err_len, "unprovable instruction"), 1;

    for (int i = 0; i < 10; i++) r[L.sel + i] = d.sel[i];
    r[L.f3 + d.f3] = 1;
    r[L.alt] = d.alt;
    r[L.imm_lo] = d.imm_lo;
    r[L.imm_hi] = d.imm_hi;
    r[L.imm_field] = (int64_t)d.imm_field;
    r[L.rd_oh + d.rd] = 1;
    r[L.rs1_oh + d.rs1] = 1;
    r[L.rs2_oh + d.rs2] = 1;

    uint32_t rs1v = regs[d.rs1];
    uint32_t rs2v = regs[d.rs2];
    uint32_t imm32 = d.imm_lo | (d.imm_hi << 16);
    bool use_imm = d.sel[7] || d.sel[5] || d.sel[6] || d.sel[3];
    uint32_t op2 = use_imm ? imm32 : rs2v;
    r[L.rs1v] = rs1v & 0xFFFF;
    r[L.rs1v + 1] = rs1v >> 16;
    r[L.rs2v] = rs2v & 0xFFFF;
    r[L.rs2v + 1] = rs2v >> 16;
    r[L.op2] = op2 & 0xFFFF;
    r[L.op2 + 1] = op2 >> 16;

    bool is_m = d.sel[8] && d.mext;
    bool is_mdiv = is_m && d.f3 >= 4;  // any div/rem: a_bits carry q
    r[L.is_m] = is_m ? 1 : 0;
    bool is_alu = d.sel[7] || d.sel[8];
    r[L.is_shift_col] =
        (is_alu && !is_m && (d.f3 == 1 || d.f3 == 5)) ? 1 : 0;
    r[L.is_slt_col] = (is_alu && !is_m && (d.f3 == 2 || d.f3 == 3)) ? 1 : 0;
    r[L.is_logic_col] =
        (is_alu && !is_m && (d.f3 == 4 || d.f3 == 6 || d.f3 == 7)) ? 1 : 0;
    bool bind_ab = is_alu || d.sel[4];
    if (bind_ab && !is_mdiv)
      for (int i = 0; i < 32; i++) r[L.a_bits + i] = (rs1v >> i) & 1;
    if (bind_ab)
      for (int i = 0; i < 32; i++) r[L.b_bits + i] = (op2 >> i) & 1;

    uint32_t rdv = 0;
    uint32_t next_pc = pc + 4;
    bool have_r32 = false;
    uint32_t r32 = 0;
    int c0 = 0, c1 = 0;
    int sh_set = 0;  // 1 if sh_oh written explicitly

    auto addm = [&]() {
      uint64_t s = (uint64_t)rs1v + op2;
      r32 = (uint32_t)s;
      have_r32 = true;
      c0 = ((rs1v & 0xFFFF) + (op2 & 0xFFFF)) >> 16 ? 1 : 0;
      c1 = s >> 32 ? 1 : 0;
    };
    auto subm = [&]() {
      r32 = rs1v - op2;
      have_r32 = true;
      c0 = ((op2 & 0xFFFF) + (r32 & 0xFFFF)) >> 16 ? 1 : 0;
      c1 = ((uint64_t)op2 + r32) >> 32 ? 1 : 0;
    };

    if (d.sel[0]) {  // LUI
      rdv = imm32;
    } else if (d.sel[1]) {  // AUIPC: rd = (pc + imm_u) mod 2^32
      uint64_t s = (uint64_t)pc + imm32;
      rdv = (uint32_t)s;
      r32 = pc;  // r_bits carry the pc limb decomposition
      have_r32 = true;
      for (int i = 0; i < 32; i++) r[L.a_bits + i] = (rdv >> i) & 1;
      c0 = ((pc & 0xFFFF) + (imm32 & 0xFFFF)) >> 16 ? 1 : 0;
      c1 = s >> 32 ? 1 : 0;
    } else if (d.sel[2]) {  // JAL
      r32 = pc + 4;
      have_r32 = true;
      rdv = r32;
      int64_t imm = (int64_t)d.imm_field;
      if (imm > (int64_t)FP / 2) imm -= (int64_t)FP;
      next_pc = (uint32_t)((int64_t)pc + imm);
    } else if (d.sel[3]) {  // JALR
      addm();
      uint32_t target = r32;
      if ((target & 3) || target >= (1u << 26))
        return fail(err, err_len, "jalr target unaligned or out of range"), 1;
      next_pc = target;
      rdv = pc + 4;
      for (int i = 0; i < 32; i++) r[L.b_bits + i] = (rdv >> i) & 1;
    } else if (d.sel[4]) {  // BRANCH
      subm();
      int lt_u = c1;
      int a31 = (rs1v >> 31) & 1, b31 = (op2 >> 31) & 1;
      int lt_s = lt_u ^ a31 ^ b31;
      uint32_t z = (r32 & 0xFFFF) + (r32 >> 16);
      int eqf = z == 0 ? 1 : 0;
      r[L.eq] = eqf;
      r[L.z_inv] = inv[z];
      int taken;
      switch (d.f3) {
        case 0: taken = eqf; break;
        case 1: taken = 1 - eqf; break;
        case 4: taken = lt_s; break;
        case 5: taken = 1 - lt_s; break;
        case 6: taken = lt_u; break;
        case 7: taken = 1 - lt_u; break;
        default: return fail(err, err_len, "bad branch f3"), 1;
      }
      r[L.taken] = taken;
      if (taken) {
        int64_t imm = (int64_t)d.imm_field;
        if (imm > (int64_t)FP / 2) imm -= (int64_t)FP;
        next_pc = (uint32_t)((int64_t)pc + imm);
      }
    } else if (d.sel[5] || d.sel[6]) {  // LOAD / STORE (word and sub-word)
      addm();
      uint32_t addr = r32;
      int size;
      switch (d.f3) {
        case 0: case 4: size = 1; break;
        case 1: case 5: size = 2; break;
        case 2: size = 4; break;
        default: size = 0;
      }
      if (!size || (d.sel[6] && d.f3 > 2))
        return fail(err, err_len, "bad load/store width"), 1;
      if ((addr % size) || addr >= (1u << 26))
        return fail(err, err_len, "memory access unaligned or out of range"), 1;
      uint32_t off = addr & 3u;
      uint32_t base = addr & ~3u;
      uint32_t waddr = base >> 2;
      // sh_oh = byte-offset one-hot; mem-op times are 2*clk + phase
      r[L.sh_oh + off] = 1;
      sh_set = 1;
      auto push_op = [&](int64_t t, uint32_t wa, int isw,
                         uint32_t val) -> bool {
        if (n_ops >= n_rows) return false;
        mem_ops_out[4 * n_ops] = t;
        mem_ops_out[4 * n_ops + 1] = wa;
        mem_ops_out[4 * n_ops + 2] = isw;
        mem_ops_out[4 * n_ops + 3] = val;
        n_ops++;
        return true;
      };
      if (d.sel[5]) {
        auto mv = mem.find(base);
        if (mv == mem.end())
          return fail(err, err_len, "uninitialized read"), 1;
        uint32_t w = mv->second;
        for (int i = 0; i < 32; i++) r[L.b_bits + i] = (w >> i) & 1;
        if (d.f3 == 2) {
          rdv = w;
        } else if (d.f3 == 0 || d.f3 == 4) {
          uint32_t bv = (w >> (8 * off)) & 0xFFu;
          rdv = (d.f3 == 4 || !(bv & 0x80u)) ? bv : (bv | 0xFFFFFF00u);
        } else {
          uint32_t hv = (w >> (8 * off)) & 0xFFFFu;
          rdv = (d.f3 == 5 || !(hv & 0x8000u)) ? hv : (hv | 0xFFFF0000u);
        }
        if (!push_op(2 * (int64_t)clk, waddr, 0, w))
          return fail(err, err_len, "mem ops overflow"), 1;
      } else {
        uint32_t merged;
        if (d.f3 == 2) {
          merged = rs2v;
        } else {
          auto mv = mem.find(base);
          // missing words read as zero (paging-port publics bind the
          // pre value; uninitialized memory is defined all-zero)
          uint32_t old = (mv == mem.end()) ? 0u : mv->second;
          for (int i = 0; i < 32; i++) r[L.b_bits + i] = (old >> i) & 1;
          if (d.f3 == 0) {
            uint32_t mask = 0xFFu << (8 * off);
            merged = (old & ~mask) | ((rs2v & 0xFFu) << (8 * off));
            for (int i = 0; i < 8; i++)
              r[L.q8 + i] = ((rs2v >> 8) >> i) & 1;
          } else {
            uint32_t mask = 0xFFFFu << (8 * off);
            merged = (old & ~mask) | ((rs2v & 0xFFFFu) << (8 * off));
          }
          if (!push_op(2 * (int64_t)clk, waddr, 0, old))
            return fail(err, err_len, "mem ops overflow"), 1;
        }
        mem[base] = merged;
        for (int i = 0; i < 32; i++) r[L.a_bits + i] = (merged >> i) & 1;
        if (!push_op(2 * (int64_t)clk + 1, waddr, 1, merged))
          return fail(err, err_len, "mem ops overflow"), 1;
      }
    } else if (is_m) {  // M extension (all 8 ops)
      int a31m = (rs1v >> 31) & 1, b31m = (op2 >> 31) & 1;
      bool is_div = d.f3 >= 4;
      uint32_t q = 0, rem = 0, mul_a;
      if (is_div) {
        if (d.f3 == 5 || d.f3 == 7) {  // DIVU / REMU
          if (op2 != 0) { q = rs1v / op2; rem = rs1v % op2; }
          else { q = 0; rem = rs1v; }
        } else {  // DIV / REM (signed, truncating)
          int64_t sa = (int32_t)rs1v, sb = (int32_t)op2;
          if (sb == 0) { q = M32; rem = rs1v; }
          else if (sa == INT32_MIN && sb == -1) { q = 0x80000000u; rem = 0; }
          else {
            int64_t qs = sa / sb;  // C++ division truncates toward zero
            q = (uint32_t)qs;
            rem = (uint32_t)(sa - qs * sb);
          }
        }
        mul_a = q;
      } else {
        mul_a = rs1v;
      }
      for (int i = 0; i < 32; i++) r[L.a_bits + i] = (mul_a >> i) & 1;
      uint64_t prod = (uint64_t)mul_a * op2;
      uint32_t lo = (uint32_t)prod, hi = (uint32_t)(prod >> 32);
      r32 = lo;
      have_r32 = true;
      for (int i = 0; i < 32; i++) r[L.m_hi_bits + i] = (hi >> i) & 1;
      uint32_t ab[4], bb[4];
      for (int i = 0; i < 4; i++) {
        ab[i] = (mul_a >> (8 * i)) & 0xFF;
        bb[i] = (op2 >> (8 * i)) & 0xFF;
      }
      uint32_t carry = 0;
      for (int k2 = 0; k2 < 7; k2++) {
        uint32_t ck = 0;
        for (int i = (k2 > 3 ? k2 - 3 : 0); i < 4 && i <= k2; i++)
          ck += ab[i] * bb[k2 - i];
        uint32_t t = ck + carry;
        carry = t >> 8;
        for (int i = 0; i < 11; i++)
          r[L.m_carry_bits + 11 * k2 + i] = (carry >> i) & 1;
      }
      if (is_div) {
        for (int i = 0; i < 32; i++) r[L.m_rem_bits + i] = (rem >> i) & 1;
        int bz = op2 == 0 ? 1 : 0;
        r[L.m_bzero] = bz;
        uint32_t s = (op2 & 0xFFFF) + (op2 >> 16);
        r[L.m_binv] = inv[s];
        uint32_t k0 = ((lo & 0xFFFF) + (rem & 0xFFFF)) >> 16;
        r[L.m_ca0] = (int64_t)k0;
        if (d.f3 == 5 || d.f3 == 7) {
          if (!bz) {
            uint32_t dd = op2 - 1 - rem;
            for (int i = 0; i < 32; i++) r[L.m_d_bits + i] = (dd >> i) & 1;
            r[L.m_cb] = (((rem & 0xFFFF) + (dd & 0xFFFF) + 1) >> 16) ? 1 : 0;
          }
          rdv = d.f3 == 5 ? (op2 == 0 ? M32 : q) : rem;
        } else {  // DIV / REM signed bookkeeping
          for (int i = 0; i < 32; i++) r[L.sh_oh + i] = (rs1v >> i) & 1;
          sh_set = 1;
          uint32_t k1 =
              ((lo >> 16) + (rem >> 16) + k0 - (rs1v >> 16)) >> 16;
          r[L.m_ca1] = (int64_t)k1;
          int rho = (rem >> 31) & 1;
          int o = (rs1v == 0x80000000u && op2 == 0xFFFFFFFFu) ? 1 : 0;
          r[L.m_s_bits + 2] = o;
          r[L.m_g] = 1 - o;
          r[L.m_g2] = 1 - bz;
          if (!o) {
            uint32_t q31 = (q >> 31) & 1;
            uint32_t U = q31 * (op2 & 0xFFFF) + b31m * (q & 0xFFFF);
            uint32_t V = q31 * (op2 >> 16) + b31m * (q >> 16);
            uint32_t s0 =
                ((hi & 0xFFFF) + a31m + k1 + (1u << 17) - rho - U) >> 16;
            c0 = s0 & 1;
            c1 = s0 >> 1;
            uint32_t e = ((hi >> 16) + s0 + (1u << 16) - V - 2) >> 16;
            r[L.m_s_bits] = e & 1;
            r[L.m_s_bits + 1] = e >> 1;
          }
          if (!bz) {
            uint64_t dd;
            uint32_t cA, cB = 0;
            if (rho == 0 && b31m == 0) {
              dd = (uint64_t)op2 - 1 - rem;
              cA = ((rem & 0xFFFF) + 1 + (uint32_t)(dd & 0xFFFF)) >> 16;
            } else if (rho == 0 && b31m == 1) {
              dd = (1ull << 32) - 1 - rem - op2;
              cA = (((rem & 0xFFFF) + (op2 & 0xFFFF) + 1 +
                     (uint32_t)(dd & 0xFFFF)) >> 16) - 1;
            } else if (rho == 1 && b31m == 0) {
              dd = (uint64_t)rem + op2 - (1ull << 32) - 1;
              uint32_t g0 = ((rem & 0xFFFF) + (op2 & 0xFFFF) +
                             (1u << 16) - 1 - (uint32_t)(dd & 0xFFFF)) >> 16;
              cA = g0 & 1;
              cB = g0 >> 1;
            } else {
              dd = (uint64_t)rem - 1 - op2;
              cA = ((op2 & 0xFFFF) + 1 + (uint32_t)(dd & 0xFFFF)) >> 16;
            }
            for (int i = 0; i < 32; i++)
              r[L.m_d_bits + i] = (int64_t)((dd >> i) & 1);
            r[L.m_s_bits + 3] = cA;
            r[L.m_s_bits + 4] = cB;
          }
          rdv = d.f3 == 4 ? q : rem;
        }
      } else if (d.f3 == 0 || d.f3 == 3) {
        rdv = d.f3 == 0 ? lo : hi;
      } else {  // MULH (1) / MULHSU (2): signed high word
        uint32_t use_b = d.f3 == 1 ? 1 : 0;
        uint64_t corr = (uint64_t)a31m * op2 + (uint64_t)use_b * b31m * rs1v;
        uint32_t res = (uint32_t)(hi - corr);
        for (int i = 0; i < 32; i++) r[L.m_rem_bits + i] = (res >> i) & 1;
        uint32_t corr_lo =
            a31m * (op2 & 0xFFFF) + use_b * b31m * (rs1v & 0xFFFF);
        uint32_t t0 = (corr_lo + (res & 0xFFFF) - (hi & 0xFFFF)) >> 16;
        uint32_t corr_hi = a31m * (op2 >> 16) + use_b * b31m * (rs1v >> 16);
        uint32_t t1 = (corr_hi + (res >> 16) + t0 - (hi >> 16)) >> 16;
        if (d.f3 == 1) {
          r[L.m_ca0] = t0 >= 1 ? 1 : 0;
          r[L.m_cb] = t0 >= 2 ? 1 : 0;
          c0 = t1 >= 1 ? 1 : 0;
          c1 = t1 >= 2 ? 1 : 0;
        } else {
          r[L.m_ca0] = (int64_t)t0;
          c0 = (int)t1;
        }
        rdv = res;
      }
    } else if (d.sel[7] || d.sel[8]) {  // ALU
      switch (d.f3) {
        case 0:
          if (d.alt) subm(); else addm();
          rdv = r32;
          break;
        case 2:
        case 3: {
          subm();
          int lt_u = c1;
          int a31 = (rs1v >> 31) & 1, b31 = (op2 >> 31) & 1;
          int lt_s = lt_u ^ a31 ^ b31;
          rdv = d.f3 == 2 ? lt_s : lt_u;
          break;
        }
        case 1: {
          int sh = op2 & 0x1F;
          r32 = rs1v << sh;
          have_r32 = true;
          rdv = r32;
          r[L.sh_oh + sh] = 1;
          sh_set = 1;
          break;
        }
        case 5: {
          int sh = op2 & 0x1F;
          r32 = d.alt ? (uint32_t)((int32_t)rs1v >> sh) : (rs1v >> sh);
          have_r32 = true;
          rdv = r32;
          r[L.sh_oh + sh] = 1;
          sh_set = 1;
          break;
        }
        case 4: r32 = rs1v ^ op2; have_r32 = true; rdv = r32; break;
        case 6: r32 = rs1v | op2; have_r32 = true; rdv = r32; break;
        case 7: r32 = rs1v & op2; have_r32 = true; rdv = r32; break;
        default: return fail(err, err_len, "bad alu f3"), 1;
      }
    } else if (d.sel[9]) {  // ECALL
      uint32_t t0 = regs[5];
      if (t0 > 5) return fail(err, err_len, "unknown ecall"), 1;
      if (t0 < 5) r[L.k + t0] = 1;
      uint32_t a0 = regs[10];
      if (t0 == 5) {  // KECCAK coprocessor: 50-row burst (in-circuit
        // ecall ABI — air/rv32im.py; row j reads in-word j / writes
        // out-word j and publishes both as cpio entries)
        if ((a0 & 3u) || a0 >= (1u << 26))
          return fail(err, err_len, "keccak state unaligned/out of range"),
                 1;
        if (clk + 50 > cycles)
          return fail(err, err_len, "keccak burst exceeds segment"), 1;
        uint64_t st[25];
        uint32_t in_w[50], out_w[50];
        for (int i = 0; i < 50; i++) {
          auto mv = mem.find(a0 + 4 * i);
          if (mv == mem.end())
            return fail(err, err_len, "uninitialized read"), 1;
          in_w[i] = mv->second;
        }
        for (int i = 0; i < 25; i++)
          st[i] = (uint64_t)in_w[2 * i] | ((uint64_t)in_w[2 * i + 1] << 32);
        keccakf(st);
        for (int i = 0; i < 25; i++) {
          out_w[2 * i] = (uint32_t)st[i];
          out_w[2 * i + 1] = (uint32_t)(st[i] >> 32);
        }
        uint64_t cp0 = seqs[3];
        uint32_t w0 = a0 >> 2;
        for (int j = 0; j < 50; j++) {
          int64_t* rj = row(clk + j);
          if (j) {
            std::memcpy(rj, r, (size_t)data_cols * sizeof(int64_t));
            rj[L.cp_seq] = (int64_t)(cp0 + 2 * j);
          }
          rj[L.k_kec] = 1;
          rj[L.kec_cnt] = j;
          rj[L.kec_last] = j == 49 ? 1 : 0;
          rj[L.kec_linv] = j == 49 ? 0 : FP - inv[49 - j];  // 1/(j - 49)
          for (int i = 0; i < 32; i++) rj[L.r_bits + i] = (a0 >> i) & 1;
          for (int i = 0; i < 32; i++)
            rj[L.b_bits + i] = (in_w[j] >> i) & 1;
          for (int i = 0; i < 32; i++)
            rj[L.a_bits + i] = (out_w[j] >> i) & 1;
          rj[L.sh_oh] = 1;
          int64_t ck = clk + j;
          if (n_ops + 2 > n_rows || n_io + 2 > n_rows)
            return fail(err, err_len, "mem/io op overflow"), 1;
          mem_ops_out[4 * n_ops] = 2 * ck;
          mem_ops_out[4 * n_ops + 1] = w0 + j;
          mem_ops_out[4 * n_ops + 2] = 0;
          mem_ops_out[4 * n_ops + 3] = in_w[j];
          n_ops++;
          mem_ops_out[4 * n_ops] = 2 * ck + 1;
          mem_ops_out[4 * n_ops + 1] = w0 + j;
          mem_ops_out[4 * n_ops + 2] = 1;
          mem_ops_out[4 * n_ops + 3] = out_w[j];
          n_ops++;
          io_rows_out[4 * n_io] = 8;  // TAG cpio (in word)
          io_rows_out[4 * n_io + 1] = (int64_t)(cp0 + 2 * j);
          io_rows_out[4 * n_io + 2] = in_w[j] & 0xFFFF;
          io_rows_out[4 * n_io + 3] = in_w[j] >> 16;
          n_io++;
          io_rows_out[4 * n_io] = 8;  // TAG cpio (out word)
          io_rows_out[4 * n_io + 1] = (int64_t)(cp0 + 2 * j + 1);
          io_rows_out[4 * n_io + 2] = out_w[j] & 0xFFFF;
          io_rows_out[4 * n_io + 3] = out_w[j] >> 16;
          n_io++;
          mem[a0 + 4 * j] = out_w[j];
          write_helpers(rj, L);
        }
        fetched += 49;  // every row of the burst fetches the ecall
        seqs[3] = cp0 + 100;
        pc = pc + 4;
        clk += 50;
        continue;
      }
      if (t0 == 0) {
        halted = true;
      } else if (t0 == 1) {
        if (n_io >= n_rows) return fail(err, err_len, "io overflow"), 1;
        io_rows_out[4 * n_io] = 4;  // TAG commit
        io_rows_out[4 * n_io + 1] = (int64_t)seqs[0];
        io_rows_out[4 * n_io + 2] = a0 & 0xFFFF;
        io_rows_out[4 * n_io + 3] = a0 >> 16;
        n_io++;
        seqs[0]++;
      } else if (t0 == 2) {
        if (read_pos >= n_reads)
          return fail(err, err_len, "segment read log exhausted"), 1;
        if (n_io >= n_rows) return fail(err, err_len, "io overflow"), 1;
        uint32_t wv = reads[read_pos++];
        rdv = wv;
        io_rows_out[4 * n_io] = 5;  // TAG read
        io_rows_out[4 * n_io + 1] = (int64_t)seqs[1];
        io_rows_out[4 * n_io + 2] = wv & 0xFFFF;
        io_rows_out[4 * n_io + 3] = wv >> 16;
        n_io++;
        seqs[1]++;
        regs[10] = wv;
      } else if (t0 == 4) {
        if (n_io >= n_rows) return fail(err, err_len, "io overflow"), 1;
        io_rows_out[4 * n_io] = 6;  // TAG verify
        io_rows_out[4 * n_io + 1] = (int64_t)seqs[2];
        io_rows_out[4 * n_io + 2] = a0 & 0xFFFF;
        io_rows_out[4 * n_io + 3] = a0 >> 16;
        n_io++;
        seqs[2]++;
      }  // t0 == 3 (LOG): no constrained effect
    }

    if (have_r32)
      for (int i = 0; i < 32; i++) r[L.r_bits + i] = (r32 >> i) & 1;
    if (!sh_set) r[L.sh_oh] = 1;
    r[L.c0] = c0;
    r[L.c1] = c1;
    r[L.rdv] = rdv & 0xFFFF;
    r[L.rdv + 1] = rdv >> 16;
    write_helpers(r, L);

    bool wen = d.sel[0] || d.sel[1] || d.sel[2] || d.sel[3] || d.sel[5] ||
               d.sel[7] || d.sel[8];
    if (wen && d.rd != 0) regs[d.rd] = rdv;
    pc = next_pc;
    clk++;
  }
  // padding rows: the frozen state and the default one-hots
  for (int t = cycles; t < n_rows; t++) {
    int64_t* r = row(t);
    std::memset(r, 0, (size_t)data_cols * sizeof(int64_t));
    write_state(r, L, pc, regs, halted, seqs);
    r[L.rd_oh] = 1;
    r[L.rs1_oh] = 1;
    r[L.rs2_oh] = 1;
    r[L.sh_oh] = 1;
  }
  // table rows may lie among the padding rows, so the counts go in last
  for (int t = 0; t < n_img; t++) row(t)[L.mult_fetch] = fetches[t];
  counts[0] = n_ops;
  counts[1] = n_io;
  *post_pc = pc;
  // report halt state via counts[2]? use err buffer convention instead:
  err[0] = halted ? 1 : 0;
  return 0;
}
