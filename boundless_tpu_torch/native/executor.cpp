// Full rv32im execute-only interpreter (preflight hot path).
//
// C++ counterpart of the reference's CPU executor role for pricing
// (`ExecutorImpl` run for cycle counts, SURVEY §3.4 PreflightLayer): runs
// the COMPLETE RV32IM ISA (incl. M extension, sub-word loads/stores,
// AUIPC) with the word-based guest ABI, returning total cycles, exit code
// and the journal words. Must agree exactly with zkvm/executor.py
// (diffed in tests).
//
// Built by g++ at first use into the repository's build/ directory
// (boundless_tpu_torch/native/__init__.py).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <unordered_map>

namespace {
constexpr uint32_t M32v = 0xFFFFFFFFu;

int32_t sext(uint32_t v, int bits) {
  uint32_t m = 1u << (bits - 1);
  v &= (1u << bits) - 1;
  return (int32_t)((v ^ m) - m);
}

// keccak-f[1600]
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

struct Mem {
  std::unordered_map<uint32_t, uint32_t> words;
  uint32_t load_word(uint32_t addr) {
    auto it = words.find(addr & ~3u);
    return it == words.end() ? 0 : it->second;
  }
  void store_word(uint32_t addr, uint32_t v) { words[addr & ~3u] = v; }
};
}  // namespace

extern "C" int bt_execute(
    const uint32_t* img_addrs, const uint32_t* img_words, int n_img,
    uint32_t entry, const uint32_t* input_words, int n_input,
    uint64_t max_cycles,
    // outputs
    uint64_t* total_cycles, int32_t* exit_code,
    uint32_t* journal_out, int journal_cap, int32_t* journal_len,
    char* err, int err_len) {
  Mem mem;
  mem.words.reserve(n_img * 2);
  for (int i = 0; i < n_img; i++) mem.words[img_addrs[i]] = img_words[i];
  uint32_t regs[32] = {0};
  uint32_t pc = entry;
  int input_pos = 0;
  int jlen = 0;
  uint64_t cycles = 0;
  *exit_code = -1;

  auto fail = [&](const char* msg) {
    snprintf(err, err_len, "%s (pc=0x%x cycle=%llu)", msg, pc,
             (unsigned long long)cycles);
    return 1;
  };

  while (true) {
    if (cycles >= max_cycles) return fail("session cycle limit exceeded");
    if (pc & 3) return fail("misaligned pc");
    uint32_t word = mem.load_word(pc);
    uint32_t op = word & 0x7F;
    uint32_t rd = (word >> 7) & 0x1F;
    uint32_t f3 = (word >> 12) & 0x7;
    uint32_t rs1 = (word >> 15) & 0x1F;
    uint32_t rs2 = (word >> 20) & 0x1F;
    uint32_t f7 = (word >> 25) & 0x7F;
    uint32_t a = regs[rs1], b = regs[rs2];
    uint32_t next_pc = pc + 4;
    bool wrote = false;
    uint32_t val = 0;
    cycles++;

    switch (op) {
      case 0b0110111: val = word & 0xFFFFF000u; wrote = true; break;
      case 0b0010111: val = pc + (word & 0xFFFFF000u); wrote = true; break;
      case 0b1101111: {  // JAL
        int32_t imm = sext((((word >> 31) & 1) << 20) |
                               (((word >> 12) & 0xFF) << 12) |
                               (((word >> 20) & 1) << 11) |
                               (((word >> 21) & 0x3FF) << 1),
                           21);
        val = next_pc;
        wrote = true;
        next_pc = pc + imm;
        break;
      }
      case 0b1100111: {  // JALR
        int32_t imm = sext(word >> 20, 12);
        val = next_pc;
        wrote = true;
        next_pc = (a + imm) & ~1u;
        break;
      }
      case 0b1100011: {  // BRANCH
        int32_t imm = sext((((word >> 31) & 1) << 12) |
                               (((word >> 7) & 1) << 11) |
                               (((word >> 25) & 0x3F) << 5) |
                               (((word >> 8) & 0xF) << 1),
                           13);
        bool taken;
        switch (f3) {
          case 0: taken = a == b; break;
          case 1: taken = a != b; break;
          case 4: taken = (int32_t)a < (int32_t)b; break;
          case 5: taken = (int32_t)a >= (int32_t)b; break;
          case 6: taken = a < b; break;
          case 7: taken = a >= b; break;
          default: return fail("bad branch f3");
        }
        if (taken) next_pc = pc + imm;
        break;
      }
      case 0b0000011: {  // LOAD
        uint32_t addr = a + sext(word >> 20, 12);
        uint32_t w = mem.load_word(addr);
        uint32_t sh = (addr & 3) * 8;
        switch (f3) {
          case 0: val = (uint32_t)sext((w >> sh) & 0xFF, 8); break;
          case 1:
            if (addr & 1) return fail("misaligned halfword load");
            val = (uint32_t)sext((w >> sh) & 0xFFFF, 16);
            break;
          case 2:
            if (addr & 3) return fail("misaligned word load");
            val = w;
            break;
          case 4: val = (w >> sh) & 0xFF; break;
          case 5:
            if (addr & 1) return fail("misaligned halfword load");
            val = (w >> sh) & 0xFFFF;
            break;
          default: return fail("bad load f3");
        }
        wrote = true;
        break;
      }
      case 0b0100011: {  // STORE
        int32_t imm = sext(((word >> 25) << 5) | ((word >> 7) & 0x1F), 12);
        uint32_t addr = a + imm;
        uint32_t w = mem.load_word(addr);
        uint32_t sh = (addr & 3) * 8;
        switch (f3) {
          case 0:
            mem.store_word(addr, (w & ~(0xFFu << sh)) | ((b & 0xFF) << sh));
            break;
          case 1:
            if (addr & 1) return fail("misaligned halfword store");
            mem.store_word(addr,
                           (w & ~(0xFFFFu << sh)) | ((b & 0xFFFF) << sh));
            break;
          case 2:
            if (addr & 3) return fail("misaligned word store");
            mem.store_word(addr, b);
            break;
          default: return fail("bad store f3");
        }
        break;
      }
      case 0b0010011:    // ALU-IMM
      case 0b0110011: {  // ALU-REG
        bool immmode = op == 0b0010011;
        uint32_t o2 = immmode ? (uint32_t)sext(word >> 20, 12) : b;
        if (!immmode && f7 == 1) {  // M extension
          int64_t sa = (int32_t)a, sb = (int32_t)b;
          switch (f3) {
            case 0: val = (uint32_t)(a * b); break;
            case 1: val = (uint32_t)(((int64_t)sa * sb) >> 32); break;
            case 2: val = (uint32_t)(((int64_t)sa * (uint64_t)b) >> 32); break;
            case 3: val = (uint32_t)(((uint64_t)a * b) >> 32); break;
            case 4:
              val = b == 0 ? M32v
                    : (sa == INT32_MIN && sb == -1)
                        ? a
                        : (uint32_t)(sa / sb);
              break;
            case 5: val = b == 0 ? M32v : a / b; break;
            case 6:
              val = b == 0 ? a
                    : (sa == INT32_MIN && sb == -1) ? 0
                                                    : (uint32_t)(sa % sb);
              break;
            case 7: val = b == 0 ? a : a % b; break;
          }
          wrote = true;
          break;
        }
        uint32_t sh = o2 & 0x1F;
        switch (f3) {
          case 0:
            val = (!immmode && (f7 & 0x20)) ? a - o2 : a + o2;
            break;
          case 1: val = a << sh; break;
          case 2: val = (int32_t)a < (int32_t)o2 ? 1 : 0; break;
          case 3: val = a < o2 ? 1 : 0; break;
          case 4: val = a ^ o2; break;
          case 5:
            // imm-mode encodes sra in the imm's bit 10
            if ((immmode && (word & (1u << 30))) || (!immmode && (f7 & 0x20)))
              val = (uint32_t)((int32_t)a >> sh);
            else
              val = a >> sh;
            break;
          case 6: val = a | o2; break;
          case 7: val = a & o2; break;
        }
        wrote = true;
        break;
      }
      case 0b1110011: {  // ECALL
        uint32_t t0 = regs[5], a0 = regs[10];
        if (t0 == 0) {
          *exit_code = (int32_t)a0;
          *total_cycles = cycles;
          *journal_len = jlen;
          return 0;
        } else if (t0 == 1) {
          if (jlen >= journal_cap) return fail("journal overflow");
          journal_out[jlen++] = a0;
        } else if (t0 == 2) {
          if (input_pos >= n_input) return fail("guest read past end of input");
          regs[10] = input_words[input_pos++];
        } else if (t0 == 3) {
          // LOG: byte-based host effect; ignored in exec-only mode
        } else if (t0 == 4) {
          // VERIFY word: recorded by the python wrapper via journal tags?
          // exec-only mode ignores (cycle accounting identical)
        } else if (t0 == 5) {
          uint64_t st[25];
          for (int i = 0; i < 25; i++) {
            uint64_t lo = mem.load_word(a0 + 8 * i);
            uint64_t hi = mem.load_word(a0 + 8 * i + 4);
            st[i] = lo | (hi << 32);
          }
          keccakf(st);
          for (int i = 0; i < 25; i++) {
            mem.store_word(a0 + 8 * i, (uint32_t)st[i]);
            mem.store_word(a0 + 8 * i + 4, (uint32_t)(st[i] >> 32));
          }
          cycles += 49;  // 50-row burst (air/rv32im.py keccak ecall)
        } else {
          return fail("unknown ecall");
        }
        break;
      }
      case 0b0001111: break;  // FENCE
      default:
        return fail("illegal instruction");
    }
    if (wrote && rd != 0) regs[rd] = val;
    pc = next_pc;
  }
}

// ---------------------------------------------------------------------------
// Segmenting executor: one continuation segment per call (the cycle-hot
// half of zkvm/executor.py::Executor._run_segment — SURVEY §2.4 lists
// the rv32im executor as a required native component). Python keeps the
// session state (memory dict, seqs, journals) and applies the write-set
// this call returns; budgets and stop discipline mirror the Python
// Executor exactly (bit-identical segmentation, diffed in tests).
// ---------------------------------------------------------------------------

extern "C" int bt_run_segment(
    const uint32_t* mem_addrs, const uint32_t* mem_vals, int n_mem,
    uint32_t pre_pc, uint32_t* regs /*32 in-out*/,
    const uint32_t* inputs, int n_inputs, int64_t* input_pos /*in-out*/,
    int64_t segment_limit, int64_t mem_op_budget, int mem_pages_budget,
    int cp_io_budget,
    // outputs
    int64_t* out_cycles, uint32_t* post_pc, int32_t* halted_out,
    int32_t* exit_code,
    uint32_t* reads_out, int reads_cap, int32_t* n_reads,
    uint32_t* journal_out, int jcap, int32_t* n_journal,
    uint32_t* verify_out, int vcap, int32_t* n_verify,
    uint8_t* log_out, int lcap, int32_t* n_log,
    uint32_t* writes_addr, uint32_t* writes_val, int wcap,
    int32_t* n_writes,
    uint64_t* kec_pre_out /*25 lanes per perm*/, int kec_cap,
    int32_t* n_kec,
    int64_t* touched_pages_out, int tp_cap, int32_t* n_tpages,
    char* err, int err_len) {
  Mem mem;
  mem.words.reserve(n_mem * 2);
  for (int i = 0; i < n_mem; i++) mem.words[mem_addrs[i]] = mem_vals[i];
  std::unordered_map<uint32_t, uint32_t> dirty;  // write-set (word addr)
  std::unordered_map<uint32_t, bool> tpages;
  uint32_t pc = pre_pc;
  int64_t cycles = 0;
  int64_t mem_ops = 0;
  int64_t seg_cp = 0;
  int nr = 0, nj = 0, nv = 0, nl = 0, nk = 0;
  *halted_out = 0;

  auto fail = [&](const char* msg) {
    snprintf(err, err_len, "%s (pc=0x%x cycle=%lld)", msg, pc,
             (long long)cycles);
    return 1;
  };

  // _touch: returns 0 ok, 1 = budget stop (flush segment, instruction
  // re-runs next segment), mirrors executor.py::_touch exactly
  auto touch = [&](uint32_t addr) -> int {
    if (mem_ops + 2 > mem_op_budget) return 1;
    mem_ops += 2;
    uint32_t pg = (addr >> 2) / 64;
    if (!tpages.count(pg)) {
      if ((int)tpages.size() >= mem_pages_budget) return 1;
      tpages[pg] = true;
    }
    return 0;
  };
  auto store_word = [&](uint32_t addr, uint32_t v) {
    mem.store_word(addr, v);
    dirty[addr & ~3u] = v;
  };

  while (cycles < segment_limit) {
    if (pc & 3) return fail("misaligned pc");
    uint32_t word = mem.load_word(pc);
    uint32_t op = word & 0x7F;
    uint32_t rd = (word >> 7) & 0x1F;
    uint32_t f3 = (word >> 12) & 0x7;
    uint32_t rs1 = (word >> 15) & 0x1F;
    uint32_t rs2 = (word >> 20) & 0x1F;
    uint32_t f7 = (word >> 25) & 0x7F;
    uint32_t a = regs[rs1], b = regs[rs2];
    uint32_t next_pc = pc + 4;
    bool wrote = false;
    uint32_t val = 0;
    int64_t cost = 1;
    bool budget_stop = false;

    switch (op) {
      case 0b0110111: val = word & 0xFFFFF000u; wrote = true; break;
      case 0b0010111: val = pc + (word & 0xFFFFF000u); wrote = true; break;
      case 0b1101111: {  // JAL
        int32_t imm = sext((((word >> 31) & 1) << 20) |
                               (((word >> 12) & 0xFF) << 12) |
                               (((word >> 20) & 1) << 11) |
                               (((word >> 21) & 0x3FF) << 1),
                           21);
        val = next_pc;
        wrote = true;
        next_pc = pc + imm;
        break;
      }
      case 0b1100111: {  // JALR
        int32_t imm = sext(word >> 20, 12);
        val = next_pc;
        wrote = true;
        next_pc = (a + imm) & ~1u;
        break;
      }
      case 0b1100011: {  // BRANCH
        int32_t imm = sext((((word >> 31) & 1) << 12) |
                               (((word >> 7) & 1) << 11) |
                               (((word >> 25) & 0x3F) << 5) |
                               (((word >> 8) & 0xF) << 1),
                           13);
        bool taken;
        switch (f3) {
          case 0: taken = a == b; break;
          case 1: taken = a != b; break;
          case 4: taken = (int32_t)a < (int32_t)b; break;
          case 5: taken = (int32_t)a >= (int32_t)b; break;
          case 6: taken = a < b; break;
          case 7: taken = a >= b; break;
          default: return fail("bad branch f3");
        }
        if (taken) next_pc = pc + imm;
        break;
      }
      case 0b0000011: {  // LOAD
        uint32_t addr = a + sext(word >> 20, 12);
        if (touch(addr)) { budget_stop = true; break; }
        uint32_t w = mem.load_word(addr);
        uint32_t sh = (addr & 3) * 8;
        switch (f3) {
          case 0: val = (uint32_t)sext((w >> sh) & 0xFF, 8); break;
          case 1:
            if (addr & 1) return fail("misaligned halfword load");
            val = (uint32_t)sext((w >> sh) & 0xFFFF, 16);
            break;
          case 2:
            if (addr & 3) return fail("misaligned word load");
            val = w;
            break;
          case 4: val = (w >> sh) & 0xFF; break;
          case 5:
            if (addr & 1) return fail("misaligned halfword load");
            val = (w >> sh) & 0xFFFF;
            break;
          default: return fail("bad load f3");
        }
        wrote = true;
        break;
      }
      case 0b0100011: {  // STORE
        int32_t imm = sext(((word >> 25) << 5) | ((word >> 7) & 0x1F), 12);
        uint32_t addr = a + imm;
        if (touch(addr)) { budget_stop = true; break; }
        uint32_t w = mem.load_word(addr);
        uint32_t sh = (addr & 3) * 8;
        switch (f3) {
          case 0:
            store_word(addr, (w & ~(0xFFu << sh)) | ((b & 0xFF) << sh));
            break;
          case 1:
            if (addr & 1) return fail("misaligned halfword store");
            store_word(addr,
                       (w & ~(0xFFFFu << sh)) | ((b & 0xFFFF) << sh));
            break;
          case 2:
            if (addr & 3) return fail("misaligned word store");
            store_word(addr, b);
            break;
          default: return fail("bad store f3");
        }
        break;
      }
      case 0b0010011:    // ALU-IMM
      case 0b0110011: {  // ALU-REG
        bool immmode = op == 0b0010011;
        uint32_t o2 = immmode ? (uint32_t)sext(word >> 20, 12) : b;
        if (!immmode && f7 == 1) {  // M extension
          int64_t sa = (int32_t)a, sb = (int32_t)b;
          switch (f3) {
            case 0: val = (uint32_t)(a * b); break;
            case 1: val = (uint32_t)(((int64_t)sa * sb) >> 32); break;
            case 2:
              val = (uint32_t)(((int64_t)sa * (uint64_t)b) >> 32);
              break;
            case 3: val = (uint32_t)(((uint64_t)a * b) >> 32); break;
            case 4:
              val = b == 0 ? M32v
                    : (sa == INT32_MIN && sb == -1) ? a
                                                    : (uint32_t)(sa / sb);
              break;
            case 5: val = b == 0 ? M32v : a / b; break;
            case 6:
              val = b == 0 ? a
                    : (sa == INT32_MIN && sb == -1) ? 0
                                                    : (uint32_t)(sa % sb);
              break;
            case 7: val = b == 0 ? a : a % b; break;
          }
          wrote = true;
          break;
        }
        uint32_t sh = o2 & 0x1F;
        switch (f3) {
          case 0:
            val = (!immmode && (f7 & 0x20)) ? a - o2 : a + o2;
            break;
          case 1: val = a << sh; break;
          case 2: val = (int32_t)a < (int32_t)o2 ? 1 : 0; break;
          case 3: val = a < o2 ? 1 : 0; break;
          case 4: val = a ^ o2; break;
          case 5:
            if ((immmode && (word & (1u << 30))) || (!immmode && (f7 & 0x20)))
              val = (uint32_t)((int32_t)a >> sh);
            else
              val = a >> sh;
            break;
          case 6: val = a | o2; break;
          case 7: val = a & o2; break;
        }
        wrote = true;
        break;
      }
      case 0b1110011: {  // ECALL
        uint32_t t0 = regs[5], a0 = regs[10], a1 = regs[11];
        if (t0 == 0) {  // HALT (consumes its cycle; pc advances)
          *exit_code = (int32_t)a0;
          *halted_out = 1;
        } else if (t0 == 1) {  // COMMIT
          if (nj >= jcap) return fail("journal overflow");
          journal_out[nj++] = a0;
        } else if (t0 == 2) {  // READ
          if (*input_pos >= n_inputs)
            return fail("guest read past end of input");
          if (nr >= reads_cap) return fail("reads overflow");
          uint32_t wv = inputs[(*input_pos)++];
          reads_out[nr++] = wv;
          regs[10] = wv;
        } else if (t0 == 3) {  // LOG (byte loads charge the budget;
          // bytes land only if the whole read succeeds — executor.py
          // read_bytes raises before appending)
          bool stop = false;
          int nl0 = nl;
          for (uint32_t i = 0; i < a1; i++) {
            if (touch(a0 + i)) { stop = true; break; }
            uint32_t w = mem.load_word(a0 + i);
            uint8_t byte = (w >> (8 * ((a0 + i) & 3))) & 0xFF;
            if (nl < lcap) log_out[nl++] = byte;
          }
          if (stop) { nl = nl0; budget_stop = true; break; }
        } else if (t0 == 4) {  // VERIFY
          if (nv >= vcap) return fail("verify overflow");
          verify_out[nv++] = a0;
        } else if (t0 == 5) {  // KECCAK (50-cycle burst)
          if (mem_ops + 200 > mem_op_budget) { budget_stop = true; break; }
          if (cycles + 50 > segment_limit) {
            if (cycles == 0)
              return fail(
                  "keccak burst does not fit in one segment "
                  "(segment_po2 too small)");
            budget_stop = true;
            break;
          }
          if (seg_cp + 100 > cp_io_budget) { budget_stop = true; break; }
          // loads precede stores; page-budget stop stays clean
          uint64_t st[25];
          bool stop = false;
          for (int i = 0; i < 25 && !stop; i++) {
            if (touch(a0 + 8 * i) || touch(a0 + 8 * i + 4)) {
              stop = true;
              break;
            }
            if (((a0 + 8 * i) & 3) || ((a0 + 8 * i + 4) & 3))
              return fail("misaligned word load");
            uint64_t lo = mem.load_word(a0 + 8 * i);
            uint64_t hi = mem.load_word(a0 + 8 * i + 4);
            st[i] = lo | (hi << 32);
          }
          if (stop) { budget_stop = true; break; }
          if (nk >= kec_cap) return fail("keccak perms overflow");
          for (int i = 0; i < 25; i++) kec_pre_out[25 * nk + i] = st[i];
          nk++;
          seg_cp += 100;
          keccakf(st);
          for (int i = 0; i < 25; i++) {
            if (touch(a0 + 8 * i) || touch(a0 + 8 * i + 4))
              return fail("keccak store budget (unreachable)");
            store_word(a0 + 8 * i, (uint32_t)st[i]);
            store_word(a0 + 8 * i + 4, (uint32_t)(st[i] >> 32));
          }
          cost = 50;
        } else {
          return fail("unknown ecall");
        }
        break;
      }
      case 0b0001111: break;  // FENCE
      default:
        return fail("illegal instruction");
    }
    if (budget_stop) {
      if (cycles == 0)
        return fail("instruction exceeds the segment page budget");
      break;
    }
    if (wrote && rd != 0) regs[rd] = val;
    pc = next_pc;
    cycles += cost;
    if (*halted_out) break;
  }
  // collect outputs
  {
    int nw = 0;
    for (auto& kv : dirty) {
      if (nw >= wcap) return fail("write-set overflow");
      writes_addr[nw] = kv.first;
      writes_val[nw] = kv.second;
      nw++;
    }
    *n_writes = nw;
    int ntp = 0;
    for (auto& kv : tpages) {
      if (ntp >= tp_cap) return fail("touched-pages overflow");
      touched_pages_out[ntp++] = (int64_t)kv.first;
    }
    *n_tpages = ntp;
  }
  *out_cycles = cycles;
  *post_pc = pc;
  *n_reads = nr;
  *n_journal = nj;
  *n_verify = nv;
  *n_log = nl;
  *n_kec = nk;
  return 0;
}
