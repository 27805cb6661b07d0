// Recursion-VM evaluator (witness generation for the recursion circuit).
//
// C++ port of recursion/vm.py::evaluate — bit-identical
// canonical data traces, ~100x faster than the Python replay. This is
// the TPU-native equivalent of the reference's recursion-circuit witness
// generator (risc0-circuit-recursion-sys preflight; SURVEY.md §2.4:
// witness generation is one of the C++-required host hot paths).
//
// Layout contracts (must mirror vm.py):
//   ops: OPS order gen=0,input=1,bit=2,pub=3,inv=4,az=5,ppre=6,pext=7,
//        pint=8,pabs=9,pzero=10,pout=11
//   GEN K: imm[0:4], cmul@4, ca@5, cb@6, cc@7, pmulw[8:12]
//   data row (64 cols): in1[0:4] in2[4:8] in3[8:12] out[12:16]
//        st[16:40] x3[40:64]
//   hints: kind 0=none,1=in,2=pad,3=bit(src,comp,idx),4=eqz(src,comp)
//   PUB rows: group = argmax(K[0:6])

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

constexpr uint64_t P = 2013265921ULL;  // Baby Bear, 15*2^27 + 1
constexpr uint64_t BETA = 11ULL;       // x^4 - BETA

inline uint64_t addm(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  return s >= P ? s - P : s;
}
inline uint64_t subm(uint64_t a, uint64_t b) { return a >= b ? a - b : a + P - b; }
inline uint64_t mulm(uint64_t a, uint64_t b) { return (a * b) % P; }

inline uint64_t powm(uint64_t b, uint64_t e) {
  uint64_t r = 1;
  b %= P;
  while (e) {
    if (e & 1) r = mulm(r, b);
    b = mulm(b, b);
    e >>= 1;
  }
  return r;
}

struct Ext {
  uint64_t c[4];
};

inline Ext ext_zero() { return Ext{{0, 0, 0, 0}}; }

inline Ext ext_add(const Ext& a, const Ext& b) {
  Ext r;
  for (int i = 0; i < 4; i++) r.c[i] = addm(a.c[i], b.c[i]);
  return r;
}

inline Ext ext_scale(const Ext& a, uint64_t s) {
  Ext r;
  for (int i = 0; i < 4; i++) r.c[i] = mulm(a.c[i], s);
  return r;
}

inline Ext ext_mul(const Ext& a, const Ext& b) {
  const uint64_t *x = a.c, *y = b.c;
  Ext r;
  r.c[0] = addm(mulm(x[0], y[0]),
                mulm(BETA, addm(addm(mulm(x[1], y[3]), mulm(x[2], y[2])),
                                mulm(x[3], y[1]))));
  r.c[1] = addm(addm(mulm(x[0], y[1]), mulm(x[1], y[0])),
                mulm(BETA, addm(mulm(x[2], y[3]), mulm(x[3], y[2]))));
  r.c[2] = addm(addm(mulm(x[0], y[2]), addm(mulm(x[1], y[1]), mulm(x[2], y[0]))),
                mulm(BETA, mulm(x[3], y[3])));
  r.c[3] = addm(addm(mulm(x[0], y[3]), mulm(x[1], y[2])),
                addm(mulm(x[2], y[1]), mulm(x[3], y[0])));
  return r;
}

inline Ext ext_inv(const Ext& a) {
  // mirrors vm.py py_ext_inv (norm map; inv(0) = 0)
  Ext abar{{a.c[0], subm(0, a.c[1]), a.c[2], subm(0, a.c[3])}};
  Ext n1 = ext_mul(a, abar);
  uint64_t e0 = n1.c[0], e2 = n1.c[2];
  uint64_t norm = subm(mulm(e0, e0), mulm(BETA, mulm(e2, e2)));
  if (norm == 0) return ext_zero();
  uint64_t ninv = powm(norm, P - 2);
  Ext n1c{{e0, 0, subm(0, e2), 0}};
  Ext out = ext_mul(abar, n1c);
  return ext_scale(out, ninv);
}

inline uint64_t sbox7(uint64_t x) {
  uint64_t x3 = mulm(mulm(x, x), x);
  return mulm(mulm(x3, x3), x);
}

enum Op { GEN = 0, INPUT, BIT, PUB, INV, AZ, PPRE, PEXT, PINT, PABS, PZERO, POUT };

constexpr int KW = 24;
constexpr int DCOLS = 64;
constexpr int D_IN1 = 0, D_IN2 = 4, D_IN3 = 8, D_OUT = 12, D_ST = 16, D_X3 = 40;
constexpr int K_IMM = 0, K_CMUL = 4, K_CA = 5, K_CB = 6, K_CC = 7, K_PMULW = 8;

}  // namespace

extern "C" int bt_rec_eval(
    const int32_t* ops,      // (n,)
    const int32_t* addr,     // (n,3)
    const int32_t* en,       // (n,3)
    const int64_t* K,        // (n,24) canonical
    const int32_t* hkind,    // (n,)
    const int32_t* harg,     // (n,3)
    int64_t n,
    const int64_t* inputs,   // (m,4)
    int64_t m,
    const int64_t* pub,      // (24,)
    const int64_t* m_ext,    // (24,24) external Poseidon2 matrix
    const int64_t* mu,       // (24,) internal diagonal
    int64_t* data,           // (n,64) out, canonical
    char* err, int errlen) {
  Ext* wires = new Ext[n];
  uint64_t st[24] = {0};
  uint64_t st_next[24];
  int64_t in_i = 0;
  int rc = 0;

  for (int64_t r = 0; r < n; r++) {
    const int op = ops[r];
    const int64_t* Kr = K + r * KW;
    int64_t* drow = data + r * DCOLS;
    memcpy(st_next, st, sizeof(st));

    Ext rd[3];
    for (int p = 0; p < 3; p++)
      rd[p] = en[r * 3 + p] ? wires[addr[r * 3 + p]] : ext_zero();

    Ext out = ext_zero();
    switch (op) {
      case GEN: {
        Ext acc;
        for (int c = 0; c < 4; c++) acc.c[c] = (uint64_t)Kr[K_IMM + c];
        if (Kr[K_CMUL])
          acc = ext_add(acc, ext_scale(ext_mul(rd[0], rd[1]),
                                       (uint64_t)Kr[K_CMUL]));
        if (Kr[K_PMULW] | Kr[K_PMULW + 1] | Kr[K_PMULW + 2] | Kr[K_PMULW + 3]) {
          uint64_t s = 0;
          for (int c = 0; c < 4; c++)
            s = addm(s, mulm((uint64_t)Kr[K_PMULW + c], rd[0].c[c]));
          acc = ext_add(acc, ext_scale(rd[1], s));
        }
        if (Kr[K_CA]) acc = ext_add(acc, ext_scale(rd[0], (uint64_t)Kr[K_CA]));
        if (Kr[K_CB]) acc = ext_add(acc, ext_scale(rd[1], (uint64_t)Kr[K_CB]));
        if (Kr[K_CC]) acc = ext_add(acc, ext_scale(rd[2], (uint64_t)Kr[K_CC]));
        out = acc;
        break;
      }
      case INPUT: {
        if (hkind[r] == 2) {  // pad
          out = ext_zero();
        } else {
          if (in_i >= m) {
            snprintf(err, errlen, "input stream exhausted at row %lld",
                     (long long)r);
            rc = 1;
            goto done;
          }
          for (int c = 0; c < 4; c++)
            out.c[c] = (uint64_t)inputs[in_i * 4 + c] % P;
          in_i++;
        }
        break;
      }
      case BIT: {
        if (hkind[r] == 4) {  // eqz
          out.c[0] = wires[harg[r * 3]].c[harg[r * 3 + 1]] == 0 ? 1 : 0;
        } else {  // bit (src, comp, idx)
          out.c[0] = (wires[harg[r * 3]].c[harg[r * 3 + 1]] >>
                      harg[r * 3 + 2]) & 1;
        }
        break;
      }
      case PUB: {
        int g = 0;
        for (int i = 1; i < 6; i++)
          if (Kr[i] > Kr[g]) g = i;
        for (int c = 0; c < 4; c++) out.c[c] = (uint64_t)pub[4 * g + c] % P;
        break;
      }
      case INV: {
        out = ext_inv(rd[0]);
        Ext chk = ext_mul(rd[0], out);
        if (!(chk.c[0] == 1 && chk.c[1] == 0 && chk.c[2] == 0 && chk.c[3] == 0)) {
          snprintf(err, errlen, "row %lld: inverse of zero", (long long)r);
          rc = 1;
          goto done;
        }
        break;
      }
      case AZ: {
        if (rd[0].c[0] | rd[0].c[1] | rd[0].c[2] | rd[0].c[3]) {
          snprintf(err, errlen,
                   "row %lld: assert_zero failed: (%llu,%llu,%llu,%llu)",
                   (long long)r, (unsigned long long)rd[0].c[0],
                   (unsigned long long)rd[0].c[1],
                   (unsigned long long)rd[0].c[2],
                   (unsigned long long)rd[0].c[3]);
          rc = 1;
          goto done;
        }
        break;
      }
      case PPRE: {
        for (int j = 0; j < 24; j++) {
          unsigned __int128 acc = 0;
          for (int k = 0; k < 24; k++)
            acc += (uint64_t)m_ext[j * 24 + k] * st[k];
          st_next[j] = (uint64_t)(acc % P);
        }
        break;
      }
      case PEXT: {
        uint64_t y[24], x3[24], sb[24];
        for (int j = 0; j < 24; j++) {
          y[j] = addm(st[j], (uint64_t)Kr[j] % P);
          x3[j] = mulm(mulm(y[j], y[j]), y[j]);
          drow[D_X3 + j] = (int64_t)x3[j];
          sb[j] = mulm(mulm(x3[j], x3[j]), y[j]);
        }
        for (int j = 0; j < 24; j++) {
          unsigned __int128 acc = 0;
          for (int k = 0; k < 24; k++)
            acc += (uint64_t)m_ext[j * 24 + k] * sb[k];
          st_next[j] = (uint64_t)(acc % P);
        }
        break;
      }
      case PINT: {
        uint64_t y0 = addm(st[0], (uint64_t)Kr[0] % P);
        uint64_t x30 = mulm(mulm(y0, y0), y0);
        drow[D_X3] = (int64_t)x30;
        uint64_t v0 = mulm(mulm(x30, x30), y0);
        unsigned __int128 tot = v0;
        for (int j = 1; j < 24; j++) tot += st[j];
        uint64_t totm = (uint64_t)(tot % P);
        st_next[0] = addm(totm, mulm((uint64_t)mu[0], v0));
        for (int j = 1; j < 24; j++)
          st_next[j] = addm(totm, mulm((uint64_t)mu[j], st[j]));
        break;
      }
      case PABS: {
        for (int j = 0; j < 24; j++)
          if (Kr[j]) st_next[j] = addm(st[j], rd[0].c[j % 4]);
        break;
      }
      case PZERO: {
        memset(st_next, 0, sizeof(st_next));
        break;
      }
      case POUT: {
        for (int j = 0; j < 24; j++)
          if (Kr[j]) out.c[j % 4] = st[j];
        break;
      }
      default: {
        snprintf(err, errlen, "row %lld: unknown op %d", (long long)r, op);
        rc = 1;
        goto done;
      }
    }

    wires[r] = out;
    for (int c = 0; c < 4; c++) {
      drow[D_OUT + c] = (int64_t)out.c[c];
      drow[D_IN1 + c] = (int64_t)rd[0].c[c];
      drow[D_IN2 + c] = (int64_t)rd[1].c[c];
      drow[D_IN3 + c] = (int64_t)rd[2].c[c];
    }
    for (int j = 0; j < 24; j++) drow[D_ST + j] = (int64_t)st[j];
    memcpy(st, st_next, sizeof(st));
  }

  if (in_i != m) {
    snprintf(err, errlen, "unconsumed inputs: %lld", (long long)(m - in_i));
    rc = 1;
  }

done:
  delete[] wires;
  return rc;
}
