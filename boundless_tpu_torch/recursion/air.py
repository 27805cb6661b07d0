"""Recursion circuit AIR: one row per recursion-VM op, on torch tensors.

Counterpart of `boundless_tpu/recursion/air.py`: the same columns and
constraints over the port's algebras (`air/dsl.py`), with `accum_trace`'s
running sum the exact int64 prefix sum `dsl.logup_running_sum` in place
of the reference's associative scan. The AIR does not declare the
generated constraint kernel (`fused_cons` is False, as the reference's
`pallas_cons_ok` is unset), so its quotient takes the prover's
degree-split route on the card too.

Equivalent of the reference's recursion circuit
(`risc0-circuit-recursion-sys`, SURVEY.md §2.4; recursion-VM programs are
run by `ProverServer::{lift,join,union,resolve,identity_p254}`,
`prover/crates/workflow/src/tasks/{prove,join,union,resolve}.rs`). A
program built with `vm.Prog` becomes:

  * **ctrl group** — the ROM (op selectors, wire addresses, read enables,
    round constants / immediates). Static per program; its Merkle root is
    the program's control ID.
  * **data group** — the wires: per-row in1/in2/in3/out ext values, the
    24-wide Poseidon2 state (pre-state of the row), and x3 sbox helper
    columns (degree reduction: x3 = y^3 is committed so the sbox
    x^7 = x3^2 * y stays within the composition budget).
  * **accum group** — a LogUp write-once-memory argument tying every
    enabled read port (a_p, in_p) to the multiset of writes
    (rowidx, out) with ROM-static multiplicities.

Constraint families (see vm.py for op semantics):

  GEN    out = imm + cmul*(in1 x in2) + (Σ_c pw_c in1_c)*in2
             + ca*in1 + cb*in2 + cc*in3
  BIT    out0 boolean; out1..3 = 0
  PUB    out_c = Σ_g K_g * pub[4g + c]
  INV    in1 x out = 1
  AZ     in1 = 0, out = 0
  P*     Poseidon2 state transitions (nxt.st from now.st); rows whose op
         does not modify st carry it forward (not_last-gated)

vm.Prog.finalize guarantees that the last row is an inert pad,
so Poseidon transition constraints skip the not_last factor (degree
budget: every family audited <= 5*(N-1), tests/test_recursion_air.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..air import dsl
from ..air.dsl import ExtVal, Rows, VecVal
from ..core import field as F
from ..core import ntt as NTT
from . import vm
from .vm import CC, DC, AC, M_EXT, _MU

NUM_DPOWS = 5  # 1, delta, .., delta^4 (addr + 4 value components)


# ---------------------------------------------------------------------------
# LogUp fingerprints (shared between accum_trace and constraints)
# ---------------------------------------------------------------------------


def _fingerprint(alg, gamma, dpows, addr, val_comps):
    """gamma - (addr + Σ_c delta^{c+1} val_c)  (addr/val base values)."""
    acc = alg.lift(addr)
    for c in range(4):
        acc = alg.eadd(acc, alg.escale(alg.bc(dpows[c + 1], acc),
                                       val_comps[c]))
    return alg.esub(alg.bc(gamma, acc), acc)


def _ports(alg, row, gamma, dpows):
    """(pack_write, [pack_read_p], mcount, [en_p]) for a row accessor."""
    outc = [row.data(DC.out.start + c) for c in range(4)]
    pack_w = _fingerprint(alg, gamma, dpows, row.ctrl(CC.rowidx), outc)
    packs_r = []
    ens = []
    for p, (a_col, en_col, in_sl) in enumerate((
            (CC.a1, CC.en1, DC.in1), (CC.a2, CC.en2, DC.in2),
            (CC.a3, CC.en3, DC.in3))):
        inc = [row.data(in_sl.start + c) for c in range(4)]
        packs_r.append(_fingerprint(alg, gamma, dpows, row.ctrl(a_col), inc))
        ens.append(row.ctrl(en_col))
    return pack_w, packs_r, row.ctrl(CC.mcount), ens


# ---------------------------------------------------------------------------
# The AIR
# ---------------------------------------------------------------------------


class RecursionAir(dsl.Air):
    name = "recursion"
    ctrl_cols = CC.total
    data_cols = DC.total
    accum_cols = AC.total
    globals_count = 2  # gamma, delta
    max_degree = 5
    ctrl_dynamic = True  # the ROM is per-program; its root is the ctrl ID

    def accum_trace(self, ctrl, data, globals_):
        gamma, delta = globals_[0], globals_[1]
        dpows = NTT.ext_powers(delta, NUM_DPOWS)
        n = data.shape[0]
        alg = dsl.BaseAlg(data.device)
        pack_w, packs_r, mcount, ens = _ports(
            alg, Rows.of_trace(ctrl, data), gamma, dpows)
        stacked = torch.stack([p.expand(n, 4) for p in [pack_w] + packs_r])
        invs = F.ext_inv(stacked)  # (4, N, 4) one batched inversion
        out = torch.zeros((n, AC.total), dtype=F.I32, device=data.device)
        inw = F.ext_scale(invs[0], mcount)
        out[:, AC.inw] = inw
        total = inw
        for p in range(3):
            inr = F.ext_scale(invs[p + 1], ens[p])
            out[:, AC.inr[p]] = inr
            total = F.ext_sub(total, inr)
        out[:, AC.running] = dsl.logup_running_sum(total)
        return out

    def constraints(self, alg, now, nxt, globals_, pub):
        gamma, delta = globals_[0], globals_[1]
        dpows = alg.ext_powers(delta, NUM_DPOWS)
        d = Rows(now)
        c = []
        m, add, sub = alg.mul, alg.add, alg.sub
        gm, ga, gs = alg.gmul, alg.gadd, alg.gsub
        B = alg.B
        one = alg.one()

        sel = [d.ctrl(CC.sel.start + i) for i in range(vm.NOPS)]
        s_gen, s_input, s_bit, s_pub, s_inv, s_az, s_ppre, s_pext, \
            s_pint, s_pabs, s_pzero, s_pout = sel
        is_first = d.ctrl(CC.is_first)
        not_last = d.ctrl(CC.not_last)

        in1 = alg.read_ext(now.data, DC.in1.start)
        in2 = alg.read_ext(now.data, DC.in2.start)
        in3 = alg.read_ext(now.data, DC.in3.start)
        out = alg.read_ext(now.data, DC.out.start)
        in1c = [d.data(DC.in1.start + cc) for cc in range(4)]
        outc = [d.data(DC.out.start + cc) for cc in range(4)]
        kcol = [d.ctrl(CC.K.start + j) for j in range(vm.KW)]

        # ---- GEN ----
        imm = alg.read_ext(now.ctrl, CC.K.start + vm.K_IMM)
        expr = alg.esub(out, imm)
        expr = alg.esub(expr, alg.escale(alg.emul(in1, in2),
                                         kcol[vm.K_CMUL]))
        pick = None
        for cc in range(4):
            t = m(kcol[vm.K_PMULW + cc], in1c[cc])
            pick = t if pick is None else add(pick, t)
        expr = alg.esub(expr, alg.escale(in2, pick))
        expr = alg.esub(expr, alg.escale(in1, kcol[vm.K_CA]))
        expr = alg.esub(expr, alg.escale(in2, kcol[vm.K_CB]))
        expr = alg.esub(expr, alg.escale(in3, kcol[vm.K_CC]))
        c.append(dsl_ext(alg, alg.escale(expr, s_gen)))

        # ---- BIT ----
        b = outc[0]
        c.append(m(s_bit, m(b, sub(b, one))))
        c.append(dsl_vec(alg, gm(B(s_bit),
                                 alg.stack([outc[1], outc[2], outc[3]]))))

        # ---- PUB: out_c = Σ_g K_g pub[4g+c] ----
        for cc in range(4):
            acc = None
            for g in range(vm.NPUB_GROUPS):
                t = m(kcol[g], alg.pubval(pub[4 * g + cc]))
                acc = t if acc is None else add(acc, t)
            c.append(m(s_pub, sub(outc[cc], acc)))

        # ---- INV / AZ ----
        ext_one = alg.ext_const([1, 0, 0, 0])
        c.append(dsl_ext(alg, alg.escale(
            alg.esub(alg.emul(in1, out), alg.bc(ext_one, out)), s_inv)))
        c.append(dsl_ext(alg, alg.escale(in1, s_az)))
        c.append(dsl_ext(alg, alg.escale(out, s_az)))

        # ---- Poseidon2 state machine ----
        st = d.datab(slice(DC.st.start, DC.st.stop))      # (M, 24) pre
        stn = Rows(nxt).datab(slice(DC.st.start, DC.st.stop))  # post
        x3 = d.datab(slice(DC.x3.start, DC.x3.stop))
        kblk = d.ctrlb(slice(CC.K.start, CC.K.stop))

        def me_matmul(v_g):
            """M_E @ v as a stacked group (one gweighted per output row)."""
            return alg.stack([alg.gweighted(v_g, M_EXT[j])
                              for j in range(24)])

        # PPRE: st' = M_E st
        c.append(dsl_vec(alg, gm(B(s_ppre), gs(stn, me_matmul(st)))))

        # PEXT: y = st + rc; x3 = y^3; st' = M_E (x3^2 y)
        y = ga(st, kblk)
        c.append(dsl_vec(alg, gm(B(s_pext), gs(x3, gm(gm(y, y), y)))))
        sb = gm(gm(x3, x3), y)
        c.append(dsl_vec(alg, gm(B(s_pext), gs(stn, me_matmul(sb)))))

        # PINT: y0 = st0 + K0; x3_0 = y0^3; v = (x3_0^2 y0, st_1..);
        #       st'_j = Σ v + mu_j v_j
        st0 = d.data(DC.st.start)
        y0 = add(st0, kcol[0])
        x30 = d.data(DC.x3.start)
        c.append(m(s_pint, sub(x30, m(m(y0, y0), y0))))
        v0 = m(m(x30, x30), y0)
        e0 = np.zeros(24, dtype=np.int64)
        e0[0] = 1
        v_g = ga(st, gm(B(sub(v0, st0)), alg.gconst(e0)))
        tot = add(v0, sub(alg.gsum(st), st0))
        target = _bcast_add(alg, tot, gm(v_g, alg.gconst(_MU)))
        c.append(dsl_vec(alg, gm(B(s_pint), gs(stn, target))))

        # PABS: st' = st + K ⊙ tile(in1)
        in1_rep = alg.gconcat([alg.stack(in1c)] * 6)
        c.append(dsl_vec(alg, gm(B(s_pabs), gs(stn, ga(st, gm(kblk,
                                                              in1_rep))))))

        # PZERO: st' = 0
        c.append(dsl_vec(alg, gm(B(s_pzero), stn)))

        # POUT: out_c = Σ_{j ≡ c (mod 4)} K_j st_j
        for cc in range(4):
            idx = [cc + 4 * q for q in range(6)]
            t = alg.gsum(gm(d.ctrlb([CC.K.start + j for j in idx]),
                            d.datab([DC.st.start + j for j in idx])))
            c.append(m(s_pout, sub(outc[cc], t)))

        # carry: ops that don't modify st keep it (last row exempt)
        s_keep = sub(one, add(add(add(add(s_ppre, s_pext), s_pint),
                                  s_pabs), s_pzero))
        c.append(dsl_vec(alg, gm(B(m(not_last, s_keep)), gs(stn, st))))

        # ---- LogUp write-once memory ----
        pack_w, packs_r, mcount, ens = _ports(alg, d, gamma, dpows)
        inw = alg.read_ext(now.accum, AC.inw.start)
        c.append(dsl_ext(alg, alg.esub(alg.emul(inw, pack_w),
                                       alg.lift(mcount))))
        for p in range(3):
            inr = alg.read_ext(now.accum, AC.inr[p].start)
            c.append(dsl_ext(alg, alg.esub(alg.emul(inr, packs_r[p]),
                                           alg.lift(ens[p]))))

        def signed_total(accum_accessor):
            acc = alg.read_ext(accum_accessor, AC.inw.start)
            for p in range(3):
                acc = alg.esub(acc, alg.read_ext(accum_accessor,
                                                 AC.inr[p].start))
            return acc

        R_now = alg.read_ext(now.accum, AC.running.start)
        R_nxt = alg.read_ext(nxt.accum, AC.running.start)
        c.append(dsl_ext(alg, alg.escale(
            alg.esub(alg.esub(R_nxt, R_now), signed_total(nxt.accum)),
            not_last)))
        c.append(dsl_ext(alg, alg.escale(
            alg.esub(R_now, signed_total(now.accum)), is_first)))
        is_last = sub(one, not_last)
        c.append(dsl_ext(alg, alg.escale(R_now, is_last)))

        return c


def _bcast_add(alg, scalar, group):
    """scalar (+) every lane of a group."""
    return alg.gadd(alg.B(scalar), group)


def dsl_ext(alg, v):
    return ExtVal(v)


def dsl_vec(alg, v):
    return VecVal(v)


# ---------------------------------------------------------------------------
# Prove / verify convenience
# ---------------------------------------------------------------------------

AIR = RecursionAir()


def rom_trace(prog: vm.Prog, n: int, device) -> torch.Tensor:
    """Program ROM -> Montgomery ctrl trace (n, CC.total) on `device`."""
    rom = prog.finalize(n).ctrl_trace_np()
    assert rom.shape[0] == n
    return F.fp(rom, device)


def data_trace(prog: vm.Prog, inputs, pub_vals, device) -> torch.Tensor:
    """Execute the program (the C++ evaluator) -> Montgomery data trace
    on `device` (`field.upload`)."""
    return F.upload(vm.evaluate_native(prog, inputs, pub_vals), device)


def pub_array(pub_vals, device) -> torch.Tensor:
    """Canonical pub scalars -> the Montgomery (PUB_VALS,) publics."""
    vals = list(pub_vals) + [0] * (vm.PUB_VALS - len(pub_vals))
    return F.fp(np.asarray(vals, dtype=np.int64), device)
