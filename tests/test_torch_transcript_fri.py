"""Port parity: the Fiat-Shamir transcript's sample sequence and FRI
prove/verify on a seeded low-degree vector. Exact equality."""

import numpy as np
import jax.numpy as jnp
import torch

from boundless_tpu.core import field as JF
from boundless_tpu.core import fri as JFRI
from boundless_tpu.core import ntt as JNTT
from boundless_tpu.core.transcript import Transcript as JTranscript
from boundless_tpu_torch import convert
from boundless_tpu_torch.core import fri as FRI
from boundless_tpu_torch.core import ntt as NTT
from boundless_tpu_torch.core.transcript import Transcript

M, QUERIES, MIN_DEG = 1024, 6, 8  # FRI: 2 fold rounds at rate 1/4


def words(shape, seed):
    return np.random.default_rng(seed).integers(0, JF.P, size=shape,
                                                dtype=np.int64)


def t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int64).astype(np.int32))


def j(a):
    return jnp.asarray(np.asarray(a, dtype=np.int64).astype(np.uint32))


def same(port, ref):
    np.testing.assert_array_equal(convert.to_numpy(port).astype(np.int64),
                                  np.asarray(ref).astype(np.int64))


def test_transcript_sample_sequence():
    tr, jtr = Transcript(), JTranscript()
    got, want = [], []
    for step in range(3):
        d = words((8,), step)
        tr.mix_digest(t(d))
        jtr.mix_digest(j(d))
        e = words((13 + step,), 10 + step)
        tr.mix_elems(t(e))
        jtr.mix_elems(j(e))
        for _ in range(5):  # crosses the 16-word pool boundary
            got.append(tr.sample_ext())
            want.append(jtr.sample_ext())
        got.append(tr.sample_elem())
        want.append(jtr.sample_elem())
        got.append(tr.sample_u32())
        want.append(jtr.sample_u32())
        got.append(tr.sample_indices(7, 11))
        want.append(jtr.sample_indices(7, 11))
    for g, w in zip(got, want):
        same(g, w)
    same(tr.state, jtr.state)


def _low_degree_evals():
    """Ext evaluations on GENERATOR*H_M of a degree < M/4 polynomial."""
    coeffs = words((M // 4, 4), 42)
    return NTT.coset_evaluate(t(coeffs), expand=4)


def test_fri_prove_matches_and_verifies():
    evals = _low_degree_evals()
    proof, idx = FRI.prove(Transcript(), evals, QUERIES, MIN_DEG)
    jproof, jidx = JFRI.prove(JTranscript(), j(evals.numpy()), QUERIES,
                              MIN_DEG)
    same(idx, jidx)
    flat, jflat = convert.proof_to_numpy(proof), convert.proof_to_numpy(jproof)
    assert sorted(flat) == sorted(jflat) and len(proof.round_roots) == 2
    for k in jflat:
        same(flat[k], jflat[k])
    ok, vidx, round0 = FRI.verify(Transcript(), proof, M, QUERIES, MIN_DEG)
    assert bool(ok)
    same(vidx, idx)
    same(round0, evals[idx])
    jok, _, _ = JFRI.verify(JTranscript(), jproof, M, QUERIES, MIN_DEG)
    assert bool(jok)


def test_fri_rejects_tamper_and_high_degree():
    evals = _low_degree_evals()
    proof, _ = FRI.prove(Transcript(), evals, QUERIES, MIN_DEG)
    rows = list(proof.round_rows)
    rows[1] = rows[1].clone()
    rows[1][0, 0] = (rows[1][0, 0] + 1) % JF.P
    bad = proof._replace(round_rows=tuple(rows))
    assert not bool(FRI.verify(Transcript(), bad, M, QUERIES, MIN_DEG)[0])
    noise = t(words((M, 4), 7))
    proof, _ = FRI.prove(Transcript(), noise, QUERIES, MIN_DEG)
    assert not bool(FRI.verify(Transcript(), proof, M, QUERIES, MIN_DEG)[0])


def test_fold16_and_group_matrix():
    evals = t(words((256, 4), 3))
    alpha = t(words((4,), 4))
    same(FRI._fold16(evals, alpha, 256, JF.GENERATOR),
         JFRI._fold16(j(evals.numpy()), j(alpha.numpy()), 256, JF.GENERATOR))
    same(FRI._group_matrix(evals, 256),
         JFRI._group_matrix(j(evals.numpy()), 256))
    assert FRI.num_rounds(1 << 18, 256, 2) == JFRI.num_rounds(1 << 18, 256, 2)
    same(NTT.intt(evals), JNTT.intt(j(evals.numpy())))
