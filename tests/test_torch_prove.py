"""Whole-slice parity: the port's CPU proof equals the JAX golden proof.

`tests/data/torch_golden_po2_8.npz` holds the JAX package's jitted
`stark.prove` output on the `__graft_entry__._example` inputs (echo guest,
po2 8, TEST_PS, blinding seed fixed), for both AIR variants; regenerate it
with `tests/data/make_torch_golden.py`. The port must reproduce every word.
The `slow` case recomputes the golden live with JAX (minutes of XLA
compile) and runs the JAX verifier on the port's proof."""

import os

import numpy as np
import pytest
import torch

from boundless_tpu_torch import convert
from boundless_tpu_torch.core import field as F
from boundless_tpu_torch.prover import stark
from boundless_tpu_torch.zkvm import prove

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "torch_golden_po2_8.npz")
PO2 = 8
VARIANTS = ["rv32im", "rv32i"]


def golden(variant):
    """(data, ctrl, pub tensors, golden proof dict) for one variant."""
    g = np.load(GOLDEN)
    pre = variant + "/"
    pub = convert.pub_from_numpy({k[len(pre + "in.pub."):]: g[k]
                                  for k in g.files
                                  if k.startswith(pre + "in.pub.")})
    proof = {k[len(pre + "proof."):]: g[k] for k in g.files
             if k.startswith(pre + "proof.")}
    return (F.fp(g[pre + "in.data"].astype(np.int64)),
            F.fp(g[pre + "in.ctrl"].astype(np.int64)), pub, proof)


def assert_proof_equal(flat, gold):
    assert sorted(flat) == sorted(gold)
    for k in gold:
        np.testing.assert_array_equal(flat[k], gold[k], err_msg=k)


@pytest.mark.parametrize("variant", VARIANTS)
def test_port_proof_equals_jax_golden(variant):
    data, ctrl, pub, gold = golden(variant)
    proof = stark.prove(prove._AIRS[variant], data, pub, PO2, prove.TEST_PS,
                        ctrl)
    assert_proof_equal(convert.proof_to_numpy(proof), gold)


def test_image_id_is_the_golden_control_root():
    from boundless_tpu_torch.zkvm import guests

    _, _, _, gold = golden("rv32im")
    want = F.from_mont(convert.tensor(gold["ctrl_root"])).numpy()
    np.testing.assert_array_equal(
        prove.image_id_of(guests.echo(), PO2, prove.TEST_PS, device="cpu"),
        want)


@pytest.mark.parametrize("variant", VARIANTS)
def test_fused_route_proof_equals_jax_golden(variant, monkeypatch):
    """The card's quotient route (constraint kernel rows, masked α-combine
    per class), here on the kernel's plain version, reproduces the golden."""
    monkeypatch.setattr(stark, "_fused_route", lambda air, device: True)
    data, ctrl, pub, gold = golden(variant)
    proof = stark.prove(prove._AIRS[variant], data, pub, PO2, prove.TEST_PS,
                        ctrl)
    assert_proof_equal(convert.proof_to_numpy(proof), gold)


@pytest.fixture
def one_torch_thread():
    """In a process that has imported JAX, torch's multi-threaded int64
    kernels run several times slower than on one thread (the po2-12 check
    below: about 60 s against 15 s)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_fused_and_degree_split_quotients_are_equal(one_torch_thread):
    """At po2 12 (n >= SPLIT_MIN_ROWS, so the degree split runs on the N,
    2N and 4N grids) the fused route's quotient coefficients equal the
    degree-split route's word for word."""
    from boundless_tpu_torch.core import ntt as NTT
    from boundless_tpu_torch.zkvm import guests, witness
    from boundless_tpu_torch.zkvm.executor import Executor

    po2 = 12
    assert 1 << po2 >= stark.SPLIT_MIN_ROWS
    image = guests.echo()
    seg = Executor(image, guests.words([2, 11, 22]),
                   segment_po2=po2).run().segments[0]
    w = witness.trace_segment_native(image, seg, po2,
                                     rng=np.random.default_rng(3))
    air = prove._AIRS[prove.air_variant_of(image, seg)]
    data = F.fp(witness.data_for_variant(w.data, air.name))
    ctrl, pub = F.fp(w.ctrl), witness.to_public_values(w.pub)
    globals_ = F.ext(np.arange(8).reshape(2, 4) + 5)
    alpha = F.ext(np.arange(4) + 9)
    accum = air.accum_trace(ctrl, data, globals_)
    evals = [NTT.coset_evaluate(NTT.interpolate(x)) for x in
             (ctrl, data, accum)]
    assert len(stark._cons_plan(air, pub, po2)[1]) == 3  # N, 2N, 4N grids
    split = stark._quotient_coeffs(air, po2, evals, globals_, pub, alpha,
                                   fused=False)
    fused = stark._quotient_coeffs(air, po2, evals, globals_, pub, alpha,
                                   fused=True)
    assert torch.equal(split, fused)
    assert bool((split[1 << po2:] != 0).any())  # degree > N: a real test


def test_prove_segment_defaults_to_the_card():
    """Without `device=` the entry points target CUDA; with no card they
    raise instead of proving on the CPU."""
    import inspect

    from boundless_tpu_torch.zkvm import guests
    from boundless_tpu_torch.zkvm.executor import Executor

    for fn in (prove.prove_segment, prove.image_id_of, prove._image_ctrl):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    seg = Executor(guests.echo(), guests.words([1, 5]),
                   segment_po2=PO2).run().segments[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prove.prove_segment(guests.echo(), seg, prove.TEST_PS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prove.image_id_of(guests.echo(), PO2, prove.TEST_PS)


def test_golden_file_is_small_and_complete():
    assert os.path.getsize(GOLDEN) < 1 << 20
    g = np.load(GOLDEN)
    for variant in VARIANTS:
        assert f"{variant}/proof.fri_proof.final_coeffs" in g.files
        assert g[f"{variant}/in.data"].shape == (
            1 << PO2, prove._AIRS[variant].data_cols)


@pytest.mark.slow
@pytest.mark.parametrize("variant", VARIANTS)
def test_live_jax_golden_and_cross_verify(variant, monkeypatch):
    """Recompute the golden with the JAX prover, and verify the port's
    proof with the (jitted) JAX verifier."""
    import jax
    import jax.numpy as jnp

    from boundless_tpu.prover import stark as JSTARK
    from boundless_tpu.zkvm import prove as JPROVE

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(root)
    monkeypatch.syspath_prepend(os.path.join(root, "tests", "data"))
    import make_torch_golden

    monkeypatch.setenv("BT_ZK_SEED", make_torch_golden.ZK_SEED)
    _, jpub, _, jproof = make_torch_golden.jax_proof(variant)
    data, ctrl, pub, gold = golden(variant)
    assert_proof_equal(convert.proof_to_numpy(jproof), gold)

    proof = stark.prove(prove._AIRS[variant], data, pub, PO2, prove.TEST_PS,
                        ctrl)
    flat = convert.proof_to_numpy(proof)  # leaves in pytree order
    as_jax = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jproof),
        [jnp.asarray(v) for v in flat.values()])
    verifier = JSTARK.make_verifier(JPROVE._AIRS[variant], PO2,
                                    JPROVE.TEST_PS)
    assert bool(verifier(as_jax, jpub, jnp.asarray(flat["ctrl_root"])))
