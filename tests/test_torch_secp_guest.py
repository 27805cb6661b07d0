"""The port's in-guest secp256k1 (`boundless_tpu_torch/zkvm/
secp256k1_guest.py`) against the JAX package's, exactly.

Every self-test image and the production assessor image assemble to the
same words, entry and image id in both packages; the native exec-only
interpreter (`fast_execute`) gives the same cycles, exit code and journal
on the same inputs (operands drawn from a numpy seed, signatures from the
host wallet); a wrong signer, a tampered digest and a high-s signature
fault in both.
"""

import numpy as np
import pytest

from boundless_tpu.market import crypto as jcrypto
from boundless_tpu.zkvm import executor as jexec
from boundless_tpu.zkvm import guests as jguests
from boundless_tpu.zkvm import secp256k1_guest as jsg
from boundless_tpu_torch.market import crypto as pcrypto
from boundless_tpu_torch.zkvm import executor as pexec
from boundless_tpu_torch.zkvm import guests as pguests
from boundless_tpu_torch.zkvm import secp256k1_guest as psg

OPS = ("mulred_p", "mulred_n", "addmod_p", "submod_p", "powmod_p", "inv_n",
       "dsmul", "recover")
SEED = 2604


def _big(rng, mod):
    words = rng.integers(0, 1 << 32, size=8, dtype=np.uint64)
    return sum(int(w) << (32 * i) for i, w in enumerate(words)) % mod


def _sig_words(sg, digest, sig, addr_hex):
    z = int.from_bytes(digest, "big")
    r = int.from_bytes(sig[:32], "big")
    s = int.from_bytes(sig[32:64], "big")
    addr = bytes.fromhex(addr_hex[2:])
    addr_w = [int.from_bytes(addr[4 * i: 4 * i + 4], "little")
              for i in range(5)]
    return (sg.int_words(z) + sg.int_words(r) + sg.int_words(s) + [sig[64]]
            + addr_w)


def _signed(seed=b"secp-parity"):
    w = jcrypto.Wallet.from_seed(seed)
    digest = jcrypto.keccak256(b"boundless parity " + seed)
    return w, digest, w.sign(digest)


def _operands(op, rng):
    """Input words of `op`, the same for both packages."""
    sg = jsg
    if op in ("mulred_p", "addmod_p", "submod_p"):
        return sg.int_words(_big(rng, sg.P)) + sg.int_words(_big(rng, sg.P))
    if op == "mulred_n":
        return sg.int_words(_big(rng, sg.N)) + sg.int_words(_big(rng, sg.N))
    if op == "powmod_p":
        return sg.int_words(_big(rng, sg.P)) + sg.int_words(
            (sg.P + 1) // 4)
    if op == "inv_n":
        return sg.int_words(_big(rng, sg.N - 1) + 1)
    if op == "dsmul":
        u1, u2 = _big(rng, 1 << 128), _big(rng, 1 << 128)
        R = jcrypto._mul(int(rng.integers(2, 1 << 30)), jcrypto._G)
        return (sg.int_words(u1) + sg.int_words(u2) + sg.int_words(R[0])
                + sg.int_words(R[1]))
    w, digest, sig = _signed()
    return _sig_words(sg, digest, sig, w.address)


def _image_tuple(img):
    return sorted(img.words.items()), img.entry, img.image_id()


@pytest.mark.parametrize("op", OPS + ("assessor_ecdsa",))
def test_images_equal_jax(op):
    if op == "assessor_ecdsa":
        j, p = jsg.assessor_ecdsa(), psg.assessor_ecdsa()
    else:
        j, p = jsg.selftest_guest(op), psg.selftest_guest(op)
    assert _image_tuple(p) == _image_tuple(j)


def test_constants_equal_jax():
    names = ("P", "N", "GX", "GY", "C_P", "C_N", "JBUF_WORDS", "STACK_TOP")
    assert [getattr(psg, n) for n in names] == [getattr(jsg, n)
                                                for n in names]
    rng = np.random.default_rng(SEED)
    for _ in range(8):
        x = _big(rng, 1 << 256)
        assert psg.int_words(x) == jsg.int_words(x)


@pytest.mark.parametrize("op", OPS)
def test_fast_execute_equals_jax(op):
    inp = _operands(op, np.random.default_rng(SEED + OPS.index(op)))
    want = jexec.fast_execute(jsg.selftest_guest(op), jguests.words(inp))
    got = pexec.fast_execute(psg.selftest_guest(op), pguests.words(inp))
    assert got == want
    assert got[1] == 0 and len(got[2]) > 0


def _bad_signature(case):
    w, digest, sig = _signed()
    if case == "wrong_signer":
        other = jcrypto.Wallet.from_seed(b"some other key")
        return _sig_words(jsg, digest, sig, other.address)
    if case == "tampered_digest":
        bad = bytes([digest[0] ^ 1]) + digest[1:]
        return _sig_words(jsg, bad, sig, w.address)
    s = int.from_bytes(sig[32:64], "big")
    high = (jsg.N - s).to_bytes(32, "big")  # the malleable twin (EIP-2)
    return _sig_words(jsg, digest, sig[:32] + high + bytes([sig[64] ^ 1]),
                      w.address)


@pytest.mark.parametrize("case", ("wrong_signer", "tampered_digest",
                                  "high_s"))
def test_bad_signatures_fault_in_both(case):
    inp = _bad_signature(case)
    with pytest.raises(jexec.GuestFault):
        jexec.fast_execute(jsg.selftest_guest("recover"), jguests.words(inp))
    with pytest.raises(pexec.GuestFault):
        pexec.fast_execute(psg.selftest_guest("recover"), pguests.words(inp))


def test_host_signature_material_equal_jax():
    """The signature the guests recover comes from the port's own wallet
    with the same bytes as JAX's."""
    jw, digest, sig = _signed()
    pw = pcrypto.Wallet.from_seed(b"secp-parity")
    assert pw.address == jw.address
    assert pcrypto.keccak256(b"boundless parity secp-parity") == digest
    assert pw.sign(digest) == sig
