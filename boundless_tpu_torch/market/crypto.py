"""Ethereum-grade request auth: keccak-256, secp256k1 ECDSA, EIP-712.

The port's copy of `boundless_tpu/market/crypto.py`.

Replaces the round-1 HMAC stand-in (VERDICT #7): requestors sign EIP-712
typed data with secp256k1 keys and the market verifies by public-key
*recovery* — no server-side key registry exists anywhere, matching the
reference trust model (`crates/boundless-market/src/contracts/` EIP-712
bindings; assessor guest ECDSA checks,
`crates/guest/assessor/assessor-guest/src/main.rs:24-115`).

Pure Python by design: these run on the market control plane (sign/verify
a few hundred orders/s is plenty; the reference uses alloy's k256 on the
same host-side paths). keccak-f[1600] is shared with the zkVM's
coprocessor ecall (`zkvm/executor.py:61`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import hmac

from ..zkvm.executor import keccak_f1600

# --------------------------------------------------------------------------
# keccak-256 (Ethereum flavor: pad 0x01 .. 0x80, rate 136 bytes)
# --------------------------------------------------------------------------

_RATE = 136


def keccak256(data: bytes) -> bytes:
    padded = bytearray(data)
    pad_len = _RATE - (len(padded) % _RATE)
    padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80" if pad_len >= 2 \
        else b"\x81"
    state = [0] * 25
    for off in range(0, len(padded), _RATE):
        block = padded[off : off + _RATE]
        for i in range(_RATE // 8):
            state[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        state = keccak_f1600(state)
    out = b"".join(state[i].to_bytes(8, "little") for i in range(4))
    return out


# --------------------------------------------------------------------------
# secp256k1
# --------------------------------------------------------------------------

P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
_G = (GX, GY)


def _inv(a: int, m: int) -> int:
    return pow(a, m - 2, m)


def _add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * _inv(2 * y1, P) % P
    else:
        lam = (y2 - y1) * _inv(x2 - x1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def _mul(k: int, pt):
    acc = None
    add = pt
    while k:
        if k & 1:
            acc = _add(acc, add)
        add = _add(add, add)
        k >>= 1
    return acc


def pubkey(priv: int):
    return _mul(priv, _G)


def _rfc6979_k(priv: int, digest: bytes) -> int:
    """Deterministic nonce (RFC 6979, HMAC-SHA256)."""
    x = priv.to_bytes(32, "big")
    k = b"\x00" * 32
    v = b"\x01" * 32
    k = hmac.new(k, v + b"\x00" + x + digest, "sha256").digest()
    v = hmac.new(k, v, "sha256").digest()
    k = hmac.new(k, v + b"\x01" + x + digest, "sha256").digest()
    v = hmac.new(k, v, "sha256").digest()
    while True:
        v = hmac.new(k, v, "sha256").digest()
        cand = int.from_bytes(v, "big")
        if 1 <= cand < N:
            return cand
        k = hmac.new(k, v + b"\x00", "sha256").digest()
        v = hmac.new(k, v, "sha256").digest()


def sign(priv: int, digest: bytes) -> bytes:
    """65-byte (r ‖ s ‖ v) recoverable signature, low-s normalized."""
    z = int.from_bytes(digest, "big") % N
    while True:
        k = _rfc6979_k(priv, digest)
        R = _mul(k, _G)
        r = R[0] % N
        if r == 0:
            digest = hashlib.sha256(digest).digest()
            continue
        s = _inv(k, N) * (z + r * priv) % N
        if s == 0:
            digest = hashlib.sha256(digest).digest()
            continue
        v = (R[1] & 1) | (2 if R[0] >= N else 0)
        if s > N // 2:  # low-s (EIP-2)
            s = N - s
            v ^= 1
        return r.to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([v])


def recover(digest: bytes, sig: bytes):
    """Recover the signer's public key point; None if invalid."""
    if len(sig) != 65:
        return None
    r = int.from_bytes(sig[:32], "big")
    s = int.from_bytes(sig[32:64], "big")
    v = sig[64]
    # EIP-2: reject high-s (malleable) signatures; sign() always emits
    # low-s, and the reference's alloy/k256 verification rejects s > N/2.
    if not (1 <= r < N and 1 <= s <= N // 2 and v in (0, 1, 2, 3)):
        return None
    x = r + (v >> 1) * N
    if x >= P:
        return None
    y_sq = (pow(x, 3, P) + 7) % P
    y = pow(y_sq, (P + 1) // 4, P)
    if y * y % P != y_sq:
        return None
    if (y & 1) != (v & 1):
        y = P - y
    z = int.from_bytes(digest, "big") % N
    r_inv = _inv(r, N)
    # Q = r^-1 (s*R - z*G)
    pt = _add(_mul(s * r_inv % N, (x, y)),
              _mul((-z * r_inv) % N, _G))
    return pt


def verify(pub, digest: bytes, sig: bytes) -> bool:
    rec = recover(digest, sig)
    return rec is not None and rec == pub


def address_of(pub) -> str:
    raw = pub[0].to_bytes(32, "big") + pub[1].to_bytes(32, "big")
    return "0x" + keccak256(raw)[12:].hex()


def recover_address(digest: bytes, sig: bytes):
    pub = recover(digest, sig)
    return None if pub is None else address_of(pub)


@dataclasses.dataclass(frozen=True)
class Wallet:
    """A secp256k1 keypair with its Ethereum-style address."""

    priv: int
    address: str

    @staticmethod
    def from_key(priv: int) -> "Wallet":
        return Wallet(priv=priv, address=address_of(pubkey(priv)))

    @staticmethod
    def from_seed(seed: bytes) -> "Wallet":
        priv = (int.from_bytes(keccak256(seed), "big") % (N - 1)) + 1
        return Wallet.from_key(priv)

    def sign(self, digest: bytes) -> bytes:
        return sign(self.priv, digest)


# --------------------------------------------------------------------------
# EIP-712 typed-data hashing
# --------------------------------------------------------------------------

def _enc_word(x) -> bytes:
    if isinstance(x, bytes):
        assert len(x) == 32
        return x
    if isinstance(x, bool):
        return int(x).to_bytes(32, "big")
    if isinstance(x, int):
        return (x % 2**256).to_bytes(32, "big")
    if isinstance(x, str) and x.startswith("0x"):  # address
        return bytes.fromhex(x[2:]).rjust(32, b"\x00")
    raise TypeError(type(x))


def type_hash(sig: str) -> bytes:
    return keccak256(sig.encode())


def hash_struct(type_sig: str, fields) -> bytes:
    """keccak256(typeHash ‖ enc(field_1) ‖ ... ) per EIP-712; dynamic
    values (str/bytes) must be pre-hashed by the caller."""
    return keccak256(type_hash(type_sig) + b"".join(_enc_word(f)
                                                    for f in fields))


DOMAIN_TYPE = ("EIP712Domain(string name,string version,uint256 chainId,"
               "address verifyingContract)")


def domain_separator(name: str, version: str, chain_id: int,
                     verifying_contract: str) -> bytes:
    return hash_struct(DOMAIN_TYPE, [
        keccak256(name.encode()), keccak256(version.encode()), chain_id,
        verifying_contract])


def typed_data_digest(domain_sep: bytes, struct_hash: bytes) -> bytes:
    return keccak256(b"\x19\x01" + domain_sep + struct_hash)
