"""EVM artifacts for the Groth16 wrap: seal calldata + Solidity verifier.

The reference regenerates its on-chain verifier from the ceremony vk
(`xtask/src/bootstrap_blake3_groth16.rs:43-46` emitting
`contracts/src/blake3-groth16/{Blake3Groth16Verifier,Groth16Verifier,
ControlID}.sol`) and tags seals with a 4-byte selector
(`crates/boundless-market/src/selector.rs:64-92`). This module
(counterpart of `boundless_tpu/groth16/evm.py`, copied) encodes a
`Groth16Receipt`'s seal as selector-tagged calldata (the `fulfill` wire format) and generates a
Solidity verifier contract with the wrap CRS's verifying key and the
recursion allowed-set root baked in as constants — making L7 parity
falsifiable byte-for-byte without an EVM in the loop (the encoding is
round-trip-tested against the Python market spec in tests/test_evm.py).

Seal layout (selector ‖ 8 proof words ‖ 2 public felts, 324 bytes):

    bytes  0..4    selector (0x73c457ba Groth16V3_0 /
                             0x62f049f6 Blake3Groth16V0_1)
    bytes  4..36   A.x      (uint256 BE)          — proof point A (G1)
    bytes 36..68   A.y
    bytes 68..196  B.x.c1, B.x.c0, B.y.c1, B.y.c0 — proof point B (G2;
                   EVM pairing-precompile coefficient order)
    bytes 196..260 C.x, C.y                        — proof point C (G1)
    bytes 260..292 public 1: packed claim digest felt
    bytes 292..324 public 2: packed allowed-root felt

Public input 0 is the constant 1 per Groth16; public 3 (zero) is pinned
in-contract. The on-chain verifier recomputes vk_x = IC0 + p1*IC1 +
p2*IC2 + 0*IC3 and runs one pairing check through precompile 0x8.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from .bn254 import G1

SELECTORS = {"groth16": bytes.fromhex("73c457ba"),
             "blake3_groth16": bytes.fromhex("62f049f6")}


def _u256(x: int) -> bytes:
    return int(x).to_bytes(32, "big")


def _g1_words(p: G1) -> List[int]:
    aff = p.to_affine()
    if aff is None:
        return [0, 0]
    return [aff[0], aff[1]]


def _g2_words(pt) -> List[int]:
    """G2 point -> [x.c1, x.c0, y.c1, y.c0] (EVM precompile order)."""
    (x0, x1), (y0, y1) = pt
    return [x1, x0, y1, y0]


def encode_seal(receipt) -> bytes:
    """Groth16Receipt (real seal) -> selector-tagged calldata bytes."""
    if receipt.dev_mode:
        raise ValueError("dev-mode receipts have no on-chain seal")
    seal = receipt.inner
    words = (_g1_words(seal.proof.a) + _g2_words(seal.proof.b)
             + _g1_words(seal.proof.c)
             + [int(seal.publics[0]), int(seal.publics[1])])
    return SELECTORS[receipt.kind] + b"".join(_u256(w) for w in words)


@dataclasses.dataclass(frozen=True)
class DecodedSeal:
    selector: bytes
    a: Tuple[int, int]
    b: Tuple[Tuple[int, int], Tuple[int, int]]  # ((x0,x1),(y0,y1))
    c: Tuple[int, int]
    publics: Tuple[int, int]


def decode_seal(data: bytes) -> DecodedSeal:
    """Inverse of encode_seal (the market contract's parsing side)."""
    if len(data) != 4 + 10 * 32:
        raise ValueError(f"bad seal length {len(data)}")
    sel = data[:4]
    if sel not in SELECTORS.values():
        raise ValueError(f"unknown seal selector {sel.hex()}")
    w = [int.from_bytes(data[4 + 32 * i : 36 + 32 * i], "big")
         for i in range(10)]
    return DecodedSeal(
        selector=sel, a=(w[0], w[1]),
        b=((w[3], w[2]), (w[5], w[4])),  # c0/c1 back to our (c0, c1)
        c=(w[6], w[7]), publics=(w[8], w[9]))


def verify_decoded(dec: DecodedSeal, vk) -> bool:
    """Run the CONTRACT's verification semantics over decoded calldata
    (the exact pairing equation Groth16Verifier.sol executes), against
    the Python pairing backend — the artifact's executable spec."""
    from . import pairing as PR
    from .protocol import Proof, verify as _verify

    a = G1(dec.a[0], dec.a[1], 1) if dec.a != (0, 0) else G1.infinity()
    c = G1(dec.c[0], dec.c[1], 1) if dec.c != (0, 0) else G1.infinity()
    proof = Proof(a=a, b=dec.b, c=c)
    return _verify(vk, proof, [dec.publics[0], dec.publics[1], 0])


# ---------------------------------------------------------------------------
# Solidity generation (xtask bootstrap role)
# ---------------------------------------------------------------------------

_CONTRACT_TEMPLATE = """\
// SPDX-License-Identifier: Apache-2.0
// AUTO-GENERATED by boundless_tpu.groth16.evm.generate_verifier — the
// bootstrap artifact for the STARK->SNARK wrap (reference:
// xtask/src/bootstrap_blake3_groth16.rs regenerating
// contracts/src/blake3-groth16/Groth16Verifier.sol). Do not edit.
pragma solidity ^0.8.24;

/// @notice Control constants binding this verifier to one recursion
/// allowed-set root (the risc0 ControlID.sol role): seals are valid
/// only for proofs whose public input 2 equals CONTROL_ROOT_FELT.
library ControlID {{
    uint256 internal constant CONTROL_ROOT_FELT = {control_root};
    bytes4 internal constant SELECTOR_GROTH16 = bytes4(0x73c457ba);
    bytes4 internal constant SELECTOR_BLAKE3_GROTH16 = bytes4(0x62f049f6);
}}

/// @notice BN254 Groth16 verifier with the wrap CRS verifying key baked
/// in (snarkjs-template shape, pairing precompile 0x8).
contract Groth16Verifier {{
    // Scalar field size
    uint256 constant r = {R};
    // Base field size
    uint256 constant q = {Q};

    // Verifying key (wrap CRS)
    uint256 constant alphax = {alphax};
    uint256 constant alphay = {alphay};
    uint256 constant betax1 = {betax1};
    uint256 constant betax2 = {betax2};
    uint256 constant betay1 = {betay1};
    uint256 constant betay2 = {betay2};
    uint256 constant gammax1 = {gammax1};
    uint256 constant gammax2 = {gammax2};
    uint256 constant gammay1 = {gammay1};
    uint256 constant gammay2 = {gammay2};
    uint256 constant deltax1 = {deltax1};
    uint256 constant deltax2 = {deltax2};
    uint256 constant deltay1 = {deltay1};
    uint256 constant deltay2 = {deltay2};

{ic_constants}

    /// @notice Verify a wrap seal: publics = [claimDigestFelt,
    /// controlRootFelt, 0]; the control root is pinned to ControlID.
    function verifySeal(bytes calldata seal, uint256 claimDigestFelt)
        external view returns (bool)
    {{
        require(seal.length == 324, "seal length");
        bytes4 sel = bytes4(seal[0:4]);
        require(sel == ControlID.SELECTOR_GROTH16
                || sel == ControlID.SELECTOR_BLAKE3_GROTH16, "selector");
        uint256[8] memory p;
        for (uint256 i = 0; i < 8; i++) {{
            p[i] = uint256(bytes32(seal[4 + 32 * i : 36 + 32 * i]));
        }}
        uint256 p1 = uint256(bytes32(seal[260:292]));
        uint256 p2 = uint256(bytes32(seal[292:324]));
        require(p1 == claimDigestFelt, "claim digest");
        require(p2 == ControlID.CONTROL_ROOT_FELT, "control root");
        return verifyProof([p[0], p[1]],
                           [[p[2], p[3]], [p[4], p[5]]],
                           [p[6], p[7]], [p1, p2, 0]);
    }}

    /// @dev Standard Groth16 pairing check:
    /// e(-A, B) * e(alpha, beta) * e(vk_x, gamma) * e(C, delta) == 1
    function verifyProof(uint256[2] memory a, uint256[2][2] memory b,
                         uint256[2] memory c, uint256[{n_pub}] memory pubs)
        public view returns (bool)
    {{
        // vk_x = IC0 + sum_i pubs[i] * IC(i+1)
        uint256[2] memory vkx = [IC0x, IC0y];
        uint256[4] memory mulIn;
        uint256[2] memory mulOut;
{ic_accumulate}
        uint256[24] memory pin;
        // -A
        pin[0] = a[0];
        pin[1] = a[1] == 0 ? 0 : q - (a[1] % q);
        pin[2] = b[0][0]; pin[3] = b[0][1];
        pin[4] = b[1][0]; pin[5] = b[1][1];
        pin[6] = alphax; pin[7] = alphay;
        pin[8] = betax1; pin[9] = betax2;
        pin[10] = betay1; pin[11] = betay2;
        pin[12] = vkx[0]; pin[13] = vkx[1];
        pin[14] = gammax1; pin[15] = gammax2;
        pin[16] = gammay1; pin[17] = gammay2;
        pin[18] = c[0]; pin[19] = c[1];
        pin[20] = deltax1; pin[21] = deltax2;
        pin[22] = deltay1; pin[23] = deltay2;
        uint256[1] memory pout;
        bool ok;
        assembly {{
            ok := staticcall(gas(), 8, pin, 768, pout, 32)
        }}
        return ok && pout[0] == 1;
    }}
}}
"""


def generate_verifier(vk, allowed_root_felt: int) -> str:
    """Solidity source for this verifying key (bootstrap artifact)."""
    from .bn254 import P as Q_INT, R as R_INT

    def g2c(pt):
        (x0, x1), (y0, y1) = pt
        # snarkjs constant naming: x1 = c1 ("imaginary" first in
        # precompile order), x2 = c0
        return dict(x1=x1, x2=x0, y1=y1, y2=y0)

    alpha = _g1_words(vk.alpha_g1)
    beta, gamma, delta = (g2c(vk.beta_g2), g2c(vk.gamma_g2),
                          g2c(vk.delta_g2))
    ic_lines = []
    for i, pt in enumerate(vk.ic):
        x, y = _g1_words(pt)
        ic_lines.append(f"    uint256 constant IC{i}x = {x};")
        ic_lines.append(f"    uint256 constant IC{i}y = {y};")
    acc_lines = []
    for i in range(1, len(vk.ic)):
        acc_lines += [
            f"        mulIn = [IC{i}x, IC{i}y, pubs[{i - 1}], 0];",
            "        assembly {",
            "            pop(staticcall(gas(), 7, mulIn, 96, mulOut, 64))",
            "        }",
            "        mulIn = [vkx[0], vkx[1], mulOut[0], mulOut[1]];",
            "        assembly {",
            "            pop(staticcall(gas(), 6, mulIn, 128, vkx, 64))",
            "        }",
        ]
    return _CONTRACT_TEMPLATE.format(
        control_root=allowed_root_felt, R=R_INT, Q=Q_INT,
        alphax=alpha[0], alphay=alpha[1],
        betax1=beta["x1"], betax2=beta["x2"],
        betay1=beta["y1"], betay2=beta["y2"],
        gammax1=gamma["x1"], gammax2=gamma["x2"],
        gammay1=gamma["y1"], gammay2=gamma["y2"],
        deltax1=delta["x1"], deltax2=delta["x2"],
        deltay1=delta["y1"], deltay2=delta["y2"],
        ic_constants="\n".join(ic_lines),
        ic_accumulate="\n".join(acc_lines),
        n_pub=len(vk.ic) - 1)
