"""Groth16 CRS file: zkey-shaped container for the wrap proving key.

Counterpart of `boundless_tpu/groth16/crs.py`, copied: a file written by
either package loads in the other byte for byte.

Production deployments ingest a ceremony CRS instead of ever holding the
trapdoor (reference: rapidsnark/snarkjs `.zkey` artifacts fetched by
`cargo xtask-blake3-groth16` — `xtask/src/setup_blake3_groth16.rs`).
This module defines the container: a sectioned binary file (magic +
version + sized sections, the same shape as snarkjs zkey) holding the
full `protocol.ProvingKey` + `VerifyingKey` for one wrap-circuit layout.
`groth16/wrap.py` loads it via `BT_GROTH16_CRS=<path>` — the trapdoor is
then never materialized in the proving process.

Point encoding: G1 = 64 bytes (x||y big-endian, zeros = infinity);
G2 = 128 bytes (x0||x1||y0||y1).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import BinaryIO

from .bn254 import G1
from .protocol import ProvingKey, VerifyingKey

MAGIC = b"BTZK"
VERSION = 1


def _w_g1(buf: bytearray, p: G1):
    aff = p.to_affine()
    if aff is None:
        buf += bytes(64)
    else:
        buf += aff[0].to_bytes(32, "big") + aff[1].to_bytes(32, "big")


def _r_g1(b: bytes, off: int):
    x = int.from_bytes(b[off : off + 32], "big")
    y = int.from_bytes(b[off + 32 : off + 64], "big")
    if x == 0 and y == 0:
        return G1.infinity(), off + 64
    return G1.from_affine((x, y)), off + 64


def _w_g2(buf: bytearray, p):
    if p is None:  # G2 infinity (affine repr uses None)
        buf += bytes(128)
        return
    (x0, x1), (y0, y1) = p
    for v in (x0, x1, y0, y1):
        buf += int(v).to_bytes(32, "big")


def _r_g2(b: bytes, off: int):
    vals = [int.from_bytes(b[off + 32 * i : off + 32 * (i + 1)], "big")
            for i in range(4)]
    if all(v == 0 for v in vals):
        return None, off + 128
    return ((vals[0], vals[1]), (vals[2], vals[3])), off + 128


@dataclasses.dataclass
class CrsMeta:
    n_rows: int
    n_vars: int
    n_pub: int


def save_crs(path: str, pk: ProvingKey, vk: VerifyingKey, meta: CrsMeta):
    buf = bytearray()
    buf += MAGIC + struct.pack("<I", VERSION)
    buf += struct.pack("<3q", meta.n_rows, meta.n_vars, meta.n_pub)
    for p in (pk.alpha_g1, pk.beta_g1, pk.delta_g1):
        _w_g1(buf, p)
    for p in (pk.beta_g2, pk.delta_g2):
        _w_g2(buf, p)

    def g1_section(pts):
        buf.extend(struct.pack("<q", len(pts)))
        for p in pts:
            _w_g1(buf, p)

    def g2_section(pts):
        buf.extend(struct.pack("<q", len(pts)))
        for p in pts:
            _w_g2(buf, p)

    g1_section(pk.a_g1)
    g1_section(pk.b_g1)
    g2_section(pk.b_g2)
    g1_section(pk.l_g1)
    g1_section(pk.h_g1)
    # verifying key
    _w_g1(buf, vk.alpha_g1)
    for p in (vk.beta_g2, vk.gamma_g2, vk.delta_g2):
        _w_g2(buf, p)
    g1_section(vk.ic)
    with open(path, "wb") as f:
        f.write(bytes(buf))


def load_crs(path: str):
    """-> (ProvingKey, VerifyingKey, CrsMeta)."""
    with open(path, "rb") as f:
        b = f.read()
    assert b[:4] == MAGIC, "not a BTZK CRS file"
    (ver,) = struct.unpack_from("<I", b, 4)
    assert ver == VERSION, f"unsupported CRS version {ver}"
    n_rows, n_vars, n_pub = struct.unpack_from("<3q", b, 8)
    off = 8 + 24
    alpha_g1, off = _r_g1(b, off)
    beta_g1, off = _r_g1(b, off)
    delta_g1, off = _r_g1(b, off)
    beta_g2, off = _r_g2(b, off)
    delta_g2, off = _r_g2(b, off)

    def g1_section(off):
        (n,) = struct.unpack_from("<q", b, off)
        off += 8
        out = []
        for _ in range(n):
            p, off = _r_g1(b, off)
            out.append(p)
        return out, off

    def g2_section(off):
        (n,) = struct.unpack_from("<q", b, off)
        off += 8
        out = []
        for _ in range(n):
            p, off = _r_g2(b, off)
            out.append(p)
        return out, off

    a_g1, off = g1_section(off)
    b_g1, off = g1_section(off)
    b_g2, off = g2_section(off)
    l_g1, off = g1_section(off)
    h_g1, off = g1_section(off)
    v_alpha, off = _r_g1(b, off)
    v_beta, off = _r_g2(b, off)
    v_gamma, off = _r_g2(b, off)
    v_delta, off = _r_g2(b, off)
    ic, off = g1_section(off)
    assert off == len(b), "trailing bytes in CRS file"
    pk = ProvingKey(alpha_g1=alpha_g1, beta_g1=beta_g1, delta_g1=delta_g1,
                    beta_g2=beta_g2, delta_g2=delta_g2, a_g1=a_g1,
                    b_g1=b_g1, b_g2=b_g2, l_g1=l_g1, h_g1=h_g1)
    vk = VerifyingKey(alpha_g1=v_alpha, beta_g2=v_beta, gamma_g2=v_gamma,
                      delta_g2=v_delta, ic=ic)
    return pk, vk, CrsMeta(n_rows=n_rows, n_vars=n_vars, n_pub=n_pub)
