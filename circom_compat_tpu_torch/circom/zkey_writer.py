"""Writer of snarkjs `.zkey` Groth16 proving keys: what a setup user keeps.

The inverse of zkey.py's reader (section layout per reference:
src/zkey.rs:1-27), so a key from models/setup.py persists as a real zkey
file and setup -> write_zkey -> read_zkey -> prove round-trips bit for bit:
  - Fq point coordinates in Montgomery form (reference:
    src/zkey.rs:327-332), all-zero bytes for the point at infinity,
  - section-4 Fr coefficients as v*R^2 (reference: src/zkey.rs:320-325),
  - section 4 includes the appended public-input rows (matrix 0,
    constraint num_constraints + i, signal i, value 1) that readers strip
    (reference: src/zkey.rs:171-175),
  - section 10 (the ceremony's contributions) is the empty one snarkjs
    writes for a fresh key: 64 zero bytes of circuit hash and a count of 0.
The copy of circom_compat_tpu/circom/zkey_writer.py for keys without
contributions.
"""

from __future__ import annotations

import io
import struct
from typing import BinaryIO, List, Tuple

import numpy as np

from ..constants import Q, R_SCALAR
from .zkey import FIELD_BYTES, ZKEY_MAGIC, ProvingKey


def _mont_q(v: int) -> bytes:
    return ((v << 256) % Q).to_bytes(FIELD_BYTES, "little")


def _mont_r2(v: int) -> bytes:
    return ((v << 512) % R_SCALAR).to_bytes(FIELD_BYTES, "little")


def _g1_bytes(p) -> bytes:
    if p is None:
        return b"\0" * (2 * FIELD_BYTES)
    return _mont_q(p[0]) + _mont_q(p[1])


def _g2_bytes(p) -> bytes:
    if p is None:
        return b"\0" * (4 * FIELD_BYTES)
    (x0, x1), (y0, y1) = p
    return _mont_q(x0) + _mont_q(x1) + _mont_q(y0) + _mont_q(y1)


def _section(w: BinaryIO, sec_id: int, payload: bytes) -> None:
    w.write(struct.pack("<I", sec_id))
    w.write(struct.pack("<Q", len(payload)))
    w.write(payload)


def write_zkey(path_or_buf, pk: ProvingKey, matrix_a: List[List[Tuple[int, int]]],
               matrix_b: List[List[Tuple[int, int]]], num_constraints: int) -> None:
    """Serialize a ProvingKey and the sparse A/B rows ([(value, signal)])."""
    buf = io.BytesIO()
    buf.write(ZKEY_MAGIC)
    buf.write(struct.pack("<I", 1))  # version
    buf.write(struct.pack("<I", 10))  # section count

    _section(buf, 1, struct.pack("<I", 1))  # prover type: Groth16

    hdr = io.BytesIO()
    hdr.write(struct.pack("<I", FIELD_BYTES))
    hdr.write(Q.to_bytes(FIELD_BYTES, "little"))
    hdr.write(struct.pack("<I", FIELD_BYTES))
    hdr.write(R_SCALAR.to_bytes(FIELD_BYTES, "little"))
    hdr.write(struct.pack("<III", pk.n_vars, pk.n_public, pk.domain_size))
    hdr.write(_g1_bytes(pk.vk.alpha_g1))
    hdr.write(_g1_bytes(pk.beta_g1))
    hdr.write(_g2_bytes(pk.vk.beta_g2))
    hdr.write(_g2_bytes(pk.vk.gamma_g2))
    hdr.write(_g1_bytes(pk.delta_g1))
    hdr.write(_g2_bytes(pk.vk.delta_g2))
    _section(buf, 2, hdr.getvalue())

    _section(buf, 3, b"".join(_g1_bytes(p) for p in pk.vk.gamma_abc_g1))

    entries = []
    for m_idx, rows in ((0, matrix_a), (1, matrix_b)):
        for c_idx, row in enumerate(rows):
            for value, signal in row:
                entries.append((m_idx, c_idx, signal, value))
    # the appended public-input rows (readers strip them; snarkjs writes them)
    for i in range(pk.n_public + 1):
        entries.append((0, num_constraints + i, i, 1))
    coeffs = io.BytesIO()
    coeffs.write(struct.pack("<I", len(entries)))
    for m_idx, c_idx, signal, value in entries:
        coeffs.write(struct.pack("<III", m_idx, c_idx, signal))
        coeffs.write(_mont_r2(value % R_SCALAR))
    _section(buf, 4, coeffs.getvalue())

    for sec_id, section in ((5, pk.a_query), (6, pk.b_g1_query), (7, pk.b_g2_query),
                            (8, pk.l_query), (9, pk.h_query)):
        _section(buf, sec_id, np.ascontiguousarray(section.limbs.astype("<u2")).tobytes())
    _section(buf, 10, b"\0" * 64 + struct.pack("<I", 0))

    data = buf.getvalue()
    if hasattr(path_or_buf, "write"):
        path_or_buf.write(data)
    else:
        with open(path_or_buf, "wb") as fh:
            fh.write(data)
