"""Reader/writer for snarkjs `.wtns` witness files.

Format (same sectioned container as .r1cs/.zkey; written by the reference's
JS witness generator via calculateWTNSBin, reference:
test-vectors/mycircuit_js/generate_witness.js:15):
  magic "wtns", version 2
  section 1 (header): n8 u32, prime (n8 bytes LE), n_witness u32
  section 2 (data):   n_witness * n8 bytes, LE canonical values
"""

from __future__ import annotations

import io
import struct
from typing import BinaryIO, List

from ..constants import R_BYTES_LE, R_SCALAR

WTNS_MAGIC = b"wtns"


class WtnsParseError(ValueError):
    pass


def read_wtns(path_or_bytes) -> List[int]:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return _parse(io.BytesIO(path_or_bytes))
    if hasattr(path_or_bytes, "read"):
        return _parse(path_or_bytes)
    with open(path_or_bytes, "rb") as fh:
        return _parse(fh)


def read_wtns_limbs(path_or_bytes):
    """Witness values as a (n, 16) uint32 canonical limb array: the 32-byte
    LE wire encoding IS the LE 16-bit limb layout, so the data section is
    one frombuffer — the device prover consumes it with no Python-int
    pass (models/groth16_device.encode_assignment)."""
    import numpy as np

    if isinstance(path_or_bytes, (bytes, bytearray)):
        r = io.BytesIO(path_or_bytes)
    elif hasattr(path_or_bytes, "read"):
        r = path_or_bytes
    else:
        r = open(path_or_bytes, "rb")
    try:
        data, n = _parse_raw(r)
    finally:
        if r is not path_or_bytes and not isinstance(
            path_or_bytes, (bytes, bytearray)
        ):
            r.close()
    return (
        np.frombuffer(data, dtype="<u2").reshape(n, 16).astype(np.uint32)
    )


def _parse(r: BinaryIO) -> List[int]:
    data, n_witness = _parse_raw(r)
    n8 = 32
    return [
        int.from_bytes(data[i * n8 : (i + 1) * n8], "little") for i in range(n_witness)
    ]


def _parse_raw(r: BinaryIO):
    """Validated header scan; returns (data-section bytes, n_witness)."""
    if r.read(4) != WTNS_MAGIC:
        raise WtnsParseError("invalid wtns magic")
    _version = struct.unpack("<I", r.read(4))[0]
    num_sections = struct.unpack("<I", r.read(4))[0]
    sections = {}
    for _ in range(num_sections):
        sec_id = struct.unpack("<I", r.read(4))[0]
        sec_len = struct.unpack("<Q", r.read(8))[0]
        sections[sec_id] = (r.tell(), sec_len)
        r.seek(sec_len, io.SEEK_CUR)

    pos, _ = sections[1]
    r.seek(pos)
    n8 = struct.unpack("<I", r.read(4))[0]
    prime = r.read(n8)
    if prime != R_BYTES_LE:
        raise WtnsParseError("wtns prime is not BN254 Fr")
    n_witness = struct.unpack("<I", r.read(4))[0]

    pos, size = sections[2]
    if size != n_witness * n8:
        raise WtnsParseError("wtns data section size mismatch")
    r.seek(pos)
    return r.read(size), n_witness


def write_wtns(values: List[int], path_or_buf) -> None:
    n8 = 32
    body_header = struct.pack("<I", n8) + R_BYTES_LE + struct.pack("<I", len(values))
    body_data = b"".join((v % R_SCALAR).to_bytes(n8, "little") for v in values)
    out = io.BytesIO()
    out.write(WTNS_MAGIC)
    out.write(struct.pack("<I", 2))  # version
    out.write(struct.pack("<I", 2))  # num sections
    out.write(struct.pack("<I", 1) + struct.pack("<Q", len(body_header)))
    out.write(body_header)
    out.write(struct.pack("<I", 2) + struct.pack("<Q", len(body_data)))
    out.write(body_data)
    blob = out.getvalue()
    if hasattr(path_or_buf, "write"):
        path_or_buf.write(blob)
    else:
        with open(path_or_buf, "wb") as fh:
            fh.write(blob)
