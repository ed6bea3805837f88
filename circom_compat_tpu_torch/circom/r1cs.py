"""Parser for iden3 `.r1cs` binary constraint files.

Format (magic "r1cs", version 1, sectioned): header is section 1,
constraints section 2, wire-to-label map section 3. Behaviour matches the
reference parser (reference: src/circom/r1cs_reader.rs:54-249), including
the hard BN254 prime check (:180-188) and the wire-0 -> label-0 invariant
(:242-247).
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass, field
from typing import BinaryIO, List, Optional, Tuple

from ..constants import R_BYTES_LE

R1CS_MAGIC = b"r1cs"

# A linear combination is a list of (wire_index, coefficient) pairs; a
# constraint is an (A, B, C) triple of them — same shape as the reference's
# ConstraintVec/Constraints aliases (reference: src/circom/mod.rs:11-12).
ConstraintVec = List[Tuple[int, int]]
Constraint = Tuple[ConstraintVec, ConstraintVec, ConstraintVec]


class R1CSParseError(ValueError):
    pass


@dataclass
class Header:
    field_size: int
    prime: bytes
    n_wires: int
    n_pub_out: int
    n_pub_in: int
    n_prv_in: int
    n_labels: int
    n_constraints: int


@dataclass
class R1CSFile:
    version: int
    header: Header
    constraints: List[Constraint]
    wire_mapping: List[int]


@dataclass
class R1CS:
    """Digested constraint system (reference: src/circom/r1cs_reader.rs:18-39)."""

    num_inputs: int  # 1 + n_pub_in + n_pub_out (includes the constant wire)
    num_aux: int
    num_variables: int
    constraints: List[Constraint]
    wire_mapping: Optional[List[int]] = field(default=None)

    @classmethod
    def from_file(cls, f: R1CSFile) -> "R1CS":
        num_inputs = 1 + f.header.n_pub_in + f.header.n_pub_out
        num_variables = f.header.n_wires
        return cls(
            num_inputs=num_inputs,
            num_aux=num_variables - num_inputs,
            num_variables=num_variables,
            constraints=f.constraints,
            wire_mapping=list(f.wire_mapping),
        )


def _read_exact(r: BinaryIO, n: int) -> bytes:
    data = r.read(n)
    if len(data) != n:
        raise R1CSParseError(f"unexpected EOF: wanted {n} bytes, got {len(data)}")
    return data


def _u32(r: BinaryIO) -> int:
    return struct.unpack("<I", _read_exact(r, 4))[0]


def _u64(r: BinaryIO) -> int:
    return struct.unpack("<Q", _read_exact(r, 8))[0]


def _scan_sections(r: BinaryIO, num_sections: int):
    """Return {section_type: (offset, size)} like the reference's offset scan."""
    offsets, sizes = {}, {}
    for _ in range(num_sections):
        sec_type = _u32(r)
        sec_size = _u64(r)
        offsets[sec_type] = r.tell()
        sizes[sec_type] = sec_size
        r.seek(sec_size, io.SEEK_CUR)
    return offsets, sizes


def parse_r1cs_file(r: BinaryIO) -> R1CSFile:
    if _read_exact(r, 4) != R1CS_MAGIC:
        raise R1CSParseError("Invalid magic number")
    version = _u32(r)
    if version != 1:
        raise R1CSParseError("Unsupported version")
    num_sections = _u32(r)

    offsets, sizes = _scan_sections(r, num_sections)
    for sec in (1, 2, 3):
        if sec not in offsets:
            raise R1CSParseError(f"missing required section {sec}")

    r.seek(offsets[1])
    header = _parse_header(r, sizes[1])

    r.seek(offsets[2])
    constraints = _read_constraints(r, header)

    r.seek(offsets[3])
    wire_mapping = _read_map(r, sizes[3], header)

    return R1CSFile(version, header, constraints, wire_mapping)


def _parse_header(r: BinaryIO, size: int) -> Header:
    field_size = _u32(r)
    if field_size != 32:
        raise R1CSParseError("This parser only supports 32-byte fields")
    if size != 32 + field_size:
        raise R1CSParseError("Invalid header section size")
    prime = _read_exact(r, field_size)
    if prime != R_BYTES_LE:
        raise R1CSParseError("This parser only supports bn256")
    return Header(
        field_size=field_size,
        prime=prime,
        n_wires=_u32(r),
        n_pub_out=_u32(r),
        n_pub_in=_u32(r),
        n_prv_in=_u32(r),
        n_labels=_u64(r),
        n_constraints=_u32(r),
    )


def _read_constraint_vec(r: BinaryIO, field_size: int) -> ConstraintVec:
    n = _u32(r)
    out: ConstraintVec = []
    for _ in range(n):
        wire = _u32(r)
        coeff = int.from_bytes(_read_exact(r, field_size), "little")
        out.append((wire, coeff))
    return out


def _read_constraints(r: BinaryIO, header: Header) -> List[Constraint]:
    fs = header.field_size
    return [
        (
            _read_constraint_vec(r, fs),
            _read_constraint_vec(r, fs),
            _read_constraint_vec(r, fs),
        )
        for _ in range(header.n_constraints)
    ]


def _read_map(r: BinaryIO, size: int, header: Header) -> List[int]:
    if size != header.n_wires * 8:
        raise R1CSParseError("Invalid map section size")
    mapping = [_u64(r) for _ in range(header.n_wires)]
    if mapping and mapping[0] != 0:
        raise R1CSParseError("Wire 0 should always be mapped to 0")
    return mapping


def read_r1cs(path_or_bytes) -> R1CS:
    """Load a `.r1cs` file (path, bytes, or binary stream) into an R1CS."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return R1CS.from_file(parse_r1cs_file(io.BytesIO(path_or_bytes)))
    if hasattr(path_or_bytes, "read"):
        return R1CS.from_file(parse_r1cs_file(path_or_bytes))
    with open(path_or_bytes, "rb") as fh:
        return R1CS.from_file(parse_r1cs_file(fh))
