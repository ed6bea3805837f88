"""Reader for snarkjs `.zkey` Groth16 proving keys (the prover's input).

Section layout: Header(1), HeaderGroth(2: n8q, q, n8r, r, nVars, nPub,
domainSize, alpha_g1, beta_g1, beta_g2, gamma_g2, delta_g1, delta_g2), IC(3),
Coefs(4), PointsA(5), PointsB1(6), PointsB2(7), PointsC(8), PointsH(9),
Contributions(10, not read: the prover does not need it).

Encoding rules:
  - Fq point coordinates are Montgomery form x*R mod q. The bulk sections
    stay raw Montgomery limbs, which is what the kernels compute on.
  - A point with all-zero coordinates is the point at infinity.
  - Fr coefficients in section 4 are v*R^2 mod r; one Montgomery strip at
    parse time leaves v*R, the Montgomery form of v.
  - matrices() drops the n_public+1 rows snarkjs appends for the public
    inputs (the witness map adds them back); the C matrix stays empty.
"""

from __future__ import annotations

import io
import mmap
import struct
from dataclasses import dataclass
from functools import cached_property
from typing import BinaryIO, Dict, List, Optional, Tuple

import numpy as np

from ..constants import MONT_R_INV_Q, MONT_R_INV_R, NPRIME_R, Q, R_SCALAR
from ..ops import limbs as limb_codec

ZKEY_MAGIC = b"zkey"
G1_BYTES = 64
G2_BYTES = 128
FIELD_BYTES = 32


class ZKeyParseError(ValueError):
    pass


@dataclass
class G1Section:
    """(n, 2, 16) uint16 Montgomery x/y limbs; all-zero rows = infinity."""

    limbs: np.ndarray

    def __len__(self) -> int:
        return self.limbs.shape[0]

    @cached_property
    def points(self) -> List[Optional[Tuple[int, int]]]:
        """Canonical affine points; None = infinity."""
        out: List[Optional[Tuple[int, int]]] = []
        for row in self.limbs:
            x = limb_codec.limbs_to_int(row[0])
            y = limb_codec.limbs_to_int(row[1])
            if x == 0 and y == 0:
                out.append(None)
            else:
                out.append(((x * MONT_R_INV_Q) % Q, (y * MONT_R_INV_Q) % Q))
        return out


@dataclass
class G2Section:
    """(n, 4, 16) uint16 Montgomery x.c0/x.c1/y.c0/y.c1 limbs."""

    limbs: np.ndarray

    def __len__(self) -> int:
        return self.limbs.shape[0]

    @cached_property
    def points(self):
        out = []
        for row in self.limbs:
            raw = [limb_codec.limbs_to_int(row[i]) for i in range(4)]
            if all(v == 0 for v in raw):
                out.append(None)
            else:
                v = [(r * MONT_R_INV_Q) % Q for r in raw]
                out.append(((v[0], v[1]), (v[2], v[3])))
        return out


@dataclass
class VerifyingKey:
    """Groth16 verifying key in canonical (non-Montgomery) coordinates."""

    alpha_g1: Optional[Tuple[int, int]]
    beta_g2: object
    gamma_g2: object
    delta_g2: object
    gamma_abc_g1: List[Optional[Tuple[int, int]]]  # IC


@dataclass
class ProvingKey:
    vk: VerifyingKey
    beta_g1: Optional[Tuple[int, int]]
    delta_g1: Optional[Tuple[int, int]]
    a_query: G1Section
    b_g1_query: G1Section
    b_g2_query: G2Section
    h_query: G1Section
    l_query: G1Section
    n_vars: int
    n_public: int
    domain_size: int


@dataclass
class ConstraintMatrices:
    """Sparse A/B matrices from zkey section 4 as COO arrays: per entry the
    row, the column and the Montgomery-form value limbs (v*R mod r)."""

    num_instance_variables: int  # n_public + 1
    num_witness_variables: int  # n_vars - n_public
    num_constraints: int
    a_rows: np.ndarray
    a_cols: np.ndarray
    a_values_mont: np.ndarray  # (nnz, 16) uint16
    b_rows: np.ndarray
    b_cols: np.ndarray
    b_values_mont: np.ndarray

    @cached_property
    def a(self) -> List[List[Tuple[int, int]]]:
        """Row lists [(value, signal)] with canonical values."""
        return _coo_to_rows(self.a_rows, self.a_cols, self.a_values_mont,
                            self.num_constraints)

    @cached_property
    def b(self) -> List[List[Tuple[int, int]]]:
        return _coo_to_rows(self.b_rows, self.b_cols, self.b_values_mont,
                            self.num_constraints)


def _coo_to_rows(rows, cols, values_mont, num_rows):
    out: List[List[Tuple[int, int]]] = [[] for _ in range(num_rows)]
    for r, c, vrow in zip(rows, cols, values_mont):
        v = (limb_codec.limbs_to_int(vrow) * MONT_R_INV_R) % R_SCALAR
        out[int(r)].append((v, int(c)))
    return out


def _read_exact(r: BinaryIO, n: int) -> bytes:
    data = r.read(n)
    if len(data) != n:
        raise ZKeyParseError(f"unexpected EOF: wanted {n} bytes, got {len(data)}")
    return data


def _u32(r: BinaryIO) -> int:
    return struct.unpack("<I", _read_exact(r, 4))[0]


def _u64(r: BinaryIO) -> int:
    return struct.unpack("<Q", _read_exact(r, 8))[0]


def _read_g1(r: BinaryIO):
    x_raw = int.from_bytes(_read_exact(r, FIELD_BYTES), "little")
    y_raw = int.from_bytes(_read_exact(r, FIELD_BYTES), "little")
    if x_raw == 0 and y_raw == 0:
        return None
    return ((x_raw * MONT_R_INV_Q) % Q, (y_raw * MONT_R_INV_Q) % Q)


def _read_g2(r: BinaryIO):
    raws = [int.from_bytes(_read_exact(r, FIELD_BYTES), "little") for _ in range(4)]
    if all(v == 0 for v in raws):
        return None
    v = [(raw * MONT_R_INV_Q) % Q for raw in raws]
    return ((v[0], v[1]), (v[2], v[3]))


class _Header:
    """Section 2 (HeaderGroth)."""

    def __init__(self, r: BinaryIO):
        if _u32(r) != FIELD_BYTES:
            raise ZKeyParseError("only 32-byte Fq supported")
        if int.from_bytes(_read_exact(r, FIELD_BYTES), "little") != Q:
            raise ZKeyParseError("zkey base field is not BN254 Fq")
        if _u32(r) != FIELD_BYTES:
            raise ZKeyParseError("only 32-byte Fr supported")
        if int.from_bytes(_read_exact(r, FIELD_BYTES), "little") != R_SCALAR:
            raise ZKeyParseError("zkey scalar field is not BN254 Fr")
        self.n_vars = _u32(r)
        self.n_public = _u32(r)
        self.domain_size = _u32(r)
        self.alpha_g1 = _read_g1(r)
        self.beta_g1 = _read_g1(r)
        self.beta_g2 = _read_g2(r)
        self.gamma_g2 = _read_g2(r)
        self.delta_g1 = _read_g1(r)
        self.delta_g2 = _read_g2(r)


class BinFile:
    """Section-scanned zkey; bulk sections are numpy views into `buffer`
    (an mmap) when one is given, so large keys page in lazily."""

    def __init__(self, reader: BinaryIO, buffer=None):
        self.reader = reader
        self.buffer = buffer
        if _read_exact(reader, 4) != ZKEY_MAGIC:
            raise ZKeyParseError("invalid zkey magic")
        _u32(reader)  # version
        self.sections: Dict[int, Tuple[int, int]] = {}
        for _ in range(_u32(reader)):
            sec_id = _u32(reader)
            size = _u64(reader)
            self.sections.setdefault(sec_id, (reader.tell(), size))
            reader.seek(size, io.SEEK_CUR)
        self.header = _Header(self._seek(2))

    def _seek(self, sec_id: int) -> BinaryIO:
        if sec_id not in self.sections:
            raise ZKeyParseError(f"missing zkey section {sec_id}")
        self.reader.seek(self.sections[sec_id][0])
        return self.reader

    def _bulk_u16(self, sec_id: int, nbytes: int) -> np.ndarray:
        pos, size = self.sections.get(sec_id, (None, 0))
        if pos is None:
            raise ZKeyParseError(f"missing zkey section {sec_id}")
        if size < nbytes:
            raise ZKeyParseError(f"section {sec_id} holds {size} bytes, need {nbytes}")
        if self.buffer is not None:
            return np.frombuffer(self.buffer, dtype="<u2", count=nbytes // 2, offset=pos)
        self.reader.seek(pos)
        return np.frombuffer(_read_exact(self.reader, nbytes), dtype="<u2").copy()

    def g1_section(self, num: int, sec_id: int) -> G1Section:
        return G1Section(self._bulk_u16(sec_id, num * G1_BYTES).reshape(num, 2, 16))

    def g2_section(self, num: int, sec_id: int) -> G2Section:
        return G2Section(self._bulk_u16(sec_id, num * G2_BYTES).reshape(num, 4, 16))

    def proving_key(self) -> ProvingKey:
        h = self.header
        vk = VerifyingKey(
            alpha_g1=h.alpha_g1, beta_g2=h.beta_g2, gamma_g2=h.gamma_g2,
            delta_g2=h.delta_g2,
            gamma_abc_g1=self.g1_section(h.n_public + 1, 3).points,
        )
        return ProvingKey(
            vk=vk, beta_g1=h.beta_g1, delta_g1=h.delta_g1,
            a_query=self.g1_section(h.n_vars, 5),
            b_g1_query=self.g1_section(h.n_vars, 6),
            b_g2_query=self.g2_section(h.n_vars, 7),
            l_query=self.g1_section(h.n_vars - h.n_public - 1, 8),
            h_query=self.g1_section(h.domain_size, 9),
            n_vars=h.n_vars, n_public=h.n_public, domain_size=h.domain_size,
        )

    def matrices(self) -> ConstraintMatrices:
        h = self.header
        r = self._seek(4)
        num_coeffs = _u32(r)
        entry = np.dtype([("matrix", "<u4"), ("constraint", "<u4"),
                          ("signal", "<u4"), ("value", "<u2", (16,))])
        if self.buffer is not None:
            entries = np.frombuffer(self.buffer, dtype=entry, count=num_coeffs,
                                    offset=self.sections[4][0] + 4)
        else:
            raw = _read_exact(r, num_coeffs * entry.itemsize)
            entries = np.frombuffer(raw, dtype=entry, count=num_coeffs)
        max_constraint = int(entries["constraint"].max()) if num_coeffs else 0
        num_constraints = max_constraint - h.n_public
        if num_coeffs == 0 or num_constraints < 0:
            raise ZKeyParseError(
                f"section 4 is degenerate: {num_coeffs} coefficients, max "
                f"constraint index {max_constraint}, n_public {h.n_public}"
            )
        values_mont = limb_codec.mont_strip(
            np.ascontiguousarray(entries["value"]), R_SCALAR, NPRIME_R
        )
        keep = entries["constraint"] < num_constraints
        is_a = entries["matrix"] == 0
        sel_a, sel_b = keep & is_a, keep & ~is_a
        return ConstraintMatrices(
            num_instance_variables=h.n_public + 1,
            num_witness_variables=h.n_vars - h.n_public,
            num_constraints=num_constraints,
            a_rows=entries["constraint"][sel_a].astype(np.int64),
            a_cols=entries["signal"][sel_a].astype(np.int64),
            a_values_mont=values_mont[sel_a],
            b_rows=entries["constraint"][sel_b].astype(np.int64),
            b_cols=entries["signal"][sel_b].astype(np.int64),
            b_values_mont=values_mont[sel_b],
        )


def read_zkey(path_or_reader) -> Tuple[ProvingKey, ConstraintMatrices]:
    """Load a snarkjs .zkey into (ProvingKey, ConstraintMatrices). Paths are
    memory-mapped; the mapping lives as long as the section arrays."""
    if hasattr(path_or_reader, "read"):
        binfile = BinFile(path_or_reader)
        return binfile.proving_key(), binfile.matrices()
    with open(path_or_reader, "rb") as fh:
        mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
    binfile = BinFile(mm, buffer=mm)
    return binfile.proving_key(), binfile.matrices()
