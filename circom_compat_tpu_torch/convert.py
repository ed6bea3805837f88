"""Carry a proving key across from plain numpy arrays and ints.

The JAX package and this one hold the same key in the same wire form: query
sections as (n, 2, 16) / (n, 4, 16) uint16 Montgomery limbs (zero rows for
infinity), single points as canonical affine int tuples, matrix values as
(nnz, 16) uint16 Montgomery limbs. A caller that has the other package's key
flattens it into a dict of those arrays and ints, and these functions build
this package's ProvingKey and ConstraintMatrices from it, with no import of
the other package. affine_words_from_limbs carries MSM operands across.

Keys of the dict:
  a_query, b_g1_query, l_query, h_query   (n, 2, 16) uint16
  b_g2_query                              (n, 4, 16) uint16
  alpha_g1, beta_g1, delta_g1             (x, y) or None
  beta_g2, gamma_g2, delta_g2             ((x0, x1), (y0, y1)) or None
  gamma_abc_g1                            list of G1 points
  n_vars, n_public, domain_size           ints
and for matrices_from_numpy:
  num_instance_variables, num_constraints ints
  a_rows, a_cols, b_rows, b_cols          (nnz,) integers
  a_values_mont, b_values_mont            (nnz, 16) uint16
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from .circom.zkey import ConstraintMatrices, G1Section, G2Section, ProvingKey, VerifyingKey
from .ops import limbs as limb_codec


def _limbs(arr, coords: int, name: str) -> np.ndarray:
    a = np.asarray(arr)
    if a.ndim != 3 or a.shape[1:] != (coords, 16):
        raise ValueError(f"{name}: expected (n, {coords}, 16) limbs, got {a.shape}")
    if a.size and int(a.max()) > 0xFFFF:
        raise ValueError(f"{name}: limbs must be 16-bit")
    return np.ascontiguousarray(a, dtype="<u2")


def _g1(p):
    return None if p is None else (int(p[0]), int(p[1]))


def _g2(p):
    return None if p is None else ((int(p[0][0]), int(p[0][1])), (int(p[1][0]), int(p[1][1])))


def proving_key_from_numpy(d: Mapping) -> ProvingKey:
    n_vars, n_public, domain = int(d["n_vars"]), int(d["n_public"]), int(d["domain_size"])
    vk = VerifyingKey(
        alpha_g1=_g1(d["alpha_g1"]), beta_g2=_g2(d["beta_g2"]), gamma_g2=_g2(d["gamma_g2"]),
        delta_g2=_g2(d["delta_g2"]), gamma_abc_g1=[_g1(p) for p in d["gamma_abc_g1"]],
    )
    pk = ProvingKey(
        vk=vk, beta_g1=_g1(d["beta_g1"]), delta_g1=_g1(d["delta_g1"]),
        a_query=G1Section(_limbs(d["a_query"], 2, "a_query")),
        b_g1_query=G1Section(_limbs(d["b_g1_query"], 2, "b_g1_query")),
        b_g2_query=G2Section(_limbs(d["b_g2_query"], 4, "b_g2_query")),
        h_query=G1Section(_limbs(d["h_query"], 2, "h_query")),
        l_query=G1Section(_limbs(d["l_query"], 2, "l_query")),
        n_vars=n_vars, n_public=n_public, domain_size=domain,
    )
    if len(vk.gamma_abc_g1) != n_public + 1:
        raise ValueError("gamma_abc_g1 must hold n_public + 1 points")
    for name in ("a_query", "b_g1_query", "b_g2_query"):
        if len(getattr(pk, name)) != n_vars:
            raise ValueError(f"{name} must hold n_vars = {n_vars} points")
    if len(pk.l_query) != n_vars - n_public - 1:
        raise ValueError("l_query must hold n_vars - n_public - 1 points")
    return pk


def matrices_from_numpy(d: Mapping) -> ConstraintMatrices:
    def coo(m):
        rows = np.asarray(d[f"{m}_rows"], dtype=np.int64)
        cols = np.asarray(d[f"{m}_cols"], dtype=np.int64)
        vals = np.asarray(d[f"{m}_values_mont"])
        if vals.shape != rows.shape + (16,) or cols.shape != rows.shape:
            raise ValueError(f"{m}: rows, cols and (nnz, 16) values disagree")
        return rows, cols, np.ascontiguousarray(vals, dtype="<u2")

    ar, ac, av = coo("a")
    br, bc, bv = coo("b")
    n_inst = int(d["num_instance_variables"])
    return ConstraintMatrices(
        num_instance_variables=n_inst,
        num_witness_variables=int(d["n_vars"]) - n_inst + 1,
        num_constraints=int(d["num_constraints"]),
        a_rows=ar, a_cols=ac, a_values_mont=av, b_rows=br, b_cols=bc, b_values_mont=bv,
    )


def affine_words_from_limbs(xs, ys) -> np.ndarray:
    """The JAX package's MSM operands, x and y as (N, 16) (G1) or (N, 2, 16)
    (G2) Montgomery 16-bit limbs, -> this package's (N, 2, 8) / (N, 2, 2, 8)
    int32 affine words (ops/msm.msm_g1 / msm_g2)."""
    x, y = np.asarray(xs), np.asarray(ys)
    if x.shape != y.shape or x.ndim not in (2, 3) or x.shape[-1] != 16:
        raise ValueError(f"expected x and y as (N, 16) or (N, 2, 16) limbs, got {x.shape}, {y.shape}")
    if x.size and max(int(x.max()), int(y.max())) > 0xFFFF:
        raise ValueError("limbs must be 16-bit")
    return limb_codec.words_view(np.stack((x, y), axis=1))
