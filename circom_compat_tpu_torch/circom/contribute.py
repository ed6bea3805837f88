"""Phase-2 ceremony contribution (`snarkjs zkey contribute` equivalent).

The reference library has no ceremony support (section 10 is named but
never read, reference: src/zkey.rs:1-27); snarkjs owns this step in the
upstream toolchain. A contribution with secret s transforms a Groth16
proving key as:

    delta_g1 *= s        delta_g2 *= s
    l_query  *= s^-1     h_query  *= s^-1

(the verification equation is invariant because L/H terms are paired
against delta). The L/H rescaling is the expensive part, every query point
times the same scalar, and runs on the card (ops/fixed_base.
scalar_mul_const: a double-and-add over the whole section through the K6/K7
point add, then the batch inversion back to affine); delta_g1 and delta_g2
are two host multiplications.

Contributor-key convention: g1_s is a random G1 point, g1_sx = g1_s * s,
g2_spx = G2_gen * s, which satisfies the standard knowledge check
e(g1_sx, G2) == e(g1_s, g2_spx) (zkey.verify_mpc_chain). snarkjs binds
g2_spx to the transcript via hash-to-G2 instead.

Why snarkjs-exact transcripts are NOT implemented: the binding is
blake2b-512(csHash || hashPubKey(prior contributions) || g1_s || g1_sx)
fed through ffjavascript's ChaCha-seeded G2.fromRng rejection sampler,
whose byte-level behavior (point serialization variant used for hashing,
Montgomery-vs-canonical sampling, sign-bit convention) is defined only by
the ffjavascript implementation. No snarkjs or ffjavascript is at hand to
check against, and the reference ships no fixture containing a
contribution (its test.zkey's section 10 is csHash + zero contributions),
so an implementation from recall could neither be cross-checked nor
regression-tested: a silently wrong "compatible" transcript is worse than
an explicit local scheme. The section-10 WIRE format is snarkjs-exact
(zkey_writer round-trips it byte for byte); only the hash chain inside
`transcript` and the g2_spx derivation are local, the CLI prints an
interop warning, and verify_mpc_chain enforces the per-link delta pairing
checks that do not depend on the transcript convention.
The copy of circom_compat_tpu/circom/contribute.py.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import replace
from typing import Optional

import numpy as np
import torch

from ..constants import R_SCALAR
from ..device import resolve_device
from ..ops import curve as cv
from ..ops import fixed_base as fb
from ..ops import limbs as limb_codec
from ..refmath import curve as rc
from ..utils import trace
from .zkey import Contribution, G1Section, MPCParams, ProvingKey


def _rescale_g1_section(section: G1Section, k: int, device) -> G1Section:
    """Every point of a G1 query section times k, on `device`: the zkey's
    limbs as affine words, scalar_mul_const, then back to canonical affine
    Montgomery limbs (all-zero rows for infinity)."""
    limbs = np.array(section.limbs, "<u2")  # a writable copy of the (mapped) section
    if limbs.shape[0] == 0:
        return section
    xy = torch.from_numpy(limb_codec.words_view(limbs)).to(device)
    out = fb.g1_proj_to_affine(fb.scalar_mul_const(cv.affine_to_proj(xy, False), k % R_SCALAR))
    return G1Section(out.cpu().numpy().view("<u2").reshape(limbs.shape))


def derive_secret(entropy: Optional[bytes] = None) -> int:
    """Contribution secret from entropy (urandom-backed by default)."""
    if entropy is None:
        entropy = os.urandom(64)
    s = int.from_bytes(hashlib.blake2b(entropy).digest(), "little") % R_SCALAR
    return s or 1


def contribute(pk: ProvingKey, entropy: Optional[bytes] = None, name: str = "",
               device=None) -> ProvingKey:
    """Apply one phase-2 contribution: a new ProvingKey with delta, L and H
    updated and the contribution appended to pk.mpc. L and H are rescaled
    on the card unless `device` names another, as the trace stages
    contribute.l_query and contribute.h_query."""
    dev = resolve_device(device)
    s = derive_secret(entropy)
    s_inv = pow(s, -1, R_SCALAR)

    delta_g1 = rc.G1.mul(pk.delta_g1, s)
    delta_g2 = rc.G2.mul(pk.vk.delta_g2, s)
    with trace.span("contribute.l_query", dev):
        l_query = _rescale_g1_section(pk.l_query, s_inv, dev)
    with trace.span("contribute.h_query", dev):
        h_query = _rescale_g1_section(pk.h_query, s_inv, dev)

    # contributor key: random-base knowledge proof of s
    u = derive_secret(os.urandom(32) + (entropy or b""))
    g1_s = rc.G1.mul(rc.g1_generator(), u)
    g1_sx = rc.G1.mul(g1_s, s)
    g2_spx = rc.G2.mul(rc.g2_generator(), s)

    prev = pk.mpc or MPCParams()
    transcript = hashlib.blake2b(
        prev.cs_hash
        + len(prev.contributions).to_bytes(4, "little")
        + (delta_g1[0].to_bytes(32, "little") if delta_g1 else b"\0" * 32),
        digest_size=64,
    ).digest()
    contrib = Contribution(delta_after=delta_g1, g1_s=g1_s, g1_sx=g1_sx, g2_spx=g2_spx,
                           transcript=transcript, contrib_type=0, name=name or None)
    mpc = MPCParams(cs_hash=prev.cs_hash, contributions=list(prev.contributions) + [contrib])
    vk = replace(pk.vk, delta_g2=delta_g2)
    return replace(pk, vk=vk, delta_g1=delta_g1, l_query=l_query, h_query=h_query, mpc=mpc)
