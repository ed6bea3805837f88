"""circomlib's Sha256(nBits) as circom's default optimisation (--O1) keeps
it: every non-linear row and every BinSum's `lin === lout`, with the copies,
rotations, shifts and constants substituted away.

Sources (https://github.com/iden3/circomlib, circuits/): sha256/sha256.circom,
sha256compression.circom, t1.circom, t2.circom, sigma.circom,
sigmaplus.circom, rotate.circom, shift.circom, xor3.circom, ch.circom,
maj.circom, constants.circom and binsum.circom. `component main =
Sha256(nBits)` declares no public input, so the public signals are the 256
outputs alone. cfg["message_bytes"] bytes make nBits = 8 message_bytes.

Each constraint is A z o B z = C z. --O1 removes every constraint between
two signals (`x <== y`: the copies into a component's inputs, RotR, ShR,
the state copies, Sha256compression's `out === fsum.out` and main's `out
<==`) and every constraint between a signal and a constant (K, H, ShR's
zeros past the shift, the padding), and puts the surviving signal or the
constant in the removed one's place in every other row. A constant in a
row is a term on wire 0. Rows, and wires (a signal kept by the rows),
each template in all:

    template            rows  wires  components
    RotR(32,r)             0      0
    ShR(32,r)              0      0
    Xor3(32)              64     64
    Ch_t(32)              32     32
    Maj_t(32)             64     64
    BinSum(32,2)          34     33
    BinSum(32,4)          35     34
    BinSum(32,5)          36     35
    K(t)                   0      0
    H(x)                   0      0
    SmallSigma            64     64  2 RotR(32,r), 1 ShR(32,r), 1 Xor3(32)
    BigSigma              64     64  3 RotR(32,r), 1 Xor3(32)
    SigmaPlus            163    162  2 SmallSigma, 1 BinSum(32,4)
    T1                   132    131  1 Ch_t(32), 1 BigSigma, 1 BinSum(32,5)
    T2                   162    161  1 BigSigma, 1 Maj_t(32), 1 BinSum(32,2)
    Sha256compression  31264  30952  48 SigmaPlus, 64 K(t), 64 T1, 64 T2, 136 BinSum(32,2)

    main Sha256(nBits) of B blocks: 8 H(x) and B Sha256compression, so
    31264 B rows; wires 1 + nBits + 30952 B (the last block's 256 out
    are main's out)

The equations: Xor3 `mid <== b*c`, `out <== a*(1 - 2b - 2c + 4mid) + b + c
- 2mid`; Ch `out <== a*(b - c) + c`; Maj `mid <== b*c`, `out <== a*(b + c -
2mid) + mid`; BinSum(n, ops) `out[k]*(out[k] - 1) === 0` for its nbits((2^n
- 1) ops) outputs, then `lin === lout` (A and B empty, every term in C).

Decisions the templates and the optimiser leave open, taken here:
  - one pass of substitution: a row whose factors became constants (Xor3
    on ShR's zero bits; the first rounds of block 0 on H's bits; the
    message schedule on the padding) stays a row, with its constant terms
    on wire 0; terms on one wire are summed, and a zero sum dropped;
  - wires: 0 the constant one, then main's out (256, the public signals),
    main's in (nBits), then each block's wires in the order its statements
    create them, its BinSum carries of fsum and its out (256) last; the
    last block's out are main's out. Circom's own numbering is not
    reproduced;
  - rows: block by block, in statement order; a 32-bit loop of a template
    is written statement by statement, each statement for all 32 bits;
  - the sides of a product: A is the factor written first, B the second,
    C the rest moved to the output's side (`out - lin`); a linear row is
    C = lhs - rhs. The zkey carries A and B alone, so C's sign does not
    reach the prover.

`matrices` builds one block's rows once, on stand-in wires for its hin and
inp, and places them at every block's wire and row offsets, with each
stand-in replaced by its wire or constant. `traverse` builds the whole
circuit in one pass (the witness, and a test's cross-check of the
placement); `witness` fills every wire by its own bit-level SHA-256 (the
templates' logic on 0/1 arrays), reading no constraint.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Sequence

import numpy as np

ONE = -1  # a constraint system's stand-in for wire 0, the constant one
ZERO = -2  # a constant 0: its terms drop
WORD = 32
H0 = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F, 0x9B05688C, 0x1F83D9AB,
      0x5BE0CD19]
K64 = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3, 0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13, 0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208, 0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]
POW2 = 1 << np.arange(WORD + 4, dtype=np.int64)  # bit weights of a BinSum's words and outputs


def bits_of(value: int, n: int = WORD) -> np.ndarray:
    """The n bits of value, least significant first."""
    return (value >> np.arange(n, dtype=np.int64)) & 1


def nbits(a: int) -> int:
    """binsum.circom's nbits: the bits of a."""
    n, r = 1, 0
    while n - 1 < a:
        r += 1
        n *= 2
    return r


class Sig(NamedTuple):
    """Signals: their wires (ONE or ZERO for a constant) and their 0/1
    values, index for index."""

    wires: np.ndarray
    bits: np.ndarray

    def __getitem__(self, idx):
        return Sig(self.wires[idx], self.bits[idx])

    def __len__(self):
        return len(self.wires)


def cat(sigs: Sequence[Sig]) -> Sig:
    return Sig(np.concatenate([s.wires for s in sigs]), np.concatenate([s.bits for s in sigs]))


def const(bits) -> Sig:
    """Constant bits: no wire, no row."""
    bits = np.array(bits, dtype=np.int64).reshape(-1)
    return Sig(np.where(bits == 1, ONE, ZERO), bits)


def merged(rows, wires, coeffs) -> tuple:
    """COO with the terms on one (row, wire) summed and zero sums dropped,
    ordered by row, then wire; wires from ONE up."""
    key = (np.asarray(rows, np.int64) << 32) | (np.asarray(wires, np.int64) - ONE)
    order = np.argsort(key, kind="stable")
    key = key[order]
    starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]]) if len(key) else key
    sums = np.add.reduceat(np.asarray(coeffs, np.int64)[order], starts) if len(key) else key
    keep = sums != 0
    key = key[starts][keep]
    return key >> 32, (key & 0xFFFFFFFF) + ONE, sums[keep]


class System:
    """A constraint system made by one traversal of templates: allocates
    wires in order (from 0, wire 0 of the circuit being ONE), records their
    values and, unless rows=False, the rows as COO."""

    def __init__(self, rows: bool = True):
        self.n_wires = 0
        self.n_rows = 0
        self.values: List[np.ndarray] = []
        self.coo = {"a": [], "b": [], "c": []} if rows else None

    def signal(self, bits) -> Sig:
        """New wires holding `bits`; no row."""
        bits = np.array(bits, dtype=np.int64).reshape(-1)
        wires = np.arange(self.n_wires, self.n_wires + len(bits), dtype=np.int64)
        self.n_wires += len(bits)
        self.values.append(bits)
        return Sig(wires, bits)

    def rows(self, k: int, a=(), b=(), c=()) -> None:
        """k rows; each side a list of (wires, coeffs) terms: wires ONE,
        (k,) one term a row, or (k, t) t terms a row."""
        if self.coo is not None:
            r = self.n_rows + np.arange(k, dtype=np.int64)
            for name, side in (("a", a), ("b", b), ("c", c)):
                for wires, coeffs in side:
                    w = np.asarray(wires, dtype=np.int64)
                    cf = np.asarray(coeffs, dtype=np.int64)
                    if w.ndim <= 1 and cf.ndim == 1:  # one term a row: a coefficient a row
                        cf = cf[:, None]
                    w = np.full((k, 1), w) if w.ndim == 0 else w.reshape(k, -1)
                    cf = np.where(w == ZERO, 0, np.broadcast_to(cf, w.shape))
                    self.coo[name].append((np.broadcast_to(r[:, None], w.shape).reshape(-1),
                                           w.reshape(-1), cf.reshape(-1)))
        self.n_rows += k

    def value_array(self) -> np.ndarray:
        return np.concatenate(self.values)

    def local_coo(self) -> dict:
        """The rows as {"a", "b", "c"}: (rows, cols, coeffs) on the
        system's own wires and ONE, merged."""
        out = {}
        for name, parts in self.coo.items():
            if parts:
                out[name] = merged(*(np.concatenate(x) for x in zip(*parts)))
            else:
                out[name] = (np.zeros(0, np.int64),) * 3
        return out


def place(coo: dict, wire_base: int, row_base: int) -> dict:
    """A constraint system's local COO with its wire i at wire_base + i, ONE at wire
    0, and its rows from row_base."""
    return {m: (r + row_base, np.where(w == ONE, 0, w + wire_base), cf)
            for m, (r, w, cf) in coo.items()}


# ---------------------------------------------------------------------------
# The templates: each takes its input signals (the signals or constants its
# parent wired into them) and returns its output signal.
# ---------------------------------------------------------------------------


def rotr(x: Sig, r: int) -> Sig:
    """RotR(32, r): out[i] <== in[(i + r) % 32], substituted away."""
    return x[(np.arange(WORD) + r) % WORD]


def shr(x: Sig, r: int) -> Sig:
    """ShR(32, r): out[i] <== in[i + r], 0 past the word, substituted away."""
    return cat([x[r:], const(np.zeros(r, np.int64))])


def xor3(cs: System, a: Sig, b: Sig, c: Sig) -> Sig:
    """Xor3(32): mid <== b*c, out <== a*(1 - 2b - 2c + 4mid) + b + c - 2mid."""
    mid = cs.signal(b.bits & c.bits)
    cs.rows(WORD, a=[(b.wires, 1)], b=[(c.wires, 1)], c=[(mid.wires, 1)])
    out = cs.signal(a.bits ^ b.bits ^ c.bits)
    cs.rows(WORD, a=[(a.wires, 1)],
            b=[(ONE, 1), (b.wires, -2), (c.wires, -2), (mid.wires, 4)],
            c=[(out.wires, 1), (b.wires, -1), (c.wires, -1), (mid.wires, 2)])
    return out


def ch(cs: System, a: Sig, b: Sig, c: Sig) -> Sig:
    """Ch_t(32): out <== a*(b - c) + c."""
    out = cs.signal((a.bits & b.bits) | ((1 - a.bits) & c.bits))
    cs.rows(WORD, a=[(a.wires, 1)], b=[(b.wires, 1), (c.wires, -1)],
            c=[(out.wires, 1), (c.wires, -1)])
    return out


def maj(cs: System, a: Sig, b: Sig, c: Sig) -> Sig:
    """Maj_t(32): mid <== b*c, out <== a*(b + c - 2mid) + mid."""
    mid = cs.signal(b.bits & c.bits)
    cs.rows(WORD, a=[(b.wires, 1)], b=[(c.wires, 1)], c=[(mid.wires, 1)])
    out = cs.signal((a.bits & b.bits) | (a.bits & c.bits) | (b.bits & c.bits))
    cs.rows(WORD, a=[(a.wires, 1)], b=[(b.wires, 1), (c.wires, 1), (mid.wires, -2)],
            c=[(out.wires, 1), (mid.wires, -1)])
    return out


def binsum(cs: System, ins: Sequence[Sig], out: Sig = None) -> Sig:
    """BinSum(32, len(ins)): nbits((2^32 - 1) ops) output bits of the sum,
    on new wires unless `out` gives them."""
    nout = nbits(((1 << WORD) - 1) * len(ins))
    total = sum(int(x.bits @ POW2[:WORD]) for x in ins)
    if out is None:
        out = cs.signal(bits_of(total, nout))
    cs.rows(nout, a=[(out.wires, 1)], b=[(out.wires, 1), (ONE, -1)])
    lin = np.concatenate([x.wires for x in ins])
    cs.rows(1, c=[(lin[None, :], np.tile(POW2[:WORD], len(ins))),
                  (out.wires[None, :], -POW2[:nout])])
    return out


def k_const(t: int) -> Sig:
    """K(t): out[i] <== (K[t] >> i) & 1, substituted away."""
    return const(bits_of(K64[t]))


def h_const(x: int) -> Sig:
    """H(x): out[i] <== (H[x] >> i) & 1, substituted away."""
    return const(bits_of(H0[x]))


def small_sigma(cs: System, x: Sig, ra: int, rb: int, rc: int) -> Sig:
    return xor3(cs, rotr(x, ra), rotr(x, rb), shr(x, rc))


def big_sigma(cs: System, x: Sig, ra: int, rb: int, rc: int) -> Sig:
    return xor3(cs, rotr(x, ra), rotr(x, rb), rotr(x, rc))


def sigma_plus(cs: System, in2: Sig, in7: Sig, in15: Sig, in16: Sig) -> Sig:
    s1 = small_sigma(cs, in2, 17, 19, 10)
    s0 = small_sigma(cs, in15, 7, 18, 3)
    return binsum(cs, [s1, in7, s0, in16])[:WORD]


def t1(cs: System, h: Sig, e: Sig, f: Sig, g: Sig, k: Sig, w: Sig) -> Sig:
    s1 = big_sigma(cs, e, 6, 11, 25)
    c = ch(cs, e, f, g)
    return binsum(cs, [h, s1, c, k, w])[:WORD]


def t2(cs: System, a: Sig, b: Sig, c: Sig) -> Sig:
    s0 = big_sigma(cs, a, 2, 13, 22)
    m = maj(cs, a, b, c)
    return binsum(cs, [s0, m])[:WORD]


def sha_round(cs: System, state: Sequence[Sig], k: Sig, w: Sig) -> List[Sig]:
    """Sha256compression's round t: T1, T2, sume, suma; returns the state
    (a..h)[t + 1], the copies substituted. k is K(t)'s out, w is w[t]."""
    a, b, c, d, e, f, g, h = state
    x1 = t1(cs, h, e, f, g, k, w)
    x2 = t2(cs, a, b, c)
    sume = binsum(cs, [d, x1])
    suma = binsum(cs, [x1, x2])
    return [suma[:WORD], a, b, c, sume[:WORD], e, f, g]


MSB_FIRST = WORD - 1 - np.arange(WORD)


def compression(cs: System, hin: Sig, inp: Sig, out: Sig = None) -> Sig:
    """Sha256compression on its inputs hin (8 words, each least
    significant bit first) and inp (512 bits, each word most significant
    first); returns its out (each word most significant bit first), on new
    wires made last unless `out` gives them (then filled with its values)."""
    w = [inp[t * WORD + MSB_FIRST] for t in range(16)]
    for t in range(16, 64):
        w.append(sigma_plus(cs, w[t - 2], w[t - 7], w[t - 15], w[t - 16]))
    hwords = [hin[j * WORD : (j + 1) * WORD] for j in range(8)]
    state = list(hwords)
    for t in range(64):
        state = sha_round(cs, state, k_const(t), w[t])
    # fsum[j] = BinSum(32, 2) of hin's word j and the state's; out[32 j + 31 - k]
    # === fsum[j].out[k] puts out in its low 32 bits
    sums = [bits_of(int(hw.bits @ POW2[:WORD]) + int(s.bits @ POW2[:WORD]), WORD + 1)
            for hw, s in zip(hwords, state)]
    carries = [cs.signal(bits[WORD:]) for bits in sums]
    out_bits = np.concatenate([bits[:WORD][MSB_FIRST] for bits in sums])
    if out is None:
        out = cs.signal(out_bits)
    else:
        out.bits[:] = out_bits
    for j, (hw, s) in enumerate(zip(hwords, state)):
        binsum(cs, [hw, s], out=cat([out[j * WORD + MSB_FIRST], carries[j]]))
    return out


# ---------------------------------------------------------------------------
# Sha256(nBits): one block built once, placed B times
# ---------------------------------------------------------------------------

HIN, INP = 8 * WORD, 512  # a block's stand-in wires: its hin, then its inp
NEXT_HIN = np.arange(256).reshape(8, WORD)[:, ::-1].reshape(-1)  # out -> next block's hin


@functools.lru_cache(maxsize=1)
def _block_rows():
    """(COO on block-local wires, the block's own wires, its rows): local
    wires 0 .. HIN + INP - 1 stand in for hin and inp, the block's own
    follow, its out the last 256."""
    cs = System(True)
    out = compression(cs, cs.signal(np.zeros(HIN, np.int64)), cs.signal(np.zeros(INP, np.int64)))
    assert (out.wires == np.arange(cs.n_wires - 256, cs.n_wires)).all()
    return cs.local_coo(), cs.n_wires - HIN - INP, cs.n_rows


def n_blocks(n_bits: int) -> int:
    return (n_bits + 64) // 512 + 1


def padded_bits(msg_bits: np.ndarray) -> np.ndarray:
    """sha256.circom's paddedIn: the message, a 1, zeros, 64 length bits
    (most significant first)."""
    n = len(msg_bits)
    total = 512 * n_blocks(n)
    length = bits_of(n, 64)[::-1]
    return np.concatenate((msg_bits, [1], np.zeros(total - n - 65, np.int64), length))


def traverse(msg_bits: np.ndarray, rows: bool) -> System:
    """The whole of Sha256(nBits) in one pass, on a constraint system
    whose wire i is wire i + 1: main's out, its in, then each block."""
    cs = System(rows)
    out = cs.signal(np.zeros(256, np.int64))
    inp = cs.signal(msg_bits)
    padded = cat([inp, const(padded_bits(msg_bits)[len(msg_bits):])])
    hin = cat([h_const(x) for x in range(8)])
    nb = n_blocks(len(msg_bits))
    for i in range(nb):
        res = compression(cs, hin, padded[512 * i : 512 * (i + 1)],
                          out=out if i == nb - 1 else None)
        hin = res[NEXT_HIN]
    return cs


def _n_bits(cfg: dict) -> int:
    return 8 * cfg["message_bytes"]


def shape(cfg: dict) -> dict:
    n = _n_bits(cfg)
    _, bw, br = _block_rows()
    nb = n_blocks(n)
    return {"num_constraints": nb * br, "n_vars": 1 + n + nb * bw, "num_inputs": 257}


def matrices(cfg: dict) -> dict:
    n = _n_bits(cfg)
    nb = n_blocks(n)
    blk, bw, br = _block_rows()
    # a stand-in's wire and the factor on its terms: a constant is wire 0
    # with its bit as the factor
    tail = padded_bits(np.zeros(n, np.int64))[n:]
    inp_wire = np.concatenate((257 + np.arange(n, dtype=np.int64), np.zeros(len(tail), np.int64)))
    inp_mul = np.concatenate((np.ones(n, np.int64), tail))
    hin_wire = np.zeros(HIN, np.int64)
    hin_mul = np.concatenate([bits_of(h) for h in H0])
    parts = {m: [] for m in blk}
    for i in range(nb):
        wire = np.concatenate(([0], hin_wire, inp_wire[512 * i : 512 * (i + 1)],
                               257 + n + i * bw + np.arange(bw, dtype=np.int64)))
        mul = np.concatenate(([1], hin_mul, inp_mul[512 * i : 512 * (i + 1)],
                              np.ones(bw, np.int64)))
        if i == nb - 1:
            wire[-256:] = 1 + np.arange(256)
        for m, (r, w, cf) in blk.items():
            parts[m].append((r + i * br, wire[w + 1], cf * mul[w + 1]))
        hin_wire, hin_mul = wire[-256:][NEXT_HIN], np.ones(HIN, np.int64)
    return {m: merged(*(np.concatenate(x) for x in zip(*p))) for m, p in parts.items()}


def pool_input(cfg: dict, rng) -> bytes:
    return rng.randbytes(cfg["message_bytes"])


def message_bits(msg: bytes) -> np.ndarray:
    """Bits of msg, each byte most significant first (sha256.circom's in)."""
    return np.unpackbits(np.frombuffer(msg, np.uint8)).astype(np.int64)


def witness(cfg: dict, x: bytes) -> List[int]:
    msg = message_bits(x)
    if len(msg) != _n_bits(cfg):
        raise ValueError(f"a message of {len(x)} bytes for a circuit of {cfg['message_bytes']}")
    return [1] + traverse(msg, False).value_array().tolist()


def signals(x: bytes) -> dict:
    return {"in": message_bits(x).tolist()}


def wasm(cfg: dict):
    return None
