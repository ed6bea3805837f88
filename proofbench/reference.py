"""The plain reference of a Groth16 proof on a circuit generator's R1CS.

Everything here is plain PyTorch and Python integers; nothing of the
program under test is imported, and nothing the program made is read. The
reference recomputes, from the inputs the benchmark made:

  - the witness z from a pool input, by the generator's own `witness`
    (circuits/<generator>.py),
  - h, the CircomReduction witness map of arkworks and snarkjs: A and B
    evaluated on the domain with the public inputs in A's tail, C = A o B,
    each interpolated (iFFT), shifted onto the coset of the 2n-th root of
    unity and evaluated there (FFT), h = A B - C on that coset,
  - the proof of the pooled known-dlog key (inputs.PooledKey): every key
    point is a known multiple of a generator, so
    A = (alpha + <z, kA> + r delta) G1, B = (beta + <z, kB2> + s delta) G2,
    C = (<z[num_inputs:], kL> + <h, kH> + s A' + r B1' - r s delta) G1,
    with A' and B1' the scalars of A and of B in G1 (the algebra of
    chip_smoke.py `expected_proof`).

Field elements of Fr live on a device as limb-major int64 tensors
(16, ...) of 16-bit limbs, canonical in [0, r). A product is CIOS
Montgomery over those limbs: every column sum stays below 2^40, exact in
int64. The curve arithmetic is Jacobian over Python integers.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583
LIMBS, BITS, MASK = 16, 16, 0xFFFF
MONT = 1 << 256
NPRIME = (-pow(R, -1, 1 << BITS)) % (1 << BITS)
TWO_ADICITY, FR_GENERATOR = 28, 5

G1_GEN = (1, 2)
G2_GEN = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)


def root_of_unity(n: int) -> int:
    """The primitive n-th root of unity of arkworks' radix-2 domain."""
    log_n = n.bit_length() - 1
    if n != 1 << log_n or log_n > TWO_ADICITY:
        raise ValueError(f"no radix-2 domain of size {n}")
    root = pow(FR_GENERATOR, (R - 1) >> TWO_ADICITY, R)
    return pow(root, 1 << (TWO_ADICITY - log_n), R)


def ints_to_bytes(values: Sequence[int]) -> bytes:
    """Little-endian 32-byte field elements, back to back."""
    return b"".join(int(v).to_bytes(32, "little") for v in values)


def distinct(coeffs) -> Tuple[List[int], np.ndarray]:
    """(the distinct values of `coeffs` mod r, each entry's index among
    them). `coeffs` is an int64 array, where -1 stands for r - 1, or a
    sequence of Python ints."""
    arr = np.asarray(coeffs)
    if arr.dtype != object:
        uniq, codes = np.unique(arr.astype(np.int64), return_inverse=True)
        return [int(v) % R for v in uniq], codes.reshape(-1).astype(np.int64)
    index: Dict[int, int] = {}
    codes = np.fromiter((index.setdefault(int(v) % R, len(index)) for v in arr),
                        np.int64, len(arr))
    return list(index), codes


# ---------------------------------------------------------------------------
# Fr on a device
# ---------------------------------------------------------------------------


class Fr:
    """Arithmetic of Fr on limb-major (16, ...) int64 tensors."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.p = self.from_bytes(R.to_bytes(32, "little"))[:, 0]

    def from_bytes(self, raw: bytes) -> torch.Tensor:
        """32-byte little-endian elements -> (16, N)."""
        limbs = np.frombuffer(raw, dtype="<u2").reshape(-1, LIMBS).astype(np.int64)
        return torch.from_numpy(limbs.T.copy()).to(self.device)

    def from_ints(self, values: Sequence[int]) -> torch.Tensor:
        return self.from_bytes(ints_to_bytes([v % R for v in values]))

    def to_ints(self, x: torch.Tensor) -> List[int]:
        """(16, N) limbs (each limb any non-negative int64) -> ints mod r."""
        cols = x.reshape(LIMBS, -1).T.cpu().tolist()
        return [sum(int(c) << (BITS * j) for j, c in enumerate(col)) % R for col in cols]

    def mont_ints(self, values: Sequence[int]) -> torch.Tensor:
        """Plain ints -> their Montgomery forms v 2^256 mod r, (16, N)."""
        return self.from_ints([v * MONT % R for v in values])

    def _view(self, vec: torch.Tensor, ndim: int) -> torch.Tensor:
        return vec.view((LIMBS,) + (1,) * ndim)

    def _carry(self, t: torch.Tensor) -> torch.Tensor:
        """Carry-propagate a (L, ...) limb tensor in place (signed limbs
        allowed); the last limb keeps what is left over."""
        for j in range(t.shape[0] - 1):
            t[j + 1] += t[j] >> BITS
            t[j] &= MASK
        return t

    def _reduce_once(self, t: torch.Tensor) -> torch.Tensor:
        """(17, ...) normalized limbs of a value < 2r -> (16, ...) canonical."""
        d = t.clone()
        d[:LIMBS] -= self._view(self.p, t.dim() - 1)
        self._carry(d)
        keep = d[LIMBS] < 0  # t < r: the subtraction borrowed
        return torch.where(keep, t[:LIMBS], d[:LIMBS])

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        s = a + b
        t = torch.cat((s, torch.zeros_like(s[:1])))
        return self._reduce_once(self._carry(t))

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        s = a - b + self._view(self.p, a.dim() - 1)
        t = torch.cat((s, torch.zeros_like(s[:1])))
        return self._reduce_once(self._carry(t))

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Montgomery product a b 2^-256 mod r (CIOS over 16-bit limbs)."""
        shape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
        p = self._view(self.p, len(shape))
        t = torch.zeros((2 * LIMBS + 1,) + tuple(shape), dtype=torch.int64, device=self.device)
        for i in range(LIMBS):
            win = t[i : i + LIMBS]
            win += a[i] * b
            m = ((t[i] & MASK) * NPRIME) & MASK
            win += m * p
            t[i + 1] += t[i] >> BITS
        return self._reduce_once(self._carry(t[LIMBS:].clone()))

    def powers(self, w: int, count: int) -> torch.Tensor:
        """[w^i for i < count] in Montgomery form, (16, count)."""
        out = self.mont_ints([1])
        while out.shape[1] < count:
            step = self.mont_ints([pow(w, out.shape[1], R)])
            out = torch.cat((out, self.mul(out, step)), dim=1)
        return out[:, :count].contiguous()

    def sum_by_class(self, x: torch.Tensor, classes: torch.Tensor, n_classes: int) -> List[int]:
        """[sum of x[i] over i with classes[i] == c, mod r] for c < n_classes
        (x canonical (16, N); a class index of n_classes drops the element)."""
        acc = torch.zeros((LIMBS, n_classes + 1), dtype=torch.int64, device=self.device)
        acc.index_add_(1, classes, x)
        return self.to_ints(acc[:, :n_classes])


def bitrev(n: int, device) -> torch.Tensor:
    log_n = n.bit_length() - 1
    i = torch.arange(n, device=device)
    out = torch.zeros_like(i)
    for b in range(log_n):
        out |= ((i >> b) & 1) << (log_n - 1 - b)
    return out


def ntt(f: Fr, x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """Natural-order evaluations [sum_i x_i w^(ij)] of (16, n) Montgomery
    coefficients; tw holds w^i (Montgomery) for i < n/2. Iterative radix-2
    decimation in time from bit-reversed order."""
    n = x.shape[1]
    x = x[:, bitrev(n, x.device)]
    h = 1
    while h < n:
        x = x.reshape(LIMBS, n // (2 * h), 2, h)
        w = tw[:, :: n // (2 * h)][:, :h].reshape(LIMBS, 1, h)
        v = f.mul(x[:, :, 1], w)
        u = x[:, :, 0]
        x = torch.stack((f.add(u, v), f.sub(u, v)), dim=2).reshape(LIMBS, n)
        h *= 2
    return x


class Domain:
    """The tables of one radix-2 domain of size n and its coset."""

    def __init__(self, f: Fr, n: int):
        self.f, self.n = f, n
        w = root_of_unity(n)
        self.tw_fwd = f.powers(w, max(n // 2, 1))
        self.tw_inv = f.powers(pow(w, -1, R), max(n // 2, 1))
        self.n_inv = f.mont_ints([pow(n, -1, R)])
        self.coset = f.powers(root_of_unity(2 * n), n)  # g^i, g the 2n-th root

    def fft(self, x):
        return ntt(self.f, x, self.tw_fwd)

    def ifft(self, x):
        return self.f.mul(ntt(self.f, x, self.tw_inv), self.n_inv)

    def coset_eval(self, evals):
        """Evaluations on the domain -> evaluations on the coset g w^i."""
        return self.fft(self.f.mul(self.ifft(evals), self.coset))


def sparse_eval(f: Fr, rows, cols, coeffs_mont, z_mont, n: int) -> torch.Tensor:
    """[sum_j M[i][j] z_j for i < n], Montgomery, for the COO matrix M."""
    prod = f.mul(z_mont[:, cols], coeffs_mont)
    acc = torch.zeros((LIMBS + 1, n), dtype=torch.int64, device=f.device)
    acc[:LIMBS].index_add_(1, rows, prod)
    mult = int(torch.bincount(rows).max().item()) if rows.numel() else 1
    out = f._reduce_once(f._carry(acc))
    for _ in range(mult - 2):  # a row of m entries sums to < m r: m - 1 subtractions
        out = f._reduce_once(torch.cat((out, torch.zeros_like(out[:1]))))
    return out


def witness_map(f: Fr, dom: Domain, matrices: dict, k: int, z: torch.Tensor,
                num_inputs: int, coset: bool = True) -> torch.Tensor:
    """h (canonical, (16, n)) of the CircomReduction witness map for the
    canonical assignment z (16, n_vars), the k constraints' A and B as COO
    (rows, cols, coeffs) under matrices["a"] and ["b"]. `coset=False`
    evaluates on the domain itself instead of its coset: the control's
    broken guarantee."""
    n = dom.n
    z_mont = f.mul(z, f.from_ints([MONT * MONT % R]))
    dev = f.device
    ev = []
    for name in ("a", "b"):
        rows, cols, coeffs = matrices[name]
        values, codes = distinct(coeffs)
        coeffs_mont = f.mont_ints(values)[:, torch.as_tensor(codes, device=dev)]
        ev.append(sparse_eval(f, torch.as_tensor(rows, device=dev),
                              torch.as_tensor(cols, device=dev), coeffs_mont, z_mont, n))
    a, b = ev
    a[:, k : k + num_inputs] = z_mont[:, :num_inputs]
    c = f.mul(a, b)
    shift = dom.coset_eval if coset else (lambda x: dom.fft(dom.ifft(x)))
    a, b, c = shift(a), shift(b), shift(c)
    h = f.sub(f.mul(a, b), c)
    return f.mul(h, f.from_ints([1]))  # out of Montgomery form


# ---------------------------------------------------------------------------
# BN254 G1 and G2, Jacobian over Python ints
# ---------------------------------------------------------------------------


class _Fq:
    zero, one = 0, 1

    @staticmethod
    def add(a, b):
        return (a + b) % Q

    @staticmethod
    def sub(a, b):
        return (a - b) % Q

    @staticmethod
    def mul(a, b):
        return a * b % Q

    @staticmethod
    def inv(a):
        return pow(a, Q - 2, Q)


class _Fq2:
    zero, one = (0, 0), (1, 0)

    @staticmethod
    def add(a, b):
        return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)

    @staticmethod
    def sub(a, b):
        return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)

    @staticmethod
    def mul(a, b):  # u^2 = -1
        return ((a[0] * b[0] - a[1] * b[1]) % Q, (a[0] * b[1] + a[1] * b[0]) % Q)

    @staticmethod
    def inv(a):
        d = pow((a[0] * a[0] + a[1] * a[1]) % Q, Q - 2, Q)
        return (a[0] * d % Q, -a[1] * d % Q)


class Curve:
    """y^2 = x^3 + b over _Fq or _Fq2, Jacobian (X, Y, Z); Z = 0 is infinity."""

    def __init__(self, F, gen):
        self.F = F
        self.inf = (F.one, F.one, F.zero)
        self.gen = (gen[0], gen[1], F.one)
        self._table = None

    def double(self, P):
        F = self.F
        X, Y, Z = P
        if Z == F.zero:
            return P
        A, B = F.mul(X, X), F.mul(Y, Y)
        C = F.mul(B, B)
        t = F.add(X, B)
        D = F.sub(F.sub(F.mul(t, t), A), C)
        D = F.add(D, D)
        E = F.add(F.add(A, A), A)
        X3 = F.sub(F.mul(E, E), F.add(D, D))
        C8 = F.add(C, C)
        C8 = F.add(C8, C8)
        C8 = F.add(C8, C8)
        Y3 = F.sub(F.mul(E, F.sub(D, X3)), C8)
        YZ = F.mul(Y, Z)
        return (X3, Y3, F.add(YZ, YZ))

    def add(self, P, Qp):
        F = self.F
        if P[2] == F.zero:
            return Qp
        if Qp[2] == F.zero:
            return P
        X1, Y1, Z1 = P
        X2, Y2, Z2 = Qp
        Z1Z1, Z2Z2 = F.mul(Z1, Z1), F.mul(Z2, Z2)
        U1, U2 = F.mul(X1, Z2Z2), F.mul(X2, Z1Z1)
        S1, S2 = F.mul(F.mul(Y1, Z2), Z2Z2), F.mul(F.mul(Y2, Z1), Z1Z1)
        H, rr = F.sub(U2, U1), F.sub(S2, S1)
        if H == F.zero:
            return self.double(P) if rr == F.zero else self.inf
        HH = F.mul(H, H)
        HHH = F.mul(H, HH)
        V = F.mul(U1, HH)
        X3 = F.sub(F.sub(F.mul(rr, rr), HHH), F.add(V, V))
        Y3 = F.sub(F.mul(rr, F.sub(V, X3)), F.mul(S1, HHH))
        Z3 = F.mul(F.mul(Z1, Z2), H)
        return (X3, Y3, Z3)

    def mul_gen(self, k: int):
        """k G by Yao's method over the generator's 2^(4j) multiples."""
        if self._table is None:
            t, P = [], self.gen
            for _ in range(64):
                t.append(P)
                for _ in range(4):
                    P = self.double(P)
            self._table = t
        k %= R
        acc, run = self.inf, self.inf
        digits = [(k >> (4 * j)) & 15 for j in range(64)]
        for d in range(15, 0, -1):
            for j, dj in enumerate(digits):
                if dj == d:
                    run = self.add(run, self._table[j])
            acc = self.add(acc, run)
        return acc

    def affine(self, P):
        """(x, y), or None for infinity."""
        F = self.F
        if P[2] == F.zero:
            return None
        zi = F.inv(P[2])
        zi2 = F.mul(zi, zi)
        return (F.mul(P[0], zi2), F.mul(P[1], F.mul(zi2, zi)))


G1 = Curve(_Fq, G1_GEN)
G2 = Curve(_Fq2, G2_GEN)


# ---------------------------------------------------------------------------
# The expected proof
# ---------------------------------------------------------------------------


class Reference:
    """The expected proofs of one pooled key (inputs.PooledKey) on its
    circuit; `witness(x)` is the circuit generator's witness of a pool
    input x, bound to its configuration."""

    def __init__(self, key, witness: Callable[[object], List[int]], device):
        self.key, self.witness = key, witness
        self.f = Fr(device)
        self.dom = Domain(self.f, key.domain_size)
        dev = self.f.device
        self.classes = {name: torch.as_tensor(idx, device=dev)
                        for name, idx in key.class_index().items()}

    def scalars(self, x, coset: bool = True) -> Dict[str, object]:
        """The assignment z, h, the public signals z[1:num_inputs], and the
        dot products of the key's sections with z and h: what a proof needs
        besides r and s."""
        key, f = self.key, self.f
        ni = key.num_inputs
        w = self.witness(x)
        z = f.from_ints(w)
        h = witness_map(f, self.dom, key.matrices, key.num_constraints, z, ni, coset)
        dots = {}
        for name, vec in (("a", z), ("b1", z), ("b2", z), ("l", z[:, ni:]), ("h", h)):
            sums = f.sum_by_class(vec, self.classes[name], key.pool)
            dots[name] = sum(s * kj for s, kj in zip(sums, key.ks)) % R
        return {"z": z, "h": h, "dots": dots, "public": [v % R for v in w[1:ni]],
                "num_inputs": ni}

    def proof(self, dots: Dict[str, int], r: int, s: int):
        """(A, B, C) affine: A, C in G1 as (x, y), B in G2 as ((x0, x1), (y0, y1))."""
        key = self.key
        a_sc = (key.alpha + dots["a"] + r * key.delta) % R
        b1_sc = (key.beta + dots["b1"] + s * key.delta) % R
        b2_sc = (key.beta + dots["b2"] + s * key.delta) % R
        c_sc = (dots["l"] + dots["h"] + s * a_sc + r * b1_sc - r * s * key.delta) % R
        return (G1.affine(G1.mul_gen(a_sc)), G2.affine(G2.mul_gen(b2_sc)),
                G1.affine(G1.mul_gen(c_sc)))


def proof_tuple(proof_json: dict) -> Tuple:
    """A snarkjs proof JSON -> (A, B, C) affine ints, as Reference.proof."""
    def g1(v):
        x, y, z = (int(c) for c in v)
        return None if z == 0 else (x, y)

    def g2(v):
        (x0, x1), (y0, y1), (z0, z1) = ((int(p), int(q)) for p, q in v)
        return None if (z0, z1) == (0, 0) else ((x0, x1), (y0, y1))

    return (g1(proof_json["pi_a"]), g2(proof_json["pi_b"]), g1(proof_json["pi_c"]))
