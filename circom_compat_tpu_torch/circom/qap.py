"""CircomReduction: the snarkjs R1CS->QAP witness map (host reference).

This is the one piece of prover math the reference owns
(reference: src/circom/qap.rs:12-106). The arkworks witness map computes H
coefficients as (AB-C)/Z in the evaluation domain; snarkjs instead
precomputes the Lagrange form of the powers-of-tau bases in a domain twice
as large, and the witness map is the odd coefficients of (AB-C) in that
domain, serving as HZ when computing the C proof element.

The device implementation of the same map lives in ops/ntt.py; this module
is its host oracle.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..constants import R_SCALAR, fr_root_of_unity
from ..refmath import poly


def domain_size_for(num_constraints: int, num_inputs: int) -> int:
    n = num_constraints + num_inputs
    size = 1
    while size < n:
        size <<= 1
    return size


def evaluate_constraint(lc: Sequence[Tuple[int, int]], assignment: Sequence[int]) -> int:
    """Sparse dot product sum(coeff * w[signal]) — rows are [(value, signal)]
    (matching arkworks' evaluate_constraint used at src/circom/qap.rs:37-44)."""
    acc = 0
    for coeff, signal in lc:
        acc += coeff * assignment[signal]
    return acc % R_SCALAR


def witness_map_from_matrices(
    matrix_a: List[List[Tuple[int, int]]],
    matrix_b: List[List[Tuple[int, int]]],
    num_inputs: int,
    num_constraints: int,
    full_assignment: Sequence[int],
) -> List[int]:
    """Return the HZ evaluations (reference: src/circom/qap.rs:23-88).

    Steps: evaluate a/b per constraint; copy the public inputs into
    a[num_constraints..] (replacing arkworks' identity rows, :46-50);
    c = a*b elementwise; iFFT a,b,c; shift by powers of the 2n-th root of
    unity (coset); FFT back; return ab - c on the coset.
    """
    domain_size = domain_size_for(num_constraints, num_inputs)

    a = [0] * domain_size
    b = [0] * domain_size
    for i in range(num_constraints):
        a[i] = evaluate_constraint(matrix_a[i], full_assignment)
        b[i] = evaluate_constraint(matrix_b[i], full_assignment)
    for i in range(num_inputs):
        a[num_constraints + i] = full_assignment[i] % R_SCALAR

    c = [0] * domain_size
    for i in range(num_constraints):
        c[i] = a[i] * b[i] % R_SCALAR

    root_2n = fr_root_of_unity(2 * domain_size)

    a = poly.ifft(a)
    b = poly.ifft(b)
    a = poly.distribute_powers(a, root_2n)
    b = poly.distribute_powers(b, root_2n)
    a = poly.fft(a)
    b = poly.fft(b)

    ab = [x * y % R_SCALAR for x, y in zip(a, b)]

    c = poly.ifft(c)
    c = poly.distribute_powers(c, root_2n)
    c = poly.fft(c)

    return [(x - y) % R_SCALAR for x, y in zip(ab, c)]


def h_query_scalars(max_power: int, t: int, delta_inverse: int) -> List[int]:
    """Scalars of the H query at setup: delta^-1 * t^i Lagrange-ified over
    the 2x domain, odd indices (reference: src/circom/qap.rs:90-105). The
    host oracle of the setup's closed form (models/setup.py)."""
    scalars = [delta_inverse * pow(t, i, R_SCALAR) % R_SCALAR for i in range(2 * max_power + 1)]
    size = 1
    while size < len(scalars):
        size <<= 1
    scalars += [0] * (size - len(scalars))
    return poly.ifft(scalars)[1::2]
