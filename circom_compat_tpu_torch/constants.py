"""BN254 (alt_bn128) curve and field constants.

These are the parameters pinned by the reference stack:
- Fr modulus r is hard-coded (LE bytes) in the reference r1cs parser
  (reference: src/circom/r1cs_reader.rs:180-188).
- Fq modulus q and the Montgomery convention (R = 2**256) follow arkworks
  BigInteger256 / snarkjs ffjavascript n8=32 encodings
  (reference: src/zkey.rs:320-332).

Everything else here is derived arithmetically at import time.
"""

# ---------------------------------------------------------------------------
# Prime moduli
# ---------------------------------------------------------------------------

# Base field modulus (coordinates of G1/G2 points).
Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583

# Scalar field modulus (witness values, constraint coefficients).
R_SCALAR = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# Little-endian byte encodings (32 bytes), as they appear in .r1cs/.zkey headers.
Q_BYTES_LE = Q.to_bytes(32, "little")
R_BYTES_LE = R_SCALAR.to_bytes(32, "little")

# ---------------------------------------------------------------------------
# Montgomery form: R = 2**256 (arkworks BigInteger256 / snarkjs LEM encoding)
# ---------------------------------------------------------------------------

MONT_BITS = 256
MONT_R = 1 << MONT_BITS

# For Fq (point coordinates): .zkey stores x*R mod q ("LEM" form).
MONT_R_Q = MONT_R % Q
MONT_R_INV_Q = pow(MONT_R_Q, -1, Q)
MONT_R2_Q = (MONT_R_Q * MONT_R_Q) % Q

# For Fr (scalars / matrix coefficients): .zkey section 4 stores v*R^2 mod r,
# so a raw read needs a double Montgomery strip (reference: src/zkey.rs:320-325).
MONT_R_R = MONT_R % R_SCALAR
MONT_R_INV_R = pow(MONT_R_R, -1, R_SCALAR)
MONT_R2_R = (MONT_R_R * MONT_R_R) % R_SCALAR

# ---------------------------------------------------------------------------
# Curve parameters:  G1: y^2 = x^3 + 3 over Fq;  G2: y^2 = x^3 + 3/(9+u) over Fq2
# ---------------------------------------------------------------------------

B_G1 = 3

# Fq2 = Fq[u] / (u^2 + 1); elements are (c0, c1) = c0 + c1*u.
# b2 = 3 / (9 + u)
_xi_inv_den = pow(9 * 9 + 1, -1, Q)  # 1/(81+1) since (9+u)(9-u) = 81+1
B_G2 = ((3 * 9 * _xi_inv_den) % Q, (-3 * _xi_inv_den) % Q)

# Generators
G1_GEN = (1, 2)
G2_GEN = (
    (
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    (
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)

# BN parameter x such that q = 36x^4 + 36x^3 + 24x^2 + 6x + 1
BN_X = 4965661367192848881
ATE_LOOP_COUNT = 6 * BN_X + 2  # 29793968203157093288
LOG_ATE_LOOP_COUNT = 63

# ---------------------------------------------------------------------------
# Fr multiplicative structure (for NTT evaluation domains)
# ---------------------------------------------------------------------------

# r - 1 = 2^28 * T_ODD
TWO_ADICITY = 28
T_ODD = (R_SCALAR - 1) >> TWO_ADICITY
assert T_ODD & 1 == 1
assert (T_ODD << TWO_ADICITY) == R_SCALAR - 1

# Multiplicative generator of Fr* used by both arkworks ark-bn254 and
# snarkjs/ffjavascript (smallest generator, 5). The 2^28-th root of unity
# derived from it therefore matches the roots baked into snarkjs .zkey
# Lagrange bases. Pinned by tests/test_constants.py.
FR_GENERATOR = 5
TWO_ADIC_ROOT_OF_UNITY = pow(FR_GENERATOR, T_ODD, R_SCALAR)


def fr_root_of_unity(domain_size: int) -> int:
    """Primitive `domain_size`-th root of unity in Fr.

    Matches arkworks Radix2EvaluationDomain::group_gen for the same size
    (used by the reference witness map, src/circom/qap.rs:30-32) and the
    roots snarkjs uses when baking .zkey Lagrange bases.
    """
    if domain_size & (domain_size - 1) != 0:
        raise ValueError(f"domain size {domain_size} is not a power of two")
    log_n = domain_size.bit_length() - 1
    if log_n > TWO_ADICITY:
        raise ValueError(f"domain size 2^{log_n} exceeds Fr 2-adicity 2^{TWO_ADICITY}")
    return pow(TWO_ADIC_ROOT_OF_UNITY, 1 << (TWO_ADICITY - log_n), R_SCALAR)


# ---------------------------------------------------------------------------
# Frobenius / final exponentiation helpers for the pairing
# ---------------------------------------------------------------------------

FQ12_MODULUS_COEFFS = (82, 0, 0, 0, 0, 0, -18, 0, 0, 0, 0, 0)  # w^12 = 18w^6 - 82

# ---------------------------------------------------------------------------
# Device limb decomposition (ops/ kernels)
# ---------------------------------------------------------------------------

# The zkey wire form of a field element is NUM_LIMBS little-endian limbs of
# LIMB_BITS bits. On the card the same bytes are read as WORDS 32-bit words
# (ops/field.py); the plain PyTorch versions compute on the 16-bit limbs in
# int64, which keeps every CIOS column sum exact.
LIMB_BITS = 16
NUM_LIMBS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
assert LIMB_BITS * NUM_LIMBS == 256
WORDS = 8  # 32-bit words per field element

# Montgomery n' = -p^(-1) mod 2^LIMB_BITS for the per-limb reduction step.
NPRIME_Q = (-pow(Q, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
NPRIME_R = (-pow(R_SCALAR, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
