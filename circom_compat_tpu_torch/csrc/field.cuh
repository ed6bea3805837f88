// BN254 Fr / Fq Montgomery arithmetic for the CUDA kernels (sm_90a).
//
// Replaces the limb-major field core of the JAX package
// (circom_compat_tpu/ops/field_lm.py: mont_mul, mont_mul_lazy, add_lazy,
// sub_lazy, cond_sub_p), which is the arithmetic inside every Pallas kernel.
// It is not a kernel itself; field_kernels.cu and curve_kernels.cu include it.
//
// An element is 8 little-endian 32-bit words (the zkey's 16x16-bit limbs
// read as uint32), Montgomery R = 2^256. Values stay LAZY in [0, 2p)
// between operations:
//   mul_lazy  CIOS with no final subtraction. For a, b < 2p the result
//             (ab + mp)/R < 2p since p < R/4 for both moduli, so the lazy
//             range is closed under it.
//   mul       mul_lazy + one conditional subtraction of p: canonical.
//   add       a + b, minus 2p if >= 2p.
//   add_canon a + b, minus p if >= p (canonical inputs only).
//   sub       a - b, plus 2p if that borrowed: the value of a - b + 2p
//             minus 2p if >= 2p, the plain version's formula.
// These match ops/field.py word for word (CIOS's m is the unique m < R with
// ab + mp = 0 mod R, whatever the digit width or carry order).
//
// What bounds it and what the design does: every kernel here is bound by
// integer multiply-adds or by the dependent carries between them. Each
// carry chain is inline PTX on 32-bit words (add.cc/addc, sub.cc/subc,
// mad.lo.cc/madc.hi.cc), so no 64-bit temporary stays live and each word
// costs one instruction: a CIOS row is one lo chain and one hi chain of 8
// multiply-adds for a * b[i], then the same for m * p, the moduli as
// immediates. One mul is 8 x (16 + 16) products plus 8 for m: 264 32-bit
// integer multiply-adds. ops/field_kernels.py and chip_smoke.py count
// bounds from this figure. A carry flag lives only inside one asm
// statement, so each chain is one statement.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ccf {

struct Fe {
  uint32_t w[8];
};

// Fq Montgomery one (R mod q)
static __constant__ uint32_t kFqOne[8] = {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
                                          0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
// 3b' = 9/(9+u) of the G2 twist, Montgomery (c0, c1) and c0 + c1
static __constant__ uint32_t kB3C0[8] = {0xb62e0d6au, 0x3baa927cu, 0xd1b664fdu, 0xd71e7c52u,
                                         0xd95d4664u, 0x03873e63u, 0x082ab8f4u, 0x0e75b5b1u};
static __constant__ uint32_t kB3C1[8] = {0x7596fe35u, 0xaab7c666u, 0xbb6a27bau, 0x31d21a78u,
                                         0x680401ffu, 0x85dd7297u, 0xdf39a7e9u, 0x03c52d6au};
static __constant__ uint32_t kB3Sum[8] = {0x2bc50b9fu, 0xe66258e3u, 0x8d208cb7u, 0x08f096cbu,
                                          0x41614864u, 0x8964b0fbu, 0xe76460ddu, 0x123ae31bu};

// The moduli are compile-time words, so ptxas folds them into immediates.
struct Fr {
  static constexpr uint32_t INV = 0xefffffffu;  // -p^-1 mod 2^32
  static __device__ __forceinline__ constexpr uint32_t P(int i) {
    constexpr uint32_t p[8] = {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
                               0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return p[i];
  }
  static __device__ __forceinline__ constexpr uint32_t P2(int i) {
    constexpr uint32_t p2[8] = {0xe0000002u, 0x87c3eb27u, 0xf372e122u, 0x5067d090u,
                                0x0302b0bau, 0x70a08b6du, 0xc2634053u, 0x60c89ce5u};
    return p2[i];
  }
};

struct Fq {
  static constexpr uint32_t INV = 0xe4866389u;
  static __device__ __forceinline__ constexpr uint32_t P(int i) {
    constexpr uint32_t p[8] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                               0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return p[i];
  }
  static __device__ __forceinline__ constexpr uint32_t P2(int i) {
    constexpr uint32_t p2[8] = {0xb0f9fa8eu, 0x7841182du, 0xd0e3951au, 0x2f02d522u,
                                0x0302b0bbu, 0x70a08b6du, 0xc2634053u, 0x60c89ce5u};
    return p2[i];
  }
};

__device__ __forceinline__ Fe load_const(const uint32_t* c) {
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.w[j] = c[j];
  return r;
}

__device__ __forceinline__ Fe zero() {
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.w[j] = 0u;
  return r;
}

__device__ __forceinline__ bool is_zero(const Fe& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) acc |= a.w[j];
  return acc == 0u;
}

// Loads and stores as two 16-byte vectors: the wrappers pass 16-byte
// aligned tensors whose elements are 32-byte rows (and shared-memory rows
// are 16-byte aligned).
__device__ __forceinline__ Fe load(const uint32_t* p) {
  const uint4 lo = reinterpret_cast<const uint4*>(p)[0];
  const uint4 hi = reinterpret_cast<const uint4*>(p)[1];
  return Fe{{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
}

// A load the compiler may neither merge with another nor move: formulas
// read an operand again at each use instead of keeping it in registers.
__device__ __forceinline__ Fe load_again(const uint32_t* p) {
  Fe r;
  asm volatile("ld.v4.u32 {%0, %1, %2, %3}, [%8];\n\t"
               "ld.v4.u32 {%4, %5, %6, %7}, [%8+16];"
               : "=r"(r.w[0]), "=r"(r.w[1]), "=r"(r.w[2]), "=r"(r.w[3]),
                 "=r"(r.w[4]), "=r"(r.w[5]), "=r"(r.w[6]), "=r"(r.w[7])
               : "l"(p));
  return r;
}

__device__ __forceinline__ void store(uint32_t* p, const Fe& a) {
  reinterpret_cast<uint4*>(p)[0] = make_uint4(a.w[0], a.w[1], a.w[2], a.w[3]);
  reinterpret_cast<uint4*>(p)[1] = make_uint4(a.w[4], a.w[5], a.w[6], a.w[7]);
}

// ---- carry chains ---------------------------------------------------------

// a + b (no carry out: every caller's sum is below 2^256)
__device__ __forceinline__ Fe add_raw(const Fe& a, const Fe& b) {
  Fe s;
  asm("add.cc.u32  %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32    %7, %15, %23;"
      : "=r"(s.w[0]), "=r"(s.w[1]), "=r"(s.w[2]), "=r"(s.w[3]),
        "=r"(s.w[4]), "=r"(s.w[5]), "=r"(s.w[6]), "=r"(s.w[7])
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]),
        "r"(a.w[4]), "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]),
        "r"(b.w[0]), "r"(b.w[1]), "r"(b.w[2]), "r"(b.w[3]),
        "r"(b.w[4]), "r"(b.w[5]), "r"(b.w[6]), "r"(b.w[7]));
  return s;
}

// d = a - b mod 2^256; returns the borrow out as a mask (0 or ~0)
__device__ __forceinline__ uint32_t sub_borrow(Fe& d, const Fe& a, const Fe& b) {
  uint32_t mask = 0u;
  asm("sub.cc.u32  %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32    %8, %8, 0;"
      : "=r"(d.w[0]), "=r"(d.w[1]), "=r"(d.w[2]), "=r"(d.w[3]),
        "=r"(d.w[4]), "=r"(d.w[5]), "=r"(d.w[6]), "=r"(d.w[7]), "+r"(mask)
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]),
        "r"(a.w[4]), "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]),
        "r"(b.w[0]), "r"(b.w[1]), "r"(b.w[2]), "r"(b.w[3]),
        "r"(b.w[4]), "r"(b.w[5]), "r"(b.w[6]), "r"(b.w[7]));
  return mask;
}

// The words of p (or of 2p when k2p), each ANDed with mask
template <class F, bool k2p>
__device__ __forceinline__ Fe modulus_words(uint32_t mask) {
  Fe m;
#pragma unroll
  for (int j = 0; j < 8; ++j) m.w[j] = (k2p ? F::P2(j) : F::P(j)) & mask;
  return m;
}

// x - p (or x - 2p when k2p) if that does not borrow, else x
template <class F, bool k2p>
__device__ __forceinline__ Fe cond_sub(const Fe& x) {
  Fe d;
  const uint32_t borrow = sub_borrow(d, x, modulus_words<F, k2p>(~0u));
  return borrow ? x : d;
}

template <class F>
__device__ __forceinline__ Fe add(const Fe& a, const Fe& b) {
  return cond_sub<F, true>(add_raw(a, b));
}

// a + b, minus p if >= p: canonical for canonical inputs (the K9 "add")
template <class F>
__device__ __forceinline__ Fe add_canon(const Fe& a, const Fe& b) {
  return cond_sub<F, false>(add_raw(a, b));
}

template <class F>
__device__ __forceinline__ Fe sub(const Fe& a, const Fe& b) {
  Fe d;
  const uint32_t borrow = sub_borrow(d, a, b);
  return add_raw(d, modulus_words<F, true>(borrow));
}

// t[0..9] = t[0..8] + a * b with t[9] = 0 on entry: the lo words of each
// product in one chain, then the hi words one word up in another.
__device__ __forceinline__ void mac_row(uint32_t (&t)[10], const Fe& a, uint32_t b) {
  asm("mad.lo.cc.u32  %0, %10, %18, %0;\n\t"
      "madc.lo.cc.u32 %1, %11, %18, %1;\n\t"
      "madc.lo.cc.u32 %2, %12, %18, %2;\n\t"
      "madc.lo.cc.u32 %3, %13, %18, %3;\n\t"
      "madc.lo.cc.u32 %4, %14, %18, %4;\n\t"
      "madc.lo.cc.u32 %5, %15, %18, %5;\n\t"
      "madc.lo.cc.u32 %6, %16, %18, %6;\n\t"
      "madc.lo.cc.u32 %7, %17, %18, %7;\n\t"
      "addc.cc.u32    %8, %8, 0;\n\t"
      "addc.u32       %9, %9, 0;\n\t"
      "mad.hi.cc.u32  %1, %10, %18, %1;\n\t"
      "madc.hi.cc.u32 %2, %11, %18, %2;\n\t"
      "madc.hi.cc.u32 %3, %12, %18, %3;\n\t"
      "madc.hi.cc.u32 %4, %13, %18, %4;\n\t"
      "madc.hi.cc.u32 %5, %14, %18, %5;\n\t"
      "madc.hi.cc.u32 %6, %15, %18, %6;\n\t"
      "madc.hi.cc.u32 %7, %16, %18, %7;\n\t"
      "madc.hi.cc.u32 %8, %17, %18, %8;\n\t"
      "addc.u32       %9, %9, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9])
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]),
        "r"(a.w[4]), "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]), "r"(b));
}

// t += m * p with m = t[0] * INV, which clears t[0]
template <class F>
__device__ __forceinline__ void reduce_row(uint32_t (&t)[10]) {
  const uint32_t m = t[0] * F::INV;
  asm("mad.lo.cc.u32  %0, %10, %11, %0;\n\t"
      "madc.lo.cc.u32 %1, %10, %12, %1;\n\t"
      "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
      "madc.lo.cc.u32 %3, %10, %14, %3;\n\t"
      "madc.lo.cc.u32 %4, %10, %15, %4;\n\t"
      "madc.lo.cc.u32 %5, %10, %16, %5;\n\t"
      "madc.lo.cc.u32 %6, %10, %17, %6;\n\t"
      "madc.lo.cc.u32 %7, %10, %18, %7;\n\t"
      "addc.cc.u32    %8, %8, 0;\n\t"
      "addc.u32       %9, %9, 0;\n\t"
      "mad.hi.cc.u32  %1, %10, %11, %1;\n\t"
      "madc.hi.cc.u32 %2, %10, %12, %2;\n\t"
      "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
      "madc.hi.cc.u32 %4, %10, %14, %4;\n\t"
      "madc.hi.cc.u32 %5, %10, %15, %5;\n\t"
      "madc.hi.cc.u32 %6, %10, %16, %6;\n\t"
      "madc.hi.cc.u32 %7, %10, %17, %7;\n\t"
      "madc.hi.cc.u32 %8, %10, %18, %8;\n\t"
      "addc.u32       %9, %9, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9])
      : "r"(m), "r"(F::P(0)), "r"(F::P(1)), "r"(F::P(2)), "r"(F::P(3)),
        "r"(F::P(4)), "r"(F::P(5)), "r"(F::P(6)), "r"(F::P(7)));
}

template <class F>
__device__ __forceinline__ Fe mul_lazy(const Fe& a, const Fe& b) {
  uint32_t t[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) t[j] = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mac_row(t, a, b.w[i]);
    reduce_row<F>(t);
#pragma unroll
    for (int j = 0; j < 9; ++j) t[j] = t[j + 1];
    t[9] = 0u;
  }
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.w[j] = t[j];
  return r;
}

template <class F>
__device__ __forceinline__ Fe mul(const Fe& a, const Fe& b) {
  return cond_sub<F, false>(mul_lazy<F>(a, b));
}

}  // namespace ccf
