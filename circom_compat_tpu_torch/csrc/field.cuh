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
//   mul_lazy  CIOS with 32x32->64-bit products and no final subtraction.
//             For a, b < 2p the result (ab + mp)/R < 2p since p < R/4 for
//             both moduli, so the lazy range is closed under it.
//   mul       mul_lazy + one conditional subtraction of p: canonical.
//   add       a + b, minus 2p if >= 2p.
//   add_canon a + b, minus p if >= p (canonical inputs only).
//   sub       a - b + 2p, minus 2p if >= 2p.
// These match ops/field.py word for word (CIOS's m is the unique m < R with
// ab + mp = 0 mod R, whatever the digit width).
//
// Cost: one mul is 8x8 products for a*b and 8x8 for m*p, each product a
// 32-bit mad.lo + mad.hi pair, plus 8 products for m: 264 32-bit integer
// multiply-adds. ops/field_kernels.py counts bounds from this figure.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ccf {

struct Fe {
  uint32_t w[8];
};

static __constant__ uint32_t kFrP[8] = {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
                                        0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
static __constant__ uint32_t kFrP2[8] = {0xe0000002u, 0x87c3eb27u, 0xf372e122u, 0x5067d090u,
                                         0x0302b0bau, 0x70a08b6du, 0xc2634053u, 0x60c89ce5u};
static __constant__ uint32_t kFqP[8] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                                        0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
static __constant__ uint32_t kFqP2[8] = {0xb0f9fa8eu, 0x7841182du, 0xd0e3951au, 0x2f02d522u,
                                         0x0302b0bbu, 0x70a08b6du, 0xc2634053u, 0x60c89ce5u};
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

struct Fr {
  static constexpr uint32_t INV = 0xefffffffu;  // -p^-1 mod 2^32
  static __device__ __forceinline__ uint32_t P(int i) { return kFrP[i]; }
  static __device__ __forceinline__ uint32_t P2(int i) { return kFrP2[i]; }
};

struct Fq {
  static constexpr uint32_t INV = 0xe4866389u;
  static __device__ __forceinline__ uint32_t P(int i) { return kFqP[i]; }
  static __device__ __forceinline__ uint32_t P2(int i) { return kFqP2[i]; }
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

// Global loads and stores as two 16-byte vectors: the wrappers pass
// 16-byte aligned tensors whose elements are 32-byte rows.
__device__ __forceinline__ Fe load(const uint32_t* p) {
  const uint4 lo = reinterpret_cast<const uint4*>(p)[0];
  const uint4 hi = reinterpret_cast<const uint4*>(p)[1];
  return Fe{{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
}

__device__ __forceinline__ void store(uint32_t* p, const Fe& a) {
  reinterpret_cast<uint4*>(p)[0] = make_uint4(a.w[0], a.w[1], a.w[2], a.w[3]);
  reinterpret_cast<uint4*>(p)[1] = make_uint4(a.w[4], a.w[5], a.w[6], a.w[7]);
}

__device__ __forceinline__ Fe select(bool c, const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.w[j] = c ? a.w[j] : b.w[j];
  return r;
}

// x - M if x >= M, else x (M given word by word through the accessor).
template <class Words>
__device__ __forceinline__ Fe cond_sub(const Fe& x, Words m) {
  Fe d;
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t t = (uint64_t)x.w[j] - m(j) - borrow;
    d.w[j] = (uint32_t)t;
    borrow = t >> 63;
  }
  return borrow ? x : d;
}

__device__ __forceinline__ Fe add_raw(const Fe& a, const Fe& b) {
  Fe s;
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t t = (uint64_t)a.w[j] + b.w[j] + c;
    s.w[j] = (uint32_t)t;
    c = t >> 32;
  }
  return s;
}

template <class F>
__device__ __forceinline__ Fe add(const Fe& a, const Fe& b) {
  return cond_sub(add_raw(a, b), [](int j) { return F::P2(j); });
}

// a + b, minus p if >= p: canonical for canonical inputs (the K9 "add")
template <class F>
__device__ __forceinline__ Fe add_canon(const Fe& a, const Fe& b) {
  return cond_sub(add_raw(a, b), [](int j) { return F::P(j); });
}

template <class F>
__device__ __forceinline__ Fe sub(const Fe& a, const Fe& b) {
  // a + 2p < 4p < 2^256 cannot overflow, and a + 2p - b > 0 cannot borrow
  Fe s;
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t t = (uint64_t)a.w[j] + F::P2(j) + c;
    s.w[j] = (uint32_t)t;
    c = t >> 32;
  }
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t t = (uint64_t)s.w[j] - b.w[j] - borrow;
    s.w[j] = (uint32_t)t;
    borrow = t >> 63;
  }
  return cond_sub(s, [](int j) { return F::P2(j); });
}

template <class F>
__device__ __forceinline__ Fe mul_lazy(const Fe& a, const Fe& b) {
  uint32_t t[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) t[j] = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t s = (uint64_t)a.w[j] * b.w[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[8] + c;
    t[8] = (uint32_t)s;
    t[9] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * F::INV;
    s = (uint64_t)m * F::P(0) + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      s = (uint64_t)m * F::P(j) + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[8] + c;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.w[j] = t[j];
  return r;
}

template <class F>
__device__ __forceinline__ Fe mul(const Fe& a, const Fe& b) {
  return cond_sub(mul_lazy<F>(a, b), [](int j) { return F::P(j); });
}

// ---- Fq2 = Fq[u]/(u^2 + 1), lazy like its base field ----------------------

struct Fe2 {
  Fe c0, c1;
};

__device__ __forceinline__ Fe2 add2(const Fe2& a, const Fe2& b) {
  return {add<Fq>(a.c0, b.c0), add<Fq>(a.c1, b.c1)};
}

__device__ __forceinline__ Fe2 sub2(const Fe2& a, const Fe2& b) {
  return {sub<Fq>(a.c0, b.c0), sub<Fq>(a.c1, b.c1)};
}

// Karatsuba: v0 = a0 b0, v1 = a1 b1, s = (a0 + a1)(b0 + b1);
// (v0 - v1, (s - v0) - v1), the operation order of ops/curve.py.
__device__ __forceinline__ Fe2 mul2(const Fe2& a, const Fe2& b) {
  Fe v0 = mul_lazy<Fq>(a.c0, b.c0);
  Fe v1 = mul_lazy<Fq>(a.c1, b.c1);
  Fe s = mul_lazy<Fq>(add<Fq>(a.c0, a.c1), add<Fq>(b.c0, b.c1));
  return {sub<Fq>(v0, v1), sub<Fq>(sub<Fq>(s, v0), v1)};
}

}  // namespace ccf
