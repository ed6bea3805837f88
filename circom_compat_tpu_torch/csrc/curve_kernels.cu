// G1/G2 point kernels of the MSM: K6/K7 point_add, K8 point_tile_scan.
//
// Points are homogeneous projective (X, Y, Z), identity (0, 1, 0), lazy
// Montgomery words: G1 24 words (X, Y, Z), G2 48 words (X.c0, X.c1, Y.c0,
// ...). The group law is the complete Renes-Costello-Batina formula (a = 0):
// add 12M + 2 mul_b3, mixed add 11M + 2 mul_b3 plus a select for Q at
// infinity, in the operation order of ops/curve.py (the plain versions),
// so kernel and plain version agree word for word.
//
// Plain C entry points (ctypes); each launches on the caller's stream and
// returns cudaGetLastError().
#include "field.cuh"

using namespace ccf;

namespace {

struct G1 {
  using E = Fe;
  static constexpr int kWords = 8;  // words per coordinate
  static __device__ __forceinline__ E add(const E& a, const E& b) { return ccf::add<Fq>(a, b); }
  static __device__ __forceinline__ E sub(const E& a, const E& b) { return ccf::sub<Fq>(a, b); }
  static __device__ __forceinline__ E mul(const E& a, const E& b) { return mul_lazy<Fq>(a, b); }
  static __device__ __forceinline__ E mul_b3(const E& a) {  // 9a = 8a + a
    E x2 = add(a, a);
    E x4 = add(x2, x2);
    E x8 = add(x4, x4);
    return add(x8, a);
  }
  static __device__ __forceinline__ E load(const uint32_t* p) { return ccf::load(p); }
  static __device__ __forceinline__ void store(uint32_t* p, const E& a) { ccf::store(p, a); }
  static __device__ __forceinline__ bool is_zero(const E& a) { return ccf::is_zero(a); }
  static __device__ __forceinline__ E zero() { return ccf::zero(); }
  static __device__ __forceinline__ E one() { return load_const(kFqOne); }
  static __device__ __forceinline__ E sel(bool c, const E& a, const E& b) { return select(c, a, b); }
};

struct G2 {
  using E = Fe2;
  static constexpr int kWords = 16;
  static __device__ __forceinline__ E add(const E& a, const E& b) { return add2(a, b); }
  static __device__ __forceinline__ E sub(const E& a, const E& b) { return sub2(a, b); }
  static __device__ __forceinline__ E mul(const E& a, const E& b) { return mul2(a, b); }
  // constant Karatsuba against 3b' = (c0, c1) with the reduced c0 + c1
  static __device__ __forceinline__ E mul_b3(const E& a) {
    Fe v0 = mul_lazy<Fq>(load_const(kB3C0), a.c0);
    Fe v1 = mul_lazy<Fq>(load_const(kB3C1), a.c1);
    Fe s = mul_lazy<Fq>(load_const(kB3Sum), ccf::add<Fq>(a.c0, a.c1));
    return {ccf::sub<Fq>(v0, v1), ccf::sub<Fq>(ccf::sub<Fq>(s, v0), v1)};
  }
  static __device__ __forceinline__ E load(const uint32_t* p) { return {ccf::load(p), ccf::load(p + 8)}; }
  static __device__ __forceinline__ void store(uint32_t* p, const E& a) {
    ccf::store(p, a.c0);
    ccf::store(p + 8, a.c1);
  }
  static __device__ __forceinline__ bool is_zero(const E& a) { return ccf::is_zero(a.c0) && ccf::is_zero(a.c1); }
  static __device__ __forceinline__ E zero() { return {ccf::zero(), ccf::zero()}; }
  static __device__ __forceinline__ E one() { return {load_const(kFqOne), ccf::zero()}; }
  static __device__ __forceinline__ E sel(bool c, const E& a, const E& b) {
    return {select(c, a.c0, b.c0), select(c, a.c1, b.c1)};
  }
};

template <class G>
struct Point {
  typename G::E x, y, z;
};

template <class G>
__device__ __forceinline__ Point<G> load_point(const uint32_t* p) {
  return {G::load(p), G::load(p + G::kWords), G::load(p + 2 * G::kWords)};
}

template <class G>
__device__ __forceinline__ void store_point(uint32_t* p, const Point<G>& a) {
  G::store(p, a.x);
  G::store(p + G::kWords, a.y);
  G::store(p + 2 * G::kWords, a.z);
}

// RCB algorithm 7 (a = 0): P + Q for any projective P, Q.
template <class G>
__device__ __forceinline__ Point<G> proj_add(const Point<G>& p, const Point<G>& q) {
  using E = typename G::E;
  E t0 = G::mul(p.x, q.x);
  E t1 = G::mul(p.y, q.y);
  E t2 = G::mul(p.z, q.z);
  E t3 = G::mul(G::add(p.x, p.y), G::add(q.x, q.y));
  t3 = G::sub(t3, G::add(t0, t1));
  E t4 = G::mul(G::add(p.y, p.z), G::add(q.y, q.z));
  t4 = G::sub(t4, G::add(t1, t2));
  E y3 = G::mul(G::add(p.x, p.z), G::add(q.x, q.z));
  y3 = G::sub(y3, G::add(t0, t2));
  t0 = G::add(G::add(t0, t0), t0);
  t2 = G::mul_b3(t2);
  E z3 = G::add(t1, t2);
  t1 = G::sub(t1, t2);
  y3 = G::mul_b3(y3);
  Point<G> r;
  r.x = G::sub(G::mul(t3, t1), G::mul(t4, y3));
  r.y = G::add(G::mul(t1, z3), G::mul(y3, t0));
  r.z = G::add(G::mul(z3, t4), G::mul(t0, t3));
  return r;
}

// RCB algorithm 8: Q affine-encoded (Z = one, or Z = 0 for the identity).
template <class G>
__device__ __forceinline__ Point<G> proj_madd(const Point<G>& p, const Point<G>& q) {
  using E = typename G::E;
  E t0 = G::mul(p.x, q.x);
  E t1 = G::mul(p.y, q.y);
  E t3 = G::mul(G::add(q.x, q.y), G::add(p.x, p.y));
  t3 = G::sub(t3, G::add(t0, t1));
  E t4 = G::add(G::mul(q.y, p.z), p.y);
  E y3 = G::add(G::mul(q.x, p.z), p.x);
  t0 = G::add(G::add(t0, t0), t0);
  E t2 = G::mul_b3(p.z);
  E z3 = G::add(t1, t2);
  t1 = G::sub(t1, t2);
  y3 = G::mul_b3(y3);
  Point<G> r;
  r.x = G::sub(G::mul(t3, t1), G::mul(t4, y3));
  r.y = G::add(G::mul(t1, z3), G::mul(y3, t0));
  r.z = G::add(G::mul(z3, t4), G::mul(t0, t3));
  const bool q_inf = G::is_zero(q.z);
  return {G::sel(q_inf, p.x, r.x), G::sel(q_inf, p.y, r.y), G::sel(q_inf, p.z, r.z)};
}

template <class G, bool kMixed>
__device__ __forceinline__ Point<G> combine(const Point<G>& p, const Point<G>& q) {
  if constexpr (kMixed) {
    return proj_madd<G>(p, q);
  } else {
    return proj_add<G>(p, q);
  }
}

// ---- K6/K7: out[i] = p[i] + q[i] -----------------------------------------
// Replaces curve_pallas._add_blocked_lm (circom_compat_tpu/ops/curve_pallas.py:217),
// general and mixed. Bound: operations. A G1 add is 12 Fq muls (3168
// multiply-adds) against 288 B moved; G2 is 42 muls against 576 B. Design:
// one thread per point pair, the whole formula in registers; G2 spills at
// first (the ptxas report lists it).
template <class G, bool kMixed>
__global__ void point_add_kernel(const uint32_t* __restrict__ p, const uint32_t* __restrict__ q,
                                 uint32_t* __restrict__ out, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  constexpr int kStride = 3 * G::kWords;
  const Point<G> a = load_point<G>(p + kStride * i);
  const Point<G> b = load_point<G>(q + kStride * i);
  store_point<G>(out + kStride * i, combine<G, kMixed>(a, b));
}

// ---- K8: within-tile segmented inclusive point scan -----------------------
// Replaces curve_pallas._tile_scan_blocked (curve_pallas.py:334): for each
// tile t, acc = flags[t, k] ? v[t, k] : acc + v[t, k]; out[t, k] = acc;
// carry[t] = acc after step K-1. The mixed form treats v as affine-encoded
// (the bucket reduce's level 0). Bound: operations (one add per point
// moved). Design: one thread per tile, the K steps sequential in registers;
// the carry across tiles is the recursion in ops/segments.py.
template <class G, bool kMixed>
__global__ void point_tile_scan_kernel(const uint32_t* __restrict__ v, const uint8_t* __restrict__ flags,
                                       uint32_t* __restrict__ out, uint32_t* __restrict__ carry,
                                       long long T, int K) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= T) return;
  constexpr int kStride = 3 * G::kWords;
  Point<G> acc{G::zero(), G::one(), G::zero()};
  for (int k = 0; k < K; ++k) {
    const long long idx = t * K + k;
    const Point<G> x = load_point<G>(v + kStride * idx);
    acc = flags[idx] ? x : combine<G, kMixed>(acc, x);
    store_point<G>(out + kStride * idx, acc);
  }
  store_point<G>(carry + kStride * t, acc);
}

inline unsigned blocks_for(long long n, int threads) { return (unsigned)((n + threads - 1) / threads); }

template <class G, bool kMixed>
void launch_add(const void* p, const void* q, void* out, long long n, cudaStream_t s) {
  const int threads = 128;
  point_add_kernel<G, kMixed><<<blocks_for(n, threads), threads, 0, s>>>(
      (const uint32_t*)p, (const uint32_t*)q, (uint32_t*)out, n);
}

template <class G, bool kMixed>
void launch_scan(const void* v, const void* f, void* out, void* carry, long long T, int K, cudaStream_t s) {
  const int threads = 128;
  point_tile_scan_kernel<G, kMixed><<<blocks_for(T, threads), threads, 0, s>>>(
      (const uint32_t*)v, (const uint8_t*)f, (uint32_t*)out, (uint32_t*)carry, T, K);
}

}  // namespace

extern "C" {

int ccf_point_add(int g2, int mixed, const void* p, const void* q, void* out, long long n, void* stream) {
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (g2) {
      mixed ? launch_add<G2, true>(p, q, out, n, s) : launch_add<G2, false>(p, q, out, n, s);
    } else {
      mixed ? launch_add<G1, true>(p, q, out, n, s) : launch_add<G1, false>(p, q, out, n, s);
    }
  }
  return (int)cudaGetLastError();
}

int ccf_point_tile_scan(int g2, int mixed, const void* v, const void* flags, void* out, void* carry,
                        long long T, int K, void* stream) {
  if (T > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (g2) {
      mixed ? launch_scan<G2, true>(v, flags, out, carry, T, K, s)
            : launch_scan<G2, false>(v, flags, out, carry, T, K, s);
    } else {
      mixed ? launch_scan<G1, true>(v, flags, out, carry, T, K, s)
            : launch_scan<G1, false>(v, flags, out, carry, T, K, s);
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
