// G1/G2 point kernels of the MSM: K6/K7 point_add, K8 point_tile_scan.
//
// Points are homogeneous projective (X, Y, Z), identity (0, 1, 0), lazy
// Montgomery words: G1 24 words (X, Y, Z), G2 48 words (X.c0, X.c1, Y.c0,
// ...). The group law is the complete Renes-Costello-Batina formula (a = 0):
// add 12M + 2 mul_b3, mixed add 11M + 2 mul_b3 with Q at infinity left
// out, in the operation order of ops/curve.py (the plain versions), so
// kernel and plain version agree word for word.
//
// Plain C entry points (ctypes); each launches on the caller's stream and
// returns cudaGetLastError().
#include "field.cuh"

using namespace ccf;

namespace {

struct G1 {
  using E = Fe;
  static constexpr int kWords = 8;  // words per coordinate
  static constexpr int kLanes = 1;  // threads per point
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
  static __device__ __forceinline__ E load_again(const uint32_t* p) { return ccf::load_again(p); }
  static __device__ __forceinline__ void store(uint32_t* p, const E& a) { ccf::store(p, a); }
  static __device__ __forceinline__ bool is_zero(const E& a) { return ccf::is_zero(a); }
  static __device__ __forceinline__ E zero() { return ccf::zero(); }
  static __device__ __forceinline__ E one() { return load_const(kFqOne); }
};

struct G2 {
  using E = Fe2;
  static constexpr int kWords = 16;
  static constexpr int kLanes = 1;
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
  static __device__ __forceinline__ E load_again(const uint32_t* p) {
    return {ccf::load_again(p), ccf::load_again(p + 8)};
  }
  static __device__ __forceinline__ void store(uint32_t* p, const E& a) {
    ccf::store(p, a.c0);
    ccf::store(p + 8, a.c1);
  }
  static __device__ __forceinline__ bool is_zero(const E& a) { return ccf::is_zero(a.c0) && ccf::is_zero(a.c1); }
  static __device__ __forceinline__ E zero() { return {ccf::zero(), ccf::zero()}; }
  static __device__ __forceinline__ E one() { return {load_const(kFqOne), ccf::zero()}; }
};

// G2 with each point split over a lane pair: lane l = threadIdx.x & 1 holds
// coefficient c_l of every Fq2 coordinate. Adds and subtracts act on the
// own coefficient. A product exchanges the operands' other coefficients
// with the partner lane (__shfl_xor_sync) and forms the Karatsuba terms in
// ops/curve.py's order: lane l computes v_l = a_l b_l and
// s = (a0 + a1)(b0 + b1), then c0 = v0 - v1 and c1 = (s - v0) - v1. Both
// lanes of a pair always take the same branches (flags, Q at infinity).
struct G2Pair {
  using E = Fe;
  static constexpr int kWords = 16;
  static constexpr int kLanes = 2;
  static __device__ __forceinline__ int lane() { return threadIdx.x & 1; }
  static __device__ __forceinline__ unsigned pair_mask() { return 3u << (threadIdx.x & 30); }
  static __device__ __forceinline__ Fe partner(const Fe& a) {
    Fe r;
#pragma unroll
    for (int j = 0; j < 8; ++j) r.w[j] = __shfl_xor_sync(pair_mask(), a.w[j], 1);
    return r;
  }
  // (v0 - v1, (s - v0) - v1) from the own v_l and s
  static __device__ __forceinline__ E karatsuba(const Fe& v, const Fe& s) {
    const Fe vo = partner(v);
    return ccf::sub<Fq>(lane() ? ccf::sub<Fq>(s, vo) : v, lane() ? v : vo);
  }
  static __device__ __forceinline__ E add(const E& a, const E& b) { return ccf::add<Fq>(a, b); }
  static __device__ __forceinline__ E sub(const E& a, const E& b) { return ccf::sub<Fq>(a, b); }
  static __device__ __forceinline__ E mul(const E& a, const E& b) {
    const Fe s = mul_lazy<Fq>(ccf::add<Fq>(a, partner(a)), ccf::add<Fq>(b, partner(b)));
    return karatsuba(mul_lazy<Fq>(a, b), s);
  }
  static __device__ __forceinline__ E mul_b3(const E& a) {
    const Fe s = mul_lazy<Fq>(load_const(kB3Sum), ccf::add<Fq>(a, partner(a)));
    return karatsuba(mul_lazy<Fq>(load_const(lane() ? kB3C1 : kB3C0), a), s);
  }
  static __device__ __forceinline__ E load(const uint32_t* p) { return ccf::load(p + 8 * lane()); }
  static __device__ __forceinline__ E load_again(const uint32_t* p) { return ccf::load_again(p + 8 * lane()); }
  static __device__ __forceinline__ void store(uint32_t* p, const E& a) { ccf::store(p + 8 * lane(), a); }
  static __device__ __forceinline__ bool is_zero(const E& a) {
    const int z = ccf::is_zero(a);
    const int z_partner = __shfl_xor_sync(pair_mask(), z, 1);  // both lanes shuffle
    return z && z_partner;
  }
  static __device__ __forceinline__ E zero() { return ccf::zero(); }
  static __device__ __forceinline__ E one() { return lane() ? ccf::zero() : load_const(kFqOne); }
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

// The formulas update P in place and read each coordinate of Q from memory
// (global or shared) again at each use, so Q takes no registers; sums of
// P's coordinates come first, so that each coordinate of P dies at its
// last product, and at most six temporaries (plus one product) are live at
// a time. Reordering independent operations leaves the words unchanged:
// each value is the same sequence of field operations as in ops/curve.py.

// RCB algorithm 7 (a = 0): P + Q for any projective P, Q.
template <class G>
__device__ __forceinline__ void proj_add(Point<G>& p, const uint32_t* q) {
  using E = typename G::E;
  constexpr int W = G::kWords;
  const uint32_t *qx = q, *qy = q + W, *qz = q + 2 * W;
  const E sxy = G::add(p.x, p.y), syz = G::add(p.y, p.z), sxz = G::add(p.x, p.z);
  E t0 = G::mul(p.x, G::load_again(qx));
  E t1 = G::mul(p.y, G::load_again(qy));
  E t2 = G::mul(p.z, G::load_again(qz));
  const E t3 = G::sub(G::mul(sxy, G::add(G::load_again(qx), G::load_again(qy))), G::add(t0, t1));
  const E t4 = G::sub(G::mul(syz, G::add(G::load_again(qy), G::load_again(qz))), G::add(t1, t2));
  E y3 = G::sub(G::mul(sxz, G::add(G::load_again(qx), G::load_again(qz))), G::add(t0, t2));
  t0 = G::add(G::add(t0, t0), t0);
  t2 = G::mul_b3(t2);
  const E z3 = G::add(t1, t2);
  t1 = G::sub(t1, t2);
  y3 = G::mul_b3(y3);
  // X3 = t3 t1 - t4 y3, Y3 = t1 z3 + y3 t0, Z3 = z3 t4 + t0 t3
  p.x = G::sub(G::mul(t3, t1), G::mul(t4, y3));
  p.y = G::add(G::mul(t1, z3), G::mul(y3, t0));
  p.z = G::add(G::mul(z3, t4), G::mul(t0, t3));
}

// RCB algorithm 8: Q affine-encoded (Z = one, or Z = 0 for the identity).
// Q at infinity leaves P as it is: the plain version's select.
template <class G>
__device__ __forceinline__ void proj_madd(Point<G>& p, const uint32_t* q) {
  using E = typename G::E;
  constexpr int W = G::kWords;
  const uint32_t *qx = q, *qy = q + W;
  if (G::is_zero(G::load(q + 2 * W))) return;
  const E sxy = G::add(p.x, p.y);
  E t0 = G::mul(p.x, G::load_again(qx));
  E y3 = G::add(G::mul(G::load_again(qx), p.z), p.x);
  E t1 = G::mul(p.y, G::load_again(qy));
  const E t4 = G::add(G::mul(G::load_again(qy), p.z), p.y);
  const E t3 = G::sub(G::mul(G::add(G::load_again(qx), G::load_again(qy)), sxy), G::add(t0, t1));
  t0 = G::add(G::add(t0, t0), t0);
  const E t2 = G::mul_b3(p.z);
  const E z3 = G::add(t1, t2);
  t1 = G::sub(t1, t2);
  y3 = G::mul_b3(y3);
  p.x = G::sub(G::mul(t3, t1), G::mul(t4, y3));
  p.y = G::add(G::mul(t1, z3), G::mul(y3, t0));
  p.z = G::add(G::mul(z3, t4), G::mul(t0, t3));
}

template <class G, bool kMixed>
__device__ __forceinline__ void combine(Point<G>& p, const uint32_t* q) {
  if constexpr (kMixed) {
    proj_madd<G>(p, q);
  } else {
    proj_add<G>(p, q);
  }
}

// ---- K6/K7: out[i] = p[i] + q[i] -----------------------------------------
// Replaces curve_pallas._add_blocked_lm (circom_compat_tpu/ops/curve_pallas.py:217),
// general and mixed. Bound: operations. A G1 add is 12 Fq muls (3168
// multiply-adds) against 288 B moved; G2 is 42 muls against 576 B. Design:
// one thread per point pair, P in registers, Q read where the formula uses it.
template <class G, bool kMixed>
__global__ void point_add_kernel(const uint32_t* __restrict__ p, const uint32_t* __restrict__ q,
                                 uint32_t* __restrict__ out, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  constexpr int kStride = 3 * G::kWords;
  Point<G> a = load_point<G>(p + kStride * i);
  combine<G, kMixed>(a, q + kStride * i);
  store_point<G>(out + kStride * i, a);
}

// ---- K8: within-tile segmented inclusive point scan -----------------------
// Replaces curve_pallas._tile_scan_blocked (curve_pallas.py:334): for each
// tile t, acc = flags[t, k] ? v[t, k] : acc + v[t, k]; out[t, k] = acc;
// carry[t] = acc after step K-1. The mixed form treats v as affine-encoded
// (the bucket reduce's level 0). The carry across tiles is the recursion in
// ops/segments.py. Any K works; the path uses K = 16 (segments.TILE).
//
// Bound: operations, one add per unflagged position (a G2 madd is 39 Fq
// muls, 10,296 multiply-adds, against 384 B moved). What holds it back on
// this card is the latency of the dependent carry chains (ptxas turns each
// carried multiply-add into an IMAD plus an IADD3.X), which only resident
// warps and independent products hide, and so the registers per thread.
// Design:
//  - Registers: one thread walks a G1 tile's K steps; a G2 tile is split
//    over a lane pair (G2Pair), which halves the registers per thread at
//    the cost of one redundant product per Karatsuba. Together with the
//    formulas' short live ranges, __launch_bounds__ pins the budget at 128
//    registers with no spill for all four instantiations: 16 resident
//    warps per SM (kScanBlocks blocks of kScanThreads). PERF.md compares
//    other budgets and one thread per G2 tile.
//  - Memory: a block's tiles are staged one step at a time through shared
//    memory, double-buffered with cp.async: step k + 1 is in flight while
//    step k computes. Each step's points are 96 B (G1) or 192 B (G2) runs,
//    copied in 16-byte chunks by neighbouring threads; out[., k] goes back
//    through the same buffer as coalesced stores. Rows are padded by 16 B,
//    so a quarter warp's 16-byte reads of 8 rows hit 8 distinct bank groups.
// The four instantiations are entry kernels with C names
// (ccf_tile_scan_{g1,g2}_{madd,add}), which the ptxas report keys by.
constexpr int kScanThreads = 64;
constexpr int kScanBlocks = 8;  // resident blocks per SM: 128 registers a thread

__device__ __forceinline__ void cp_async16(uint32_t* smem, const uint32_t* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

template <class G, bool kMixed>
__device__ __forceinline__ void point_tile_scan(const uint32_t* __restrict__ v, const uint8_t* __restrict__ flags,
                                                uint32_t* __restrict__ out, uint32_t* __restrict__ carry,
                                                long long T, int K) {
  constexpr int kStride = 3 * G::kWords;  // words per point
  constexpr int kRow = kStride + 4;       // shared-memory row: one 16-byte pad
  constexpr int kChunks = kStride / 4;    // 16-byte chunks per point
  constexpr int kTiles = kScanThreads / G::kLanes;  // tiles per block
  __shared__ __align__(16) uint32_t buf[2][kTiles * kRow];

  const long long tile0 = (long long)blockIdx.x * kTiles;
  const int nt = (int)min((long long)kTiles, T - tile0);  // tiles of this block
  const int own = threadIdx.x / G::kLanes;                // this thread's tile in the block
  const long long t = tile0 + own;
  const bool active = own < nt;

  // step k of every tile of the block <-> buf[slot], chunk c = (tile i, part)
  auto stage = [&](int k, int slot) {
    if (k < K) {
      for (int c = threadIdx.x; c < nt * kChunks; c += kScanThreads) {
        const int i = c / kChunks, part = c % kChunks;
        cp_async16(&buf[slot][i * kRow + 4 * part], v + ((tile0 + i) * K + k) * kStride + 4 * part);
      }
    }
    cp_async_commit();  // one group per step, empty past the end
  };
  auto drain = [&](int k, int slot) {
    for (int c = threadIdx.x; c < nt * kChunks; c += kScanThreads) {
      const int i = c / kChunks, part = c % kChunks;
      *reinterpret_cast<uint4*>(out + ((tile0 + i) * K + k) * kStride + 4 * part) =
          *reinterpret_cast<const uint4*>(&buf[slot][i * kRow + 4 * part]);
    }
  };

  Point<G> acc{G::zero(), G::one(), G::zero()};
  stage(0, 0);
  stage(1, 1);
  for (int k = 0; k < K; ++k) {
    const int slot = k & 1;
    cp_async_wait_one();  // step k has landed (step k + 1 may still be in flight)
    __syncthreads();
    if (active) {
      uint32_t* row = &buf[slot][own * kRow];
      if (flags[t * K + k]) {
        acc = load_point<G>(row);  // a segment starts: the row already holds acc
      } else {
        combine<G, kMixed>(acc, row);  // each lane reads and writes its own words only
        store_point<G>(row, acc);
      }
    }
    __syncthreads();
    drain(k, slot);
    __syncthreads();  // every read of this slot is done before it refills
    stage(k + 2, slot);
  }
  if (active) store_point<G>(carry + kStride * t, acc);
}

inline unsigned blocks_for(long long n, int threads) { return (unsigned)((n + threads - 1) / threads); }

template <class G, bool kMixed>
void launch_add(const void* p, const void* q, void* out, long long n, cudaStream_t s) {
  const int threads = 128;
  point_add_kernel<G, kMixed><<<blocks_for(n, threads), threads, 0, s>>>(
      (const uint32_t*)p, (const uint32_t*)q, (uint32_t*)out, n);
}

}  // namespace

extern "C" {

#define CCF_TILE_SCAN_KERNEL(name, G, kMixed)                                                             \
  __global__ void __launch_bounds__(kScanThreads, kScanBlocks)                                            \
      name(const uint32_t* __restrict__ v, const uint8_t* __restrict__ flags, uint32_t* __restrict__ out, \
           uint32_t* __restrict__ carry, long long T, int K) {                                            \
    point_tile_scan<G, kMixed>(v, flags, out, carry, T, K);                                               \
  }
CCF_TILE_SCAN_KERNEL(ccf_tile_scan_g1_madd, G1, true)
CCF_TILE_SCAN_KERNEL(ccf_tile_scan_g1_add, G1, false)
CCF_TILE_SCAN_KERNEL(ccf_tile_scan_g2_madd, G2Pair, true)
CCF_TILE_SCAN_KERNEL(ccf_tile_scan_g2_add, G2Pair, false)
#undef CCF_TILE_SCAN_KERNEL

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
    const auto kernel = g2 ? (mixed ? ccf_tile_scan_g2_madd : ccf_tile_scan_g2_add)
                           : (mixed ? ccf_tile_scan_g1_madd : ccf_tile_scan_g1_add);
    const int lanes = g2 ? G2Pair::kLanes : G1::kLanes;
    kernel<<<blocks_for(T, kScanThreads / lanes), kScanThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)v, (const uint8_t*)flags, (uint32_t*)out, (uint32_t*)carry, T, K);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
