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

// ---- K6/K7: out[i] = p[i] + q[i] -----------------------------------------
// Replaces curve_pallas._add_blocked_lm (circom_compat_tpu/ops/curve_pallas.py:233),
// general and mixed: Phase C of every bucket scan and the setup's
// fixed-base fold. Bound: operations. A G1 add is 12 Fq muls (3168
// multiply-adds) against 288 B moved; G2 is 42 muls against 576 B. As in
// K8, the carry chains' latency holds it back, hidden only by resident
// warps and independent products. Design:
//  - Registers: G2 runs on a lane pair (G2Pair); __launch_bounds__ pins G2
//    at 128 registers with no spill, 16 resident warps per SM
//    (kAddBlocksG2 blocks of kAddThreads), and G1 at 96 with no spill, 20
//    warps (kAddBlocksG1): G1 gains from the warps and needs no more
//    registers; G2 with more registers and 8 warps is slower. 64-thread
//    blocks spread the 2^13 prove's launches (<= 16,384 G2 points) over
//    all SMs; the 2^20 prove's (up to 5,242,880) fill the card many times.
//    Two G1 points a thread, their products interleaved, spilled at 128
//    registers and was slower at 255 (PERF.md), so one point a thread.
//  - Memory: G2 (point_add_block) stages a block's P and Q rows through
//    shared memory with 16-byte cp.async by neighbouring threads, into
//    16-B-padded rows as in K8; the formulas re-read Q from its shared row
//    at each use, and the sum goes back through P's row as coalesced
//    16-byte stores. One stage per block: the bytes are small beside the
//    products. G1 measured slower staged (the barrier and the round trip,
//    PERF.md), so each G1 thread reads its P and Q where the formulas use
//    them (point_add_direct), neighbours' rows sharing cache lines.
// A madd whose Q is at infinity leaves P's row as it is: the plain
// version's select. Inactive threads of a ragged last block skip the work
// but reach every barrier, and both lanes of a pair share one point, so a
// pair is active or inactive together (its shuffles pair up).
// The four instantiations are entry kernels with C names
// (ccf_point_add_{g1,g2}_{add,madd}), which the ptxas report keys by.
constexpr int kAddThreads = 64;
constexpr int kAddBlocksG1 = 10;  // resident blocks per SM: 96 registers a thread
constexpr int kAddBlocksG2 = 8;   // 128 registers a thread

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

template <class G>
__host__ __device__ constexpr int add_points_per_block() {
  return kAddThreads / G::kLanes;
}

// G1: one point per thread, P and Q read where the formulas use them.
template <class G, bool kMixed>
__device__ __forceinline__ void point_add_direct(const uint32_t* __restrict__ p, const uint32_t* __restrict__ q,
                                                 uint32_t* __restrict__ out, long long n) {
  constexpr int kStride = 3 * G::kWords;
  const long long i = (long long)blockIdx.x * add_points_per_block<G>() + threadIdx.x / G::kLanes;
  if (i < n) {  // both lanes of a pair share i
    Point<G> a = load_point<G>(p + kStride * i);
    combine<G, kMixed>(a, q + kStride * i);
    store_point<G>(out + kStride * i, a);
  }
}

// G2: P and Q staged through shared rows, out drained from P's rows.
template <class G, bool kMixed>
__device__ __forceinline__ void point_add_block(const uint32_t* __restrict__ p, const uint32_t* __restrict__ q,
                                                uint32_t* __restrict__ out, long long n) {
  constexpr int W = G::kWords;
  constexpr int kStride = 3 * W;        // words per point
  constexpr int kRow = kStride + 4;     // shared-memory row: one 16-byte pad
  constexpr int kChunks = kStride / 4;  // 16-byte chunks per point
  constexpr int kPts = add_points_per_block<G>();
  __shared__ __align__(16) uint32_t sp[kPts * kRow];
  __shared__ __align__(16) uint32_t sq[kPts * kRow];

  const long long first = (long long)blockIdx.x * kPts;
  const int np = (int)min((long long)kPts, n - first);  // points of this block
  // the block's P and Q are contiguous runs: chunk c = (point i, part)
  for (int c = threadIdx.x; c < np * kChunks; c += kAddThreads) {
    const int i = c / kChunks, part = c % kChunks;
    const long long g = (first + i) * kStride + 4 * part;
    cp_async16(&sp[i * kRow + 4 * part], p + g);
    cp_async16(&sq[i * kRow + 4 * part], q + g);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int own = threadIdx.x / G::kLanes;  // this thread's point in the block
  if (own < np) {
    uint32_t* row = &sp[own * kRow];
    Point<G> a = load_point<G>(row);
    combine<G, kMixed>(a, &sq[own * kRow]);
    store_point<G>(row, a);  // each lane writes its own words only
  }
  __syncthreads();
  for (int c = threadIdx.x; c < np * kChunks; c += kAddThreads) {
    const int i = c / kChunks, part = c % kChunks;
    *reinterpret_cast<uint4*>(out + (first + i) * kStride + 4 * part) =
        *reinterpret_cast<const uint4*>(&sp[i * kRow + 4 * part]);
  }
}

inline unsigned blocks_for(long long n, int threads) { return (unsigned)((n + threads - 1) / threads); }

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

#define CCF_POINT_ADD_KERNEL(name, G, kMixed, kBlocks, body)                                            \
  __global__ void __launch_bounds__(kAddThreads, kBlocks)                                               \
      name(const uint32_t* __restrict__ p, const uint32_t* __restrict__ q, uint32_t* __restrict__ out, \
           long long n) {                                                                               \
    body<G, kMixed>(p, q, out, n);                                                                      \
  }
CCF_POINT_ADD_KERNEL(ccf_point_add_g1_add, G1, false, kAddBlocksG1, point_add_direct)
CCF_POINT_ADD_KERNEL(ccf_point_add_g1_madd, G1, true, kAddBlocksG1, point_add_direct)
CCF_POINT_ADD_KERNEL(ccf_point_add_g2_add, G2Pair, false, kAddBlocksG2, point_add_block)
CCF_POINT_ADD_KERNEL(ccf_point_add_g2_madd, G2Pair, true, kAddBlocksG2, point_add_block)
#undef CCF_POINT_ADD_KERNEL

int ccf_point_add(int g2, int mixed, const void* p, const void* q, void* out, long long n, void* stream) {
  if (n > 0) {
    const auto kernel = g2 ? (mixed ? ccf_point_add_g2_madd : ccf_point_add_g2_add)
                           : (mixed ? ccf_point_add_g1_madd : ccf_point_add_g1_add);
    const int per_block = g2 ? add_points_per_block<G2Pair>() : add_points_per_block<G1>();
    kernel<<<blocks_for(n, per_block), kAddThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)p, (const uint32_t*)q, (uint32_t*)out, n);
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
