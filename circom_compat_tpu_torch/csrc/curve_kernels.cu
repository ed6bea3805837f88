// G1/G2 point kernels: K6/K7 point_add, K8 point_tile_scan (the MSM) and
// K10 proof_fold (the proof's points from the MSMs' window sums).
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
#include <cstring>

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

// ---- K10: the proof's points from the window sums --------------------------
// Replaces no TPU kernel: the JAX package folds the window sums and applies
// the r/s algebra on the host (circom_compat_tpu/models/groth16_jax.py:537
// assemble_proof, ops/msm.py:571 _fold_windows_host), as the port did until
// this kernel; at 10^4 constraints that host work was three quarters of a
// prove on this card. From the window sums of the five MSMs it computes
//   A  = A_msm + alpha1 + r delta1
//   B1 = B1_msm + beta1 + s delta1
//   B2 = B2_msm + beta2 + s delta2
//   C  = L + H - rs delta1 + s A + r B1
// with X_msm = sum_w 2^(c w) S_w (Horner, most significant window first),
// in projective words: out = [A (24 words), B2 (48), C (24)].
// Bound: latency. The work is a few chains of ~250 doublings and ~70 adds
// each, every step waiting on the last; the bytes (W window sums in, 96
// words out) and the operations are small. One Fq multiply alone in a
// thread is a dependent chain of ~330 carried multiply-adds (0.56 us on an
// H100, K9 in one thread), and the longest chain here is 1,324 of them.
// Design:
//  - A team of lanes holds one point, the same words in every lane, and
//    computes each level of a formula's independent products at once, one
//    product a lane, then every lane reads them all back by shuffle and
//    forms the sums itself. G1 (team of 8): an add (RCB algorithm 7, 12M)
//    is two levels of six products, a doubling (RCB algorithm 9, 6M + 2S)
//    two levels of four. G2 (team of 32): a lane computes one term of a
//    Karatsuba Fq2 product, 3 lanes a product; an add is three levels (6
//    products, the two mul_b3, 6 products), a doubling three (4, 2, 3). A
//    step costs two or three multiplies' latency instead of 8 to 18.
//  - Teams: warp 0 the four G1 folds, warp 1 the ladders r, s, rs on
//    delta1, warp 2 the G2 fold, warp 3 the ladder s on delta2; then warp 0
//    adds A and B1 and runs the ladders s A and r B1, warp 1 adds
//    L + H - rs delta1 and warp 2 B2. The G1 and G2 warps meet at named
//    barriers of their own, so neither waits for the other.
//  - Complete formulas: identity window sums, equal operands and zero
//    scalars need no branch (ProveServer warms up with r = s = 0).
//  - Ladders by 4-bit windows, most significant first, over the digits of
//    the largest scalar of the step: a table of j P (j < 16, j = 0 the
//    identity) in the team's shared rows, then four doublings and one add a
//    digit. The scalars come by value in the kernel's parameters: rs
//    instead of -rs keeps every scalar as short as r and s, and C adds
//    -(rs delta1), a subtraction from zero.
// Each value is the same sequence of field operations as in ops/curve.py's
// proj_add / proj_double and ops/curve_kernels.py's proof_fold_plain, which
// runs the teams' points as a batch: kernel and plain version agree word
// for word.
constexpr int kFoldThreads = 128;  // four warps
constexpr int kLadderBits = 4;
constexpr int kLadderRows = 1 << kLadderBits;

__device__ __forceinline__ Fe fq_add(const Fe& a, const Fe& b) { return ccf::add<Fq>(a, b); }
__device__ __forceinline__ Fe fq_sub(const Fe& a, const Fe& b) { return ccf::sub<Fq>(a, b); }
__device__ __forceinline__ Fe fq_mul(const Fe& a, const Fe& b) { return mul_lazy<Fq>(a, b); }

struct F2 {
  Fe c0, c1;
};

__device__ __forceinline__ F2 f2_add(const F2& a, const F2& b) { return {fq_add(a.c0, b.c0), fq_add(a.c1, b.c1)}; }
__device__ __forceinline__ F2 f2_sub(const F2& a, const F2& b) { return {fq_sub(a.c0, b.c0), fq_sub(a.c1, b.c1)}; }

__device__ __forceinline__ Fe choose(bool c, const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.w[j] = c ? a.w[j] : b.w[j];
  return r;
}

__device__ __forceinline__ F2 choose(bool c, const F2& a, const F2& b) {
  return {choose(c, a.c0, b.c0), choose(c, a.c1, b.c1)};
}

// The k-th of v0, vs... (v0 for k past the end), by selects: no lane
// takes a branch of its own.
template <class T, class... Ts>
__device__ __forceinline__ T pick(int k, const T& v0, const Ts&... vs) {
  T r = v0;
  int i = 0;
  ((r = choose(k == ++i, vs, r)), ...);
  return r;
}

// The lanes of one team: kWidth aligned lanes of a warp.
template <int kWidth>
struct Team {
  int t;          // this lane's index in the team
  unsigned mask;  // the team's lanes
  __device__ __forceinline__ Team()
      : t(threadIdx.x % kWidth),
        mask((unsigned)((1ull << kWidth) - 1) << (threadIdx.x % 32 / kWidth * kWidth)) {}
  // lane src's v, in every lane of the team
  __device__ __forceinline__ Fe bcast(const Fe& v, int src) const {
    Fe r;
#pragma unroll
    for (int j = 0; j < 8; ++j) r.w[j] = __shfl_sync(mask, v.w[j], src, kWidth);
    return r;
  }
  __device__ __forceinline__ void sync() const { __syncwarp(mask); }
};

// G1 on a team of 8: mul_b3 is 9a = 8a + a.
struct G1Team {
  struct P {
    Fe x, y, z;
  };
  static constexpr int kWidth = 8, kWords = 24;
  using T = Team<kWidth>;
  static __device__ __forceinline__ Fe mul_b3(const Fe& a) {
    const Fe x2 = fq_add(a, a), x4 = fq_add(x2, x2);
    return fq_add(fq_add(x4, x4), a);
  }
  static __device__ __forceinline__ P load(const uint32_t* p) { return {ccf::load(p), ccf::load(p + 8), ccf::load(p + 16)}; }
  static __device__ __forceinline__ void store(uint32_t* p, const P& a) {
    ccf::store(p, a.x);
    ccf::store(p + 8, a.y);
    ccf::store(p + 16, a.z);
  }
  static __device__ __forceinline__ P identity() { return {ccf::zero(), load_const(kFqOne), ccf::zero()}; }
  static __device__ __forceinline__ P neg(const P& a) { return {a.x, fq_sub(ccf::zero(), a.y), a.z}; }

  // p += q (RCB algorithm 7); lanes 0-5 form the products
  static __device__ __forceinline__ void add(const T& tm, P& p, const uint32_t* q) {
    const Fe x2 = ccf::load(q), y2 = ccf::load(q + 8), z2 = ccf::load(q + 16);
    const Fe m = fq_mul(pick(tm.t, p.x, p.y, p.z, fq_add(p.x, p.y), fq_add(p.y, p.z), fq_add(p.x, p.z)),
                        pick(tm.t, x2, y2, z2, fq_add(x2, y2), fq_add(y2, z2), fq_add(x2, z2)));
    Fe t0 = tm.bcast(m, 0), t1 = tm.bcast(m, 1), t2 = tm.bcast(m, 2);
    const Fe t3 = fq_sub(tm.bcast(m, 3), fq_add(t0, t1));
    const Fe t4 = fq_sub(tm.bcast(m, 4), fq_add(t1, t2));
    Fe y3 = fq_sub(tm.bcast(m, 5), fq_add(t0, t2));
    t0 = fq_add(fq_add(t0, t0), t0);
    t2 = mul_b3(t2);
    const Fe z3 = fq_add(t1, t2);
    t1 = fq_sub(t1, t2);
    y3 = mul_b3(y3);
    // X3 = t3 t1 - t4 y3, Y3 = t1 z3 + y3 t0, Z3 = z3 t4 + t0 t3
    const Fe m2 = fq_mul(pick(tm.t, t3, t4, t1, y3, z3, t0), pick(tm.t, t1, y3, z3, t0, t4, t3));
    p.x = fq_sub(tm.bcast(m2, 0), tm.bcast(m2, 1));
    p.y = fq_add(tm.bcast(m2, 2), tm.bcast(m2, 3));
    p.z = fq_add(tm.bcast(m2, 4), tm.bcast(m2, 5));
  }

  // p = 2p (RCB algorithm 9); lanes 0-3 form the products
  static __device__ __forceinline__ void dbl(const T& tm, P& p) {
    const Fe m = fq_mul(pick(tm.t, p.y, p.y, p.z, p.x), pick(tm.t, p.y, p.z, p.z, p.y));
    const Fe t0 = tm.bcast(m, 0), t1 = tm.bcast(m, 1), xy = tm.bcast(m, 3);
    Fe z3 = fq_add(t0, t0);
    z3 = fq_add(z3, z3);
    z3 = fq_add(z3, z3);
    const Fe t2 = mul_b3(tm.bcast(m, 2));
    const Fe y3 = fq_add(t0, t2);
    const Fe u = fq_sub(t0, fq_add(fq_add(t2, t2), t2));
    // X3 = t2 z3, Z3 = t1 z3; Y = X3 + u y3, X = 2 u xy
    const Fe m2 = fq_mul(pick(tm.t, t2, t1, u, u), pick(tm.t, z3, z3, y3, xy));
    p.z = tm.bcast(m2, 1);
    p.y = fq_add(tm.bcast(m2, 0), tm.bcast(m2, 2));
    const Fe x = tm.bcast(m2, 3);
    p.x = fq_add(x, x);
  }
};

// G2 on a team of 32: Fq2 product k is formed by lanes 3k + j, j = 0, 1,
// 2 the Karatsuba terms a0 b0, a1 b1, (a0 + a1)(b0 + b1).
struct G2Team {
  struct P {
    F2 x, y, z;
  };
  static constexpr int kWidth = 32, kWords = 48;
  using T = Team<kWidth>;
  static __device__ __forceinline__ F2 load2(const uint32_t* p) { return {ccf::load(p), ccf::load(p + 8)}; }
  static __device__ __forceinline__ P load(const uint32_t* p) { return {load2(p), load2(p + 16), load2(p + 32)}; }
  static __device__ __forceinline__ void store(uint32_t* p, const P& a) {
    const F2* c[3] = {&a.x, &a.y, &a.z};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      ccf::store(p + 16 * i, c[i]->c0);
      ccf::store(p + 16 * i + 8, c[i]->c1);
    }
  }
  static __device__ __forceinline__ P identity() {
    return {{ccf::zero(), ccf::zero()}, {load_const(kFqOne), ccf::zero()}, {ccf::zero(), ccf::zero()}};
  }
  // this lane's Karatsuba operand of a
  static __device__ __forceinline__ Fe term(const T& tm, const F2& a) {
    const int j = tm.t % 3;
    return choose(j == 0, a.c0, choose(j == 1, a.c1, fq_add(a.c0, a.c1)));
  }
  // the term of 3b' = (kB3C0, kB3C1), with kB3Sum for the sum
  static __device__ __forceinline__ Fe b3_term(const T& tm) {
    const int j = tm.t % 3;
    return load_const(j == 0 ? kB3C0 : j == 1 ? kB3C1 : kB3Sum);
  }
  // Fq2 product k from its lanes' terms: (v0 - v1, (s - v0) - v1)
  static __device__ __forceinline__ F2 product(const T& tm, const Fe& m, int k) {
    const Fe v0 = tm.bcast(m, 3 * k), v1 = tm.bcast(m, 3 * k + 1), s = tm.bcast(m, 3 * k + 2);
    return {fq_sub(v0, v1), fq_sub(fq_sub(s, v0), v1)};
  }

  // p += q (RCB algorithm 7): products of lanes 0-17, 0-5, 0-17
  static __device__ __forceinline__ void add(const T& tm, P& p, const uint32_t* q) {
    const int k = tm.t / 3;
    const P b = load(q);
    const Fe m = fq_mul(
        term(tm, pick(k, p.x, p.y, p.z, f2_add(p.x, p.y), f2_add(p.y, p.z), f2_add(p.x, p.z))),
        term(tm, pick(k, b.x, b.y, b.z, f2_add(b.x, b.y), f2_add(b.y, b.z), f2_add(b.x, b.z))));
    F2 t0 = product(tm, m, 0), t1 = product(tm, m, 1), t2 = product(tm, m, 2);
    const F2 t3 = f2_sub(product(tm, m, 3), f2_add(t0, t1));
    const F2 t4 = f2_sub(product(tm, m, 4), f2_add(t1, t2));
    F2 y3 = f2_sub(product(tm, m, 5), f2_add(t0, t2));
    t0 = f2_add(f2_add(t0, t0), t0);
    const Fe mb = fq_mul(term(tm, choose(k == 0, t2, y3)), b3_term(tm));  // mul_b3 of t2, y3
    t2 = product(tm, mb, 0);
    y3 = product(tm, mb, 1);
    const F2 z3 = f2_add(t1, t2);
    t1 = f2_sub(t1, t2);
    const Fe m2 = fq_mul(term(tm, pick(k, t3, t4, t1, y3, z3, t0)), term(tm, pick(k, t1, y3, z3, t0, t4, t3)));
    p.x = f2_sub(product(tm, m2, 0), product(tm, m2, 1));
    p.y = f2_add(product(tm, m2, 2), product(tm, m2, 3));
    p.z = f2_add(product(tm, m2, 4), product(tm, m2, 5));
  }

  // p = 2p (RCB algorithm 9): products of lanes 0-11, 0-5, 0-8
  static __device__ __forceinline__ void dbl(const T& tm, P& p) {
    const int k = tm.t / 3;
    const Fe m = fq_mul(term(tm, pick(k, p.y, p.y, p.z, p.x)), term(tm, pick(k, p.y, p.z, p.z, p.y)));
    const F2 t0 = product(tm, m, 0), t1 = product(tm, m, 1), zz = product(tm, m, 2), xy = product(tm, m, 3);
    F2 z3 = f2_add(t0, t0);
    z3 = f2_add(z3, z3);
    z3 = f2_add(z3, z3);
    const Fe mb = fq_mul(term(tm, choose(k == 0, zz, t1)), choose(k == 0, b3_term(tm), term(tm, z3)));
    const F2 t2 = product(tm, mb, 0);  // mul_b3(zz)
    p.z = product(tm, mb, 1);          // t1 z3
    const F2 y3 = f2_add(t0, t2);
    const F2 u = f2_sub(t0, f2_add(f2_add(t2, t2), t2));
    const Fe m2 = fq_mul(term(tm, pick(k, t2, u, u)), term(tm, pick(k, z3, y3, xy)));
    p.y = f2_add(product(tm, m2, 0), product(tm, m2, 1));
    const F2 x = product(tm, m2, 2);
    p.x = f2_add(x, x);
  }
};

// sum_w 2^(c w) sums[w], in every lane of the team
template <class GT>
__device__ __noinline__ typename GT::P horner_fold(const uint32_t* sums, int W, int c) {
  const typename GT::T tm;
  typename GT::P acc = GT::load(sums + (W - 1) * GT::kWords);
  for (int w = W - 2; w >= 0; --w) {
    for (int i = 0; i < c; ++i) GT::dbl(tm, acc);
    GT::add(tm, acc, sums + w * GT::kWords);
  }
  return acc;
}

// 4-bit digits of the largest of n scalars
__device__ __forceinline__ int ladder_digits(const uint32_t (*k)[8], int n) {
  int nd = 0;
  for (int i = 0; i < n; ++i) {
    for (int w = 7; w >= 0; --w) {
      if (k[i][w]) {
        nd = max(nd, w * (32 / kLadderBits) + (32 - __clz(k[i][w]) + kLadderBits - 1) / kLadderBits);
        break;
      }
    }
  }
  return nd;
}

// k p over nd digits, in every lane of the team; table: kLadderRows rows of
// the team's own, row j = j p, built as 2 T[j/2] (j even) or
// T[(j+1)/2] + T[(j-1)/2]. Lane 0 of the team writes the rows.
template <class GT>
__device__ __noinline__ typename GT::P ladder(const typename GT::P& p, const uint32_t* k, int nd, uint32_t* table) {
  const typename GT::T tm;
  if (tm.t == 0) {
    GT::store(table, GT::identity());
    GT::store(table + GT::kWords, p);
  }
  tm.sync();
  for (int j = 2; j < kLadderRows; ++j) {
    typename GT::P r = GT::load(table + (j + 1) / 2 * GT::kWords);
    if (j & 1) {
      GT::add(tm, r, table + (j - 1) / 2 * GT::kWords);
    } else {
      GT::dbl(tm, r);
    }
    if (tm.t == 0) GT::store(table + j * GT::kWords, r);
    tm.sync();
  }
  auto digit = [&](int i) { return (k[i / 8] >> (kLadderBits * (i % 8))) & (kLadderRows - 1); };
  if (nd == 0) return GT::identity();
  typename GT::P acc = GT::load(table + digit(nd - 1) * GT::kWords);
  for (int i = nd - 2; i >= 0; --i) {
    for (int b = 0; b < kLadderBits; ++b) GT::dbl(tm, acc);
    GT::add(tm, acc, table + digit(i) * GT::kWords);
  }
  return acc;
}

// A barrier over `threads` threads of the block (whole warps); the
// non-.aligned form, which threads may reach from divergent paths.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("barrier.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// One block of kFoldThreads; sc: r, s, rs.
__device__ __forceinline__ void proof_fold_block(const uint32_t* __restrict__ g1_sums,
                                                 const uint32_t* __restrict__ g2_sums,
                                                 const uint32_t* __restrict__ g1_fixed,
                                                 const uint32_t* __restrict__ g2_fixed, const uint32_t (&sc)[3][8],
                                                 int W, int c, uint32_t* __restrict__ out) {
  constexpr int P1 = G1Team::kWords, P2 = G2Team::kWords;  // words a point
  __shared__ __align__(16) uint32_t tab1[3][kLadderRows * P1];  // the G1 ladders' tables
  __shared__ __align__(16) uint32_t tab2[kLadderRows * P2];
  __shared__ __align__(16) uint32_t fold1[4][P1];  // A_msm, B1_msm, L, H
  __shared__ __align__(16) uint32_t lad1[3][P1];   // r delta1, s delta1, rs delta1
  __shared__ __align__(16) uint32_t ab[2][P1];     // A, B1
  __shared__ __align__(16) uint32_t part[3][P1];   // s A, r B1, L + H - rs delta1
  __shared__ __align__(16) uint32_t fold2[P2], lad2[P2];  // B2_msm, s delta2
  __shared__ uint32_t ks[3][8];
  const int warp = threadIdx.x / 32, team = threadIdx.x % 32 / G1Team::kWidth;
  const bool lead1 = threadIdx.x % G1Team::kWidth == 0, lead2 = threadIdx.x % 32 == 0;
  if (threadIdx.x < 24) ks[threadIdx.x / 8][threadIdx.x % 8] = sc[threadIdx.x / 8][threadIdx.x % 8];
  __syncthreads();

  if (warp < 2) {  // G1: barrier 1 over warps 0-1
    if (warp == 0) {
      const G1Team::P f = horner_fold<G1Team>(g1_sums + team * W * P1, W, c);
      if (lead1) G1Team::store(fold1[team], f);
    } else if (team < 3) {
      const G1Team::P l = ladder<G1Team>(G1Team::load(g1_fixed + 2 * P1), ks[team], ladder_digits(ks, 3), tab1[team]);
      if (lead1) G1Team::store(lad1[team], l);
    }
    named_barrier(1, 64);
    const G1Team::T tm;
    if (warp == 0 && team < 2) {  // A (team 0), B1 (team 1); then s A, r B1
      G1Team::P p = G1Team::load(fold1[team]);
      G1Team::add(tm, p, g1_fixed + team * P1);
      G1Team::add(tm, p, lad1[team]);
      if (lead1) G1Team::store(ab[team], p);
      const G1Team::P l = ladder<G1Team>(p, ks[1 - team], ladder_digits(ks, 2), tab1[team]);
      if (lead1) G1Team::store(part[team], l);
    } else if (warp == 1 && team == 0) {
      G1Team::P p = G1Team::load(fold1[2]);
      G1Team::add(tm, p, fold1[3]);
      if (lead1) G1Team::store(part[2], G1Team::neg(G1Team::load(lad1[2])));
      tm.sync();
      G1Team::add(tm, p, part[2]);
      tm.sync();
      if (lead1) G1Team::store(part[2], p);
    }
    named_barrier(1, 64);
    if (warp == 0 && team == 0) {
      G1Team::P p = G1Team::load(part[2]);
      G1Team::add(tm, p, part[0]);
      G1Team::add(tm, p, part[1]);
      if (lead1) {
        G1Team::store(out + P1 + P2, p);
        G1Team::store(out, G1Team::load(ab[0]));
      }
    }
  } else {  // G2: barrier 2 over warps 2-3
    if (warp == 2) {
      const G2Team::P f = horner_fold<G2Team>(g2_sums, W, c);
      if (lead2) G2Team::store(fold2, f);
    } else {
      const G2Team::P l = ladder<G2Team>(G2Team::load(g2_fixed + P2), ks[1], ladder_digits(ks + 1, 1), tab2);
      if (lead2) G2Team::store(lad2, l);
    }
    named_barrier(2, 64);
    if (warp == 2) {
      const G2Team::T tm;
      G2Team::P p = G2Team::load(fold2);
      G2Team::add(tm, p, g2_fixed);
      G2Team::add(tm, p, lad2);
      if (lead2) G2Team::store(out + P1, p);
    }
  }
}

}  // namespace

// K10's scalars, passed by value in the kernel's parameters
struct CcfProofScalars {
  uint32_t k[3][8];  // r, s, rs mod the group order, canonical words
};

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

// The entry kernel has a C name, which the ptxas report keys by.
__global__ void __launch_bounds__(kFoldThreads, 1)
    ccf_proof_fold_kernel(const uint32_t* __restrict__ g1_sums, const uint32_t* __restrict__ g2_sums,
                          const uint32_t* __restrict__ g1_fixed, const uint32_t* __restrict__ g2_fixed,
                          const CcfProofScalars sc, int W, int c, uint32_t* __restrict__ out) {
  proof_fold_block(g1_sums, g2_sums, g1_fixed, g2_fixed, sc.k, W, c, out);
}

// r, s, rs: 24 canonical words on the host, passed by value as the kernel's
// parameter; g1_sums (4, W, 3, 8) [A, B1, L, H], g2_sums (W, 3, 2, 8),
// g1_fixed (3, 3, 8) [alpha1, beta1, delta1], g2_fixed (2, 3, 2, 8)
// [beta2, delta2]; out 96 words.
int ccf_proof_fold(const void* g1_sums, const void* g2_sums, const void* g1_fixed, const void* g2_fixed,
                   const void* scalars, int W, int c, void* out, void* stream) {
  CcfProofScalars sc;
  memcpy(&sc, scalars, sizeof(sc));
  ccf_proof_fold_kernel<<<1, kFoldThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)g1_sums, (const uint32_t*)g2_sums, (const uint32_t*)g1_fixed, (const uint32_t*)g2_fixed,
      sc, W, c, (uint32_t*)out);
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
