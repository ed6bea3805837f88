// Field kernels: K1 fr_binary (Fr and Fq), K2 fr_tile_scan, K3/K4 ntt_rows,
// K5a/K5b fr_butterfly_stages, K9 fq_op_chain.
//
// Plain C entry points (ctypes, no torch headers). Each launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().
// Plain PyTorch versions: ops/field_kernels.py, ops/field_bench.py (K9).
#include "field.cuh"

using namespace ccf;

namespace {

// ---- K1: elementwise Fr or Fq op ------------------------------------------
// Replaces field_pallas._bin_blocked (circom_compat_tpu/ops/field_pallas.py:79),
// and in its Fq instance the XLA field ops of the JAX package's setup
// (batch inversion, projective -> affine, on-curve check).
// Bound: bytes. A mul moves 96 B per element (two reads, one write) against
// 264 multiply-adds; at 3.35 TB/s and ~16.7 T int32 mad/s the memory side is
// the larger term. Design: one thread per element, 16-byte vector loads of
// neighbouring rows, nothing kept between elements.
template <class F>
__global__ void binary_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                              uint32_t* __restrict__ o, long long n, int op, int b_bcast) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fe x = load(a + 8 * i);
  const Fe y = load(b + (b_bcast ? 0 : 8 * i));
  Fe r;
  switch (op) {
    case 0: r = mul_lazy<F>(x, y); break;
    case 1: r = mul<F>(x, y); break;
    case 2: r = add<F>(x, y); break;
    default: r = sub<F>(x, y); break;
  }
  store(o + 8 * i, r);
}

// ---- K9: a K-step dependent chain of one Fq op per element -----------------
// Replaces scripts/bench_field_ops.py run_op (:76, the pallas_call at :79):
// acc = op(acc, b) K times, acc starting at a. Ops (bench_field_ops.py:45-65):
// 0 mont_mul, 1 mont_mul_lazy, 2 add (mod p), 3 add_lazy, 4 sub_lazy,
// 5 mul9 (8 acc + b by three doublings and one add, all lazy). Its
// "normalize" op is a carry pass of 16-bit limbs in 32-bit lanes: 32-bit
// words carry inside the multiply-add chain, so it has no counterpart.
//
// Bound: operations, K dependent ops per element in registers against
// 96 B of traffic. The kernel times the field core that every other kernel
// runs, so it calls field.cuh's mul, mul_lazy, add_canon, add and sub.
//
// Design. The card sees n independent chains of K steps, each a run of
// carry chains: an add step is ~25 SASS instructions (the add chain, the
// conditional subtraction one word behind it, the select), a multiply
// ~575 (136 IMAD, 128 IMAD.HI, ~250 IADD3.X). Every op is bound by issue
// slots (an add step by its carry adds on the ALU pipe), not by latency
// (PERF.md): two chains a thread and a lane pair an element were measured
// and lost. So one element a thread, and:
//  - K = kChainSteps (the JAX default, 64) is a template argument: add,
//    add_lazy and sub_lazy run straight-line; mul9 (~96 instructions a
//    step) in turns of kChainMul9Unroll steps, the multiplies in turns of
//    kChainMulUnroll (64 unrolled mul9 steps, 99 KB of code, ran 25 %
//    slower); any other k takes a runtime loop in turns of
//    kChainRuntimeUnroll with a remainder.
//  - Blocks of kChainThreads = 256 while the card holds the whole grid at
//    once (n = 2^16: every SM holds at most 16 warps whatever the block,
//    2048 warps on 132 SMs, and 256 measured 1-2 % under 128 and 64);
//    past that, blocks of kChainWaveThreads = 128: the last of several
//    waves leaves some SMs a block above the mean, and a smaller block
//    halves that excess (1-3 % faster at n = 2^20).
constexpr int kChainThreads = 256;      // threads a block while the grid fits at once
constexpr int kChainWaveThreads = 128;  // threads a block past that
constexpr int kChainSteps = 64;         // the step count compiled in: the JAX script's K
constexpr int kChainMulUnroll = 2;      // multiply steps a loop turn at K = kChainSteps
constexpr int kChainMul9Unroll = 8;     // mul9 steps a loop turn at K = kChainSteps
constexpr int kChainAddUnroll = 64;     // add, add_lazy, sub_lazy steps a loop turn there
constexpr int kChainRuntimeUnroll = 8;  // steps a loop turn for any other k

template <int OP>
__device__ __forceinline__ Fe chain_step(const Fe& acc, const Fe& y) {
  if constexpr (OP == 0) {
    return mul<Fq>(acc, y);
  } else if constexpr (OP == 1) {
    return mul_lazy<Fq>(acc, y);
  } else if constexpr (OP == 2) {
    return add_canon<Fq>(acc, y);
  } else if constexpr (OP == 3) {
    return add<Fq>(acc, y);
  } else if constexpr (OP == 4) {
    return sub<Fq>(acc, y);
  } else {
    const Fe x2 = add<Fq>(acc, acc);
    const Fe x4 = add<Fq>(x2, x2);
    return add<Fq>(add<Fq>(x4, x4), y);
  }
}

// acc = op(acc, y) K times (k times when K = 0)
template <int OP, int K>
__global__ void __launch_bounds__(kChainThreads)
    fq_op_chain_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                       uint32_t* __restrict__ o, long long n, int k) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe acc = load(a + 8 * i);
  const Fe y = load(b + 8 * i);
  if constexpr (K > 0) {
    constexpr int kUnroll = OP <= 1 ? kChainMulUnroll : OP == 5 ? kChainMul9Unroll : kChainAddUnroll;
#pragma unroll (kUnroll)
    for (int s = 0; s < K; ++s) acc = chain_step<OP>(acc, y);
  } else {
#pragma unroll (kChainRuntimeUnroll)
    for (int s = 0; s < k; ++s) acc = chain_step<OP>(acc, y);
  }
  store(o + 8 * i, acc);
}

typedef void (*ChainKernel)(const uint32_t*, const uint32_t*, uint32_t*, long long, int);
#define CCF_CHAIN(OP) {fq_op_chain_kernel<OP, 0>, fq_op_chain_kernel<OP, kChainSteps>}
// [op][k == kChainSteps]
const ChainKernel kChainKernels[6][2] = {CCF_CHAIN(0), CCF_CHAIN(1), CCF_CHAIN(2),
                                         CCF_CHAIN(3), CCF_CHAIN(4), CCF_CHAIN(5)};
#undef CCF_CHAIN

// ---- K3/K4: all radix-2 stages of one row, one butterfly pair a thread -----
// Replaces field_pallas.ntt_low_stages_lm (circom_compat_tpu/ops/
// field_pallas.py:387, low mode) and ntt_mid_stages_lm (:432, mid mode),
// both driving _stage_loop (:306). Order: optional pre-multiply, DIF stages
// (descending, tw_dif), optional mid multiply, DIT stages (ascending,
// tw_dit), optional post multiply (post_op 0) or post - x (post_op 1).
//
// Bound: operations. A row of L = 2^n does (L/2) n butterflies, but the
// L - 1 of them whose twiddle index is 0 multiply by one: the kernel (and
// its plain version) skips those, leaving (L/2) n - (L - 1) Montgomery
// multiplies (264 multiply-adds each) per stage sweep, plus L per pointwise
// pre, mid or post multiply, against 32 B per element read or written. At
// 2^20 (1024 rows of 1024): DIF + pre + post 0.0993 ms, DIT + pre +
// post-sub 0.0828 ms, mid 0.1490 ms at 16.7 T multiply-adds/s.
//
// Design. A Montgomery multiply is one long carry chain (~600 SASS
// instructions), so the card needs many warps in flight: a thread holds one
// butterfly pair (two elements) in at most 64 registers, 1024 threads an
// SM (32 warps; at L = 1024 two blocks of 512 threads, one row each).
//  - Layouts. At stage st a warp holds the elements whose index agrees
//    outside W + 1 = 6 consecutive bits [a, a + 5] (its lanes and the pair
//    bit st). Stage st takes a = min(st, n - 6): the top stages share one
//    layout and move between stages by __shfl_xor_sync (no barrier); every
//    stage below takes a = st, so the bits under its pair bit are the
//    warp's own, uniform over its lanes.
//  - No multiply by one. pos, the butterfly's twiddle index, is i mod
//    2^st; where the bits under st are warp bits (every stage with a = st)
//    pos == 0 and the skip are warp-uniform and the twiddle is one
//    broadcast load; in the top layout the few pos == 0 lanes idle.
//  - A layout change (a stage with a = st) passes the pairs through shared
//    memory, double-buffered so one barrier does: 4 barriers a direction at
//    L = 1024 (and 3 at 512), against one a stage.
//  - Shared memory without bank conflicts: an element's two 16-byte halves
//    lie in two planes; chunk c sits at c ^ fold(c), fold XOR-ing the
//    index's 3-bit groups above bit 2, so bit b lands on position b mod 3:
//    where a = st a quarter-warp's lanes vary in three consecutive bits.
//  - Twiddles through L1 from the row's root table (16 KB at L = 1024).
//  - One entry kernel a row length, ccf_ntt_rows_log<n> (n = 0..12), so the
//    stage loops unroll and ptxas reports each by name. A row of 256 to
//    1024 has a block of L / 2 threads (the flat chain's 16 rows of 512 run
//    16 blocks); shorter rows share a 128-thread block; rows of 2048 and
//    4096 give a thread 2 and 4 pairs (one block an SM, 128 registers).
constexpr int kNttMinThreads = 128;  // rows shorter than 256 share a block
constexpr int kNttMaxThreads = 512;  // rows longer than 1024 give a thread several pairs
constexpr int kNttSmThreads = 1024;  // threads an SM for one pair a thread: 65536 / 1024 = 64 registers

template <int LOG_L>
struct NttShape {
  static constexpr int L = 1 << LOG_L;
  static constexpr int P = LOG_L > 0 ? LOG_L - 1 : 0;  // pair-index bits of a row
  static constexpr int W = P < 5 ? P : 5;              // lane bits inside a row
  static constexpr int E = LOG_L > 0 ? 2 : 1;          // elements a pair (one at L = 1)
  static constexpr int T = 1 << P;                     // pairs a row
  static constexpr int TPR = T < kNttMaxThreads ? T : kNttMaxThreads;  // threads a row
  static constexpr int V = T / TPR;                    // pairs a thread
  static constexpr int THREADS = TPR > kNttMinThreads ? TPR : kNttMinThreads;
  static constexpr int ROWS = THREADS / TPR;
  static constexpr int MIN_BLOCKS = V == 1 ? kNttSmThreads / THREADS : 1;
  static constexpr int TOP = LOG_L > W + 1 ? LOG_L - 1 - W : 0;  // a of the top stages' layout
  static constexpr int BUF = ROWS * L;                 // elements a buffer
  static constexpr int BUFS = TOP <= 0 ? 0 : (2 * BUF * 32 <= 227 * 1024 ? 2 : 1);
  static constexpr int SMEM = BUFS * BUF * (int)sizeof(Fe);

  static __device__ __forceinline__ int a_of(int st) { return st < TOP ? st : TOP; }
  // row index of element e of pair t at stage st in the layout [a, a + W]:
  // lanes fill [a, a + W] but st, the pair's other bits the rest
  static __device__ __forceinline__ int index(int t, int e, int st, int a) {
    const int r = st - a;
    const int lane = t & ((1 << W) - 1), w = t >> W;
    const int intra = (lane & ((1 << r) - 1)) | ((lane >> r) << (r + 1)) | (e << r);
    return (w & ((1 << a) - 1)) | ((w >> a) << (a + W + 1)) | (intra << a);
  }
};

__device__ __forceinline__ int ntt_swizzle(int c) {
  const int f = (c >> 3) ^ (c >> 6) ^ (c >> 9) ^ (c >> 12) ^ (c >> 15) ^ (c >> 18);
  return c ^ (f & 7);
}

// element c of a two-plane buffer (plane = its number of 16-byte chunks)
__device__ __forceinline__ void ntt_put(uint4* s, int plane, int c, const Fe& v) {
  const int p = ntt_swizzle(c);
  s[p] = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
  s[plane + p] = make_uint4(v.w[4], v.w[5], v.w[6], v.w[7]);
}

__device__ __forceinline__ Fe ntt_get(const uint4* s, int plane, int c) {
  const int p = ntt_swizzle(c);
  const uint4 lo = s[p], hi = s[plane + p];
  return Fe{{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
}

template <int LOG_L>
struct NttRow {
  using S = NttShape<LOG_L>;
  Fe v[S::V][2];  // [.][1] unused at L = 1
  int p;        // the thread's index among its row's threads
  int row0;     // the row's first element in a shared buffer
  int st, a;    // the layout the registers hold
  int parity;   // the shared buffer the next layout change writes
  bool wrote;   // a layout change has happened (single buffer: barrier first)

  __device__ __forceinline__ int t(int vt) const { return p + vt * S::TPR; }
  __device__ __forceinline__ int at(int vt, int e) const { return S::index(t(vt), e, st, a); }

  // registers -> layout of stage `to`: lanes swap one element (same a), or
  // every pair passes through shared memory
  __device__ __forceinline__ void move(uint4* smem, int to) {
    const int ta = S::a_of(to);
    if (ta == a) {
      const int l = (to < st ? to : st) - a;  // the lane bit that swaps roles with the pair bit
      const bool b = (p >> l) & 1;
#pragma unroll
      for (int vt = 0; vt < S::V; ++vt) {
        Fe send = b ? v[vt][0] : v[vt][1];
        Fe got;
#pragma unroll
        for (int j = 0; j < 8; ++j) got.w[j] = __shfl_xor_sync(0xffffffffu, send.w[j], 1 << l);
        if (b) {
          v[vt][0] = got;
        } else {
          v[vt][1] = got;
        }
      }
    } else {
      int from[S::V][2], to_idx[S::V][2];
#pragma unroll
      for (int vt = 0; vt < S::V; ++vt)
#pragma unroll
        for (int e = 0; e < S::E; ++e) from[vt][e] = at(vt, e);
      st = to;
      a = ta;
#pragma unroll
      for (int vt = 0; vt < S::V; ++vt)
#pragma unroll
        for (int e = 0; e < S::E; ++e) to_idx[vt][e] = at(vt, e);
      pass(smem, from, to_idx);
    }
    // both, unconditionally: the compiler then folds every later index to a
    // constant (assigning them by branch cost 250 SASS instructions at L = 1024)
    st = to;
    a = ta;
  }

  // registers at row indices `from` -> shared memory -> registers at `to`
  __device__ __forceinline__ void pass(uint4* smem, const int (&from)[S::V][2], const int (&to)[S::V][2]) {
    if (S::BUFS == 1 && wrote) __syncthreads();  // every thread has read the last pass
    uint4* buf = smem + (S::BUFS == 2 ? parity : 0) * 2 * S::BUF;
#pragma unroll
    for (int vt = 0; vt < S::V; ++vt)
#pragma unroll
      for (int e = 0; e < S::E; ++e) ntt_put(buf, S::BUF, row0 + from[vt][e], v[vt][e]);
    __syncthreads();
#pragma unroll
    for (int vt = 0; vt < S::V; ++vt)
#pragma unroll
      for (int e = 0; e < S::E; ++e) v[vt][e] = ntt_get(buf, S::BUF, row0 + to[vt][e]);
    parity ^= 1;
    wrote = true;
  }

  // one stage on every pair: DIF (u + v, (u - v) w), DIT (u + w v, u - w v);
  // pos 0 (w = one) skips the multiply
  template <bool DIF>
  __device__ __forceinline__ void stage(const uint32_t* tw) {
    const int half = 1 << st;
#pragma unroll
    for (int vt = 0; vt < S::V; ++vt) {
      const int pos = at(vt, 0) & (half - 1);
      Fe& u = v[vt][0];
      Fe& x = v[vt][1];
      if (DIF) {
        const Fe d = sub<Fr>(u, x);
        u = add<Fr>(u, x);
        if (pos == 0) {
          x = d;
        } else {
          x = mul_lazy<Fr>(load(tw + 8 * (pos << (LOG_L - 1 - st))), d);
        }
      } else {
        Fe m;
        if (pos == 0) {
          m = x;
        } else {
          m = mul_lazy<Fr>(load(tw + 8 * (pos << (LOG_L - 1 - st))), x);
        }
        x = sub<Fr>(u, m);
        u = add<Fr>(u, m);
      }
    }
  }
};

template <int LOG_L>
__device__ __forceinline__ void ntt_rows_body(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                                              const uint32_t* __restrict__ tw_dif,
                                              const uint32_t* __restrict__ tw_dit,
                                              const uint32_t* __restrict__ pre, const uint32_t* __restrict__ mid,
                                              const uint32_t* __restrict__ post, int post_op, long long rows) {
  using S = NttShape<LOG_L>;
  extern __shared__ uint4 smem[];
  NttRow<LOG_L> r;
  r.p = threadIdx.x % S::TPR;
  const int rb = threadIdx.x / S::TPR;
  const long long row = (long long)blockIdx.x * S::ROWS + rb;
  const bool live = row < rows;  // guards memory only: every thread reaches every barrier and shuffle
  const long long g0 = row * S::L;
  r.row0 = rb * S::L;
  r.parity = 0;
  r.wrote = false;
  const bool dif = tw_dif != nullptr, dit = tw_dit != nullptr;
  r.st = dif ? LOG_L - 1 : 0;
  if (r.st < 0) r.st = 0;
  r.a = S::a_of(r.st);

#pragma unroll
  for (int vt = 0; vt < S::V; ++vt)
#pragma unroll
    for (int e = 0; e < S::E; ++e) {
      const long long i = g0 + r.at(vt, e);
      Fe v = live ? load(x + 8 * i) : zero();
      if (pre && live) v = mul_lazy<Fr>(load(pre + 8 * i), v);
      r.v[vt][e] = v;
    }
  if (dif) {
#pragma unroll
    for (int st = LOG_L - 1; st >= 0; --st) {
      if (st < LOG_L - 1) r.move(smem, st);
      r.template stage<true>(tw_dif);
    }
  }
  if (mid && live) {
#pragma unroll
    for (int vt = 0; vt < S::V; ++vt)
#pragma unroll
      for (int e = 0; e < S::E; ++e)
        r.v[vt][e] = mul_lazy<Fr>(load(mid + 8 * (g0 + r.at(vt, e))), r.v[vt][e]);
  }
  if (dit) {
#pragma unroll
    for (int st = 0; st < LOG_L; ++st) {
      if (st > 0) r.move(smem, st);
      r.template stage<false>(tw_dit);
    }
  }
  if (live) {
#pragma unroll
    for (int vt = 0; vt < S::V; ++vt)
#pragma unroll
      for (int e = 0; e < S::E; ++e) {
        const long long i = g0 + r.at(vt, e);
        Fe v = r.v[vt][e];
        if (post) {
          const Fe q = load(post + 8 * i);
          v = post_op == 0 ? mul_lazy<Fr>(q, v) : sub<Fr>(q, v);
        }
        store(out + 8 * i, v);
      }
  }
}

// ---- K5a/K5b: every radix-2 stage with half in [h_lo, h_hi], one launch ----
// Replaces field_pallas._butterfly_lm_blocked (field_pallas.py:272, K5a: DIT
// or DIF over limb-major halves) and _butterfly_blocked (:165, K5b: the
// row-major DIT butterfly), one pallas_call a stage there, with XLA slicing
// and merging the halves between calls. Butterfly of stage `half`: i0 with
// (i0 / half) even and i1 = i0 + half take the twiddle table[(i0 mod half)
// * (n/2/half)] of the n-th root table; DIT (u + w v, u - w v), DIF (u + v,
// (u - v) w); lazy [0, 2p) in and out; DIF runs the stages descending, DIT
// ascending.
//
// View x as (g, r, c) with c < h_lo and r < R = 2 h_hi / h_lo: every stage
// of the range pairs two rows of one column (g, c), so each column is an
// independent R-point sub-transform and no block needs another's results.
//
// Bound: at the flat chain's 2^13 shape (R = 16, h_lo = 512) launches and
// latency: 64 B of traffic and log2 R dependent Montgomery multiplies an
// element (0.0003 ms by operations). At R = 2 (one stage) bytes: 160 B a
// butterfly against one multiply.
//
// Design. A block takes C = 2 kBflyThreads / R consecutive columns (C = 4 at
// R = 16: 128 blocks at 2^13, not 16 on 132 SMs); thread (b, cc) runs
// butterfly b of column cc at every stage. It loads its first stage's two
// rows from device memory (16-byte loads, neighbouring threads on
// neighbouring columns, so each row's slice is one contiguous run), passes
// its pair through shared memory between stages (two planes of 16-byte
// halves, double-buffered: one barrier a stage) and stores its last stage's
// pair. Every multiply is kept, also those by w^0, so the words equal the
// stage-by-stage composition (fr_butterfly_stages_plain). Twiddles through
// L1 (__ldg).
constexpr int kBflyThreads = 32;  // threads a block: C = 2 kBflyThreads / R columns
constexpr int kBflyMaxLogR = 4;   // R <= 16: every high stage of the flat chain (n < 2^14)

__device__ __forceinline__ Fe load_ldg(const uint32_t* p) {
  const uint4 lo = __ldg(reinterpret_cast<const uint4*>(p));
  const uint4 hi = __ldg(reinterpret_cast<const uint4*>(p) + 1);
  return Fe{{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
}

// the first row of butterfly b in a stage whose rows pair at distance 2^s
__device__ __forceinline__ int bfly_row(int b, int s) { return ((b >> s) << (s + 1)) | (b & ((1 << s) - 1)); }

template <bool DIF, int LOG_R>
__global__ void __launch_bounds__(kBflyThreads)
    butterfly_stages_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ tw,
                            uint32_t* __restrict__ out, long long n, int log_lo) {
  constexpr int R = 1 << LOG_R;
  constexpr int C = 2 * kBflyThreads / R;
  constexpr int PLANE = R * C;  // 16-byte chunks a plane
  constexpr int BUFS = LOG_R > 2 ? 2 : LOG_R - 1;  // LOG_R - 1 exchanges
  __shared__ uint4 smem[BUFS > 0 ? BUFS * 2 * PLANE : 1];
  const int cc = threadIdx.x % C, b = threadIdx.x / C;
  const long long col = (long long)blockIdx.x * C + cc;
  const bool live = col < (n >> LOG_R);  // guards memory only: every thread reaches every barrier
  const long long h_lo = 1LL << log_lo;
  const long long c = col & (h_lo - 1);
  const long long base = ((col >> log_lo) << (log_lo + LOG_R)) | c;
  const long long tw_unit = (n >> 1) >> log_lo;  // n/2/half at half = h_lo
  int s = DIF ? LOG_R - 1 : 0;
  int r0 = bfly_row(b, s);
  Fe u = live ? load(x + 8 * (base + r0 * h_lo)) : zero();
  Fe v = live ? load(x + 8 * (base + (r0 + (1 << s)) * h_lo)) : zero();
#pragma unroll
  for (int step = 0; step < LOG_R; ++step) {
    if (step > 0) {
      uint4* buf = smem + (BUFS == 2 ? (step - 1) & 1 : 0) * 2 * PLANE;
      ntt_put(buf, PLANE, r0 * C + cc, u);
      ntt_put(buf, PLANE, (r0 + (1 << s)) * C + cc, v);
      __syncthreads();
      s = DIF ? LOG_R - 1 - step : step;
      r0 = bfly_row(b, s);
      u = ntt_get(buf, PLANE, r0 * C + cc);
      v = ntt_get(buf, PLANE, (r0 + (1 << s)) * C + cc);
    }
    const long long pos = ((long long)(r0 & ((1 << s) - 1)) << log_lo) | c;
    const Fe w = load_ldg(tw + 8 * (pos * (tw_unit >> s)));
    if (DIF) {
      const Fe d = sub<Fr>(u, v);
      u = add<Fr>(u, v);
      v = mul_lazy<Fr>(w, d);
    } else {
      const Fe t = mul_lazy<Fr>(w, v);
      v = sub<Fr>(u, t);
      u = add<Fr>(u, t);
    }
  }
  if (live) {
    store(out + 8 * (base + r0 * h_lo), u);
    store(out + 8 * (base + (r0 + (1 << s)) * h_lo), v);
  }
}

// ---- K2: within-tile segmented inclusive scan, lazy Fr add -----------------
// Replaces field_pallas._tile_scan_blocked (field_pallas.py:219):
// out[t, k] = ft[t, k] ? vt[t, k] : out[t, k - 1] + vt[t, k] (the sum
// starting at zero), carry[t] = out[t, K - 1]. The carry across tiles stays
// the recursion of ops/segments.py, since no grid state carries across
// blocks.
//
// Bound: bytes, 65 B an element (value in, sum out, flag) and 32 B a tile
// (carry) against one lazy add an element: nothing to hide a strided access
// behind. A thread per tile reading its own 512 B (the first design) put
// each warp access on 32 sectors.
//
// Design. A block takes batches of kScanTiles contiguous tiles of 16 (16
// KB). It brings a batch into shared memory with 16-byte cp.async,
// neighbouring threads on neighbouring chunks, at a swizzled slot
// (ntt_swizzle: without it a quarter-warp's tile-strided reads below would
// fall on the same four banks); thread j then scans tile j in the plain
// version's order of adds (so the lazy words are the plain version's), its
// 16 flags one 16-byte load, writes the running sums back into the same
// slots and its carry out, and the block stores the batch coalesced.
// kScanBufs buffers: the next batch's loads are in flight while one is
// scanned. The grid is persistent (every block resident, six an SM: 96 KB
// of loads in flight), the blocks taking batches round robin.
// CUDA and not Triton: the same swizzled staging as K3/K4, in the same file
// and build; Triton would serve a streaming scan too, but would add a
// second toolchain to the build for one kernel.
constexpr int kScanK = 16;      // a tile's elements (ops/segments.py TILE)
constexpr int kScanTiles = 32;  // tiles a batch, one thread each
constexpr int kScanBufs = 2;    // batches in shared memory a block
constexpr int kScanSmem = kScanBufs * kScanTiles * kScanK * (int)sizeof(Fe);

__device__ __forceinline__ void cp_async16(uint4* smem, const uint4* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

__global__ void __launch_bounds__(kScanTiles)
    fr_tile_scan_kernel(const uint32_t* __restrict__ v, const uint8_t* __restrict__ flags,
                        uint32_t* __restrict__ out, uint32_t* __restrict__ carry, long long T) {
  extern __shared__ uint4 smem[];
  constexpr int tile_chunks = 2 * kScanK;
  constexpr int batch_chunks = kScanTiles * tile_chunks;
  const uint4* src = reinterpret_cast<const uint4*>(v);
  uint4* dst = reinterpret_cast<uint4*>(out);
  // batch i of this block starts at tile first + i * stride (round robin)
  const long long first = (long long)blockIdx.x * kScanTiles;
  const long long stride = (long long)gridDim.x * kScanTiles;

  // one commit group a batch, empty past the end
  auto fetch = [&](long long i, int slot) {
    const long long t0 = first + i * stride;
    if (t0 < T) {
      const int count = (int)min((long long)kScanTiles, T - t0) * tile_chunks;
      uint4* buf = smem + slot * batch_chunks;
      const uint4* g = src + t0 * tile_chunks;
      for (int c = threadIdx.x; c < count; c += kScanTiles) cp_async16(buf + ntt_swizzle(c), g + c);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int k = 0; k < kScanBufs - 1; ++k) fetch(k, k);
  int slot = 0;
  for (long long i = 0; first + i * stride < T; ++i) {
    fetch(i + kScanBufs - 1, (slot + kScanBufs - 1) % kScanBufs);
    cp_async_wait<kScanBufs - 1>();  // this thread's chunks of batch i have landed
    __syncthreads();                 // ... and every other thread's
    uint4* buf = smem + slot * batch_chunks;
    const long long t0 = first + i * stride;
    const int tiles = (int)min((long long)kScanTiles, T - t0);
    const int j = threadIdx.x;
    if (j < tiles) {
      const long long t = t0 + j;
      const uint4 f = __ldg(reinterpret_cast<const uint4*>(flags + kScanK * t));
      const uint32_t fw[4] = {f.x, f.y, f.z, f.w};
      Fe acc = zero();
#pragma unroll
      for (int k = 0; k < kScanK; ++k) {
        const bool flag = ((fw[k >> 2] >> (8 * (k & 3))) & 0xffu) != 0u;
        const int c = j * tile_chunks + 2 * k;
        uint4* lo = buf + ntt_swizzle(c);
        uint4* hi = buf + ntt_swizzle(c + 1);
        const uint4 a = *lo, h = *hi;
        const Fe x = Fe{{a.x, a.y, a.z, a.w, h.x, h.y, h.z, h.w}};
        acc = flag ? x : add<Fr>(acc, x);
        *lo = make_uint4(acc.w[0], acc.w[1], acc.w[2], acc.w[3]);
        *hi = make_uint4(acc.w[4], acc.w[5], acc.w[6], acc.w[7]);
      }
      store(carry + 8 * t, acc);
    }
    __syncthreads();
    const int count = tiles * tile_chunks;
    uint4* g = dst + t0 * tile_chunks;
    for (int c = threadIdx.x; c < count; c += kScanTiles) g[c] = buf[ntt_swizzle(c)];
    __syncthreads();  // the buffer is refilled kScanBufs - 1 batches on
    slot = (slot + 1) % kScanBufs;
  }
}

// resident blocks an SM
int tile_scan_occupancy(int* blocks_per_sm) {
  const int rc = (int)cudaFuncSetAttribute((const void*)fr_tile_scan_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kScanSmem);
  if (rc != 0) return rc;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fr_tile_scan_kernel, kScanTiles,
                                                            kScanSmem);
}

inline unsigned blocks_for(long long n, int threads) { return (unsigned)((n + threads - 1) / threads); }

}  // namespace

extern "C" {

// field: 0 Fr, 1 Fq
int ccf_fr_binary(const void* a, const void* b, void* out, long long n, int op, int b_bcast, int field,
                  void* stream) {
  if (n > 0) {
    const int threads = 256;
    auto kernel = field ? binary_kernel<Fq> : binary_kernel<Fr>;
    kernel<<<blocks_for(n, threads), threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, op, b_bcast);
  }
  return (int)cudaGetLastError();
}

// x, out (n, 8) words; tw the (n/2, 8) table of the n-th root; the stages
// with half in [2^log_lo, 2^(log_lo + log_r - 1)], R = 2^log_r <= 16 rows a
// column: DIF descending, DIT ascending
int ccf_fr_butterfly_stages(const void* x, const void* tw, void* out, long long n, int log_lo, int log_r,
                            int dif, void* stream) {
  typedef void (*Kernel)(const uint32_t*, const uint32_t*, uint32_t*, long long, int);
  static const Kernel kernels[2][kBflyMaxLogR] = {
      {butterfly_stages_kernel<false, 1>, butterfly_stages_kernel<false, 2>, butterfly_stages_kernel<false, 3>,
       butterfly_stages_kernel<false, 4>},
      {butterfly_stages_kernel<true, 1>, butterfly_stages_kernel<true, 2>, butterfly_stages_kernel<true, 3>,
       butterfly_stages_kernel<true, 4>}};
  if (log_r < 1 || log_r > kBflyMaxLogR || log_lo < 0 || (n >> (log_lo + log_r)) < 1)
    return (int)cudaErrorInvalidValue;
  const int cols_a_block = 2 * kBflyThreads >> log_r;
  kernels[dif ? 1 : 0][log_r - 1]<<<blocks_for(n >> log_r, cols_a_block), kBflyThreads, 0,
                                    (cudaStream_t)stream>>>((const uint32_t*)x, (const uint32_t*)tw,
                                                            (uint32_t*)out, n, log_lo);
  return (int)cudaGetLastError();
}

int ccf_fq_op_chain(const void* a, const void* b, void* out, long long n, int op, int k, void* stream) {
  if (op < 0 || op > 5 || k < 0) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const ChainKernel kernel = kChainKernels[op][k == kChainSteps ? 1 : 0];
    int per_sm = 0, device = 0, sms = 0;
    int rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kChainThreads, 0);
    if (rc == 0) rc = (int)cudaGetDevice(&device);
    if (rc == 0) rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (rc != 0) return rc;
    const int threads = n > (long long)sms * per_sm * kChainThreads ? kChainWaveThreads : kChainThreads;
    kernel<<<blocks_for(n, threads), threads, 0, (cudaStream_t)stream>>>((const uint32_t*)a, (const uint32_t*)b,
                                                                         (uint32_t*)out, n, k);
  }
  return (int)cudaGetLastError();
}

// v, out (T, K, 8) words, flags (T, K) bytes (16-byte aligned), carry (T, 8);
// K must be 16
int ccf_fr_tile_scan(const void* v, const void* flags, void* out, void* carry, long long T, int K,
                     void* stream) {
  if (K != kScanK) return (int)cudaErrorInvalidValue;
  if (T > 0) {
    int per_sm = 0, device = 0, sms = 0;
    int rc = tile_scan_occupancy(&per_sm);
    if (rc == 0) rc = (int)cudaGetDevice(&device);
    if (rc == 0) rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (rc != 0) return rc;
    const long long batches = (T + kScanTiles - 1) / kScanTiles;
    const long long resident = (long long)sms * per_sm;
    const unsigned grid = (unsigned)(batches < resident ? batches : resident);  // persistent
    fr_tile_scan_kernel<<<grid, kScanTiles, kScanSmem, (cudaStream_t)stream>>>(
        (const uint32_t*)v, (const uint8_t*)flags, (uint32_t*)out, (uint32_t*)carry, T);
  }
  return (int)cudaGetLastError();
}

// info[0..3] of the launch: tiles a batch, batches in shared memory a
// block, dynamic shared memory bytes, resident blocks an SM
int ccf_fr_tile_scan_info(int* info) {
  info[0] = kScanTiles;
  info[1] = kScanBufs;
  info[2] = kScanSmem;
  return tile_scan_occupancy(&info[3]);
}

// One entry kernel a row length 2^LOG (the K3/K4 ptxas rows by name).
#define CCF_NTT_ROWS_KERNEL(LOG)                                                                        \
  __global__ void __launch_bounds__(NttShape<LOG>::THREADS, NttShape<LOG>::MIN_BLOCKS)                 \
      ccf_ntt_rows_log##LOG(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,                 \
                            const uint32_t* __restrict__ tw_dif, const uint32_t* __restrict__ tw_dit,   \
                            const uint32_t* __restrict__ pre, const uint32_t* __restrict__ mid,         \
                            const uint32_t* __restrict__ post, int post_op, long long rows) {           \
    ntt_rows_body<LOG>(x, out, tw_dif, tw_dit, pre, mid, post, post_op, rows);                          \
  }
CCF_NTT_ROWS_KERNEL(0)
CCF_NTT_ROWS_KERNEL(1)
CCF_NTT_ROWS_KERNEL(2)
CCF_NTT_ROWS_KERNEL(3)
CCF_NTT_ROWS_KERNEL(4)
CCF_NTT_ROWS_KERNEL(5)
CCF_NTT_ROWS_KERNEL(6)
CCF_NTT_ROWS_KERNEL(7)
CCF_NTT_ROWS_KERNEL(8)
CCF_NTT_ROWS_KERNEL(9)
CCF_NTT_ROWS_KERNEL(10)
CCF_NTT_ROWS_KERNEL(11)
CCF_NTT_ROWS_KERNEL(12)

typedef void (*NttRowsKernel)(const uint32_t*, uint32_t*, const uint32_t*, const uint32_t*, const uint32_t*,
                              const uint32_t*, const uint32_t*, int, long long);
struct NttRowsEntry {
  NttRowsKernel kernel;
  int threads, rows, smem;
};
#define CCF_NTT_ENTRY(LOG) \
  { ccf_ntt_rows_log##LOG, NttShape<LOG>::THREADS, NttShape<LOG>::ROWS, NttShape<LOG>::SMEM }
static const NttRowsEntry kNttRows[13] = {
    CCF_NTT_ENTRY(0), CCF_NTT_ENTRY(1), CCF_NTT_ENTRY(2),  CCF_NTT_ENTRY(3),  CCF_NTT_ENTRY(4),
    CCF_NTT_ENTRY(5), CCF_NTT_ENTRY(6), CCF_NTT_ENTRY(7),  CCF_NTT_ENTRY(8),  CCF_NTT_ENTRY(9),
    CCF_NTT_ENTRY(10), CCF_NTT_ENTRY(11), CCF_NTT_ENTRY(12)};

static int ntt_rows_prepare(int log_len) {
  if (log_len < 0 || log_len > 12) return (int)cudaErrorInvalidValue;
  const NttRowsEntry& e = kNttRows[log_len];
  if (e.smem > 48 * 1024)
    return (int)cudaFuncSetAttribute((const void*)e.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, e.smem);
  return 0;
}

int ccf_ntt_rows(const void* x, void* out, const void* tw_dif, const void* tw_dit, const void* pre,
                 const void* mid, const void* post, int post_op, long long rows, int log_len,
                 void* stream) {
  const int rc = ntt_rows_prepare(log_len);
  if (rc != 0) return rc;
  if (rows > 0) {
    const NttRowsEntry& e = kNttRows[log_len];
    e.kernel<<<(unsigned)((rows + e.rows - 1) / e.rows), e.threads, e.smem, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (uint32_t*)out, (const uint32_t*)tw_dif, (const uint32_t*)tw_dit,
        (const uint32_t*)pre, (const uint32_t*)mid, (const uint32_t*)post, post_op, rows);
  }
  return (int)cudaGetLastError();
}

// info[0..3] of the row length 2^log_len's launch: threads a block, rows a
// block, dynamic shared memory bytes, resident blocks an SM (occupancy)
int ccf_ntt_rows_info(int log_len, int* info) {
  const int rc = ntt_rows_prepare(log_len);
  if (rc != 0) return rc;
  const NttRowsEntry& e = kNttRows[log_len];
  info[0] = e.threads;
  info[1] = e.rows;
  info[2] = e.smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[3], e.kernel, e.threads, e.smem);
}

}  // extern "C"
