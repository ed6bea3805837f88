// Field kernels: K1 fr_binary (Fr and Fq), K2 fr_tile_scan, K3/K4 ntt_rows,
// K5a/K5b fr_butterfly_stage, K9 fq_op_chain.
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

// ---- K5a/K5b: one radix-2 stage over the whole vector ----------------------
// Replaces field_pallas._butterfly_lm_blocked (field_pallas.py:272, K5a: DIT
// or DIF over limb-major halves) and _butterfly_blocked (:165, K5b: the
// row-major DIT butterfly). Butterfly j pairs i0 = (j / half) * 2 half +
// j % half with i1 = i0 + half and takes the twiddle table[(j % half) *
// tw_stride] of the n-th root table, so the JAX package's stage slices,
// merge copies and broadcast twiddle array become this kernel's indexing.
// DIT: (u + w v, u - w v); DIF: (u + v, (u - v) w). Lazy [0, 2p) in and out.
// Bound: bytes, 160 B per butterfly (u, v, w read, two outputs written)
// against one Montgomery multiply (264 multiply-adds). Design: one thread
// per butterfly, 16-byte loads; a stage's halves are 32 * half bytes
// apart, so neighbouring threads read neighbouring rows of each half.
template <bool DIF>
__global__ void butterfly_stage_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ tw,
                                       uint32_t* __restrict__ out, long long pairs, int log_half,
                                       long long tw_stride) {
  const long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (j >= pairs) return;
  const long long half = 1LL << log_half;
  const long long pos = j & (half - 1);
  const long long i0 = ((j >> log_half) << (log_half + 1)) + pos;
  const long long i1 = i0 + half;
  const Fe u = load(x + 8 * i0);
  const Fe v = load(x + 8 * i1);
  const Fe w = load(tw + 8 * (pos * tw_stride));
  if (DIF) {
    store(out + 8 * i0, add<Fr>(u, v));
    store(out + 8 * i1, mul_lazy<Fr>(w, sub<Fr>(u, v)));
  } else {
    const Fe t = mul_lazy<Fr>(w, v);
    store(out + 8 * i0, add<Fr>(u, t));
    store(out + 8 * i1, sub<Fr>(u, t));
  }
}

// ---- K9: a K-step dependent chain of one Fq op per element -----------------
// Replaces scripts/bench_field_ops.py run_op (:76, the pallas_call at :79):
// acc = op(acc, b) K times, acc starting at a. Ops (bench_field_ops.py:45-65):
// 0 mont_mul, 1 mont_mul_lazy, 2 add (mod p), 3 add_lazy, 4 sub_lazy,
// 5 mul9 (8 acc + b by three doublings and one add, all lazy). Its
// "normalize" op is a carry pass of 16-bit limbs in 32-bit lanes: 32-bit
// words carry inside the multiply-add chain, so it has no counterpart.
// Bound: operations, K dependent ops per element in registers against
// 96 B of traffic. Design: one thread per element, the op chosen by a
// template so the chain is straight-line code.
template <int OP>
__global__ void fq_op_chain_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                   uint32_t* __restrict__ o, long long n, int k) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe acc = load(a + 8 * i);
  const Fe y = load(b + 8 * i);
  for (int s = 0; s < k; ++s) {
    if (OP == 0) acc = mul<Fq>(acc, y);
    if (OP == 1) acc = mul_lazy<Fq>(acc, y);
    if (OP == 2) acc = add_canon<Fq>(acc, y);
    if (OP == 3) acc = add<Fq>(acc, y);
    if (OP == 4) acc = sub<Fq>(acc, y);
    if (OP == 5) {
      const Fe x2 = add<Fq>(acc, acc);
      const Fe x4 = add<Fq>(x2, x2);
      acc = add<Fq>(add<Fq>(x4, x4), y);
    }
  }
  store(o + 8 * i, acc);
}

// ---- K2: within-tile segmented inclusive scan, lazy Fr add -----------------
// Replaces field_pallas._tile_scan_blocked (field_pallas.py:219). Bound:
// bytes (one add per 64 B moved). Design: one thread per tile runs the K
// sequential steps in registers; the carry across tiles stays the
// recursion of ops/segments.py, since no grid state carries across blocks.
__global__ void fr_tile_scan_kernel(const uint32_t* __restrict__ v, const uint8_t* __restrict__ flags,
                                    uint32_t* __restrict__ out, uint32_t* __restrict__ carry,
                                    long long T, int K) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= T) return;
  Fe acc = zero();
  for (int k = 0; k < K; ++k) {
    const long long idx = t * K + k;
    const Fe x = load(v + 8 * idx);
    acc = flags[idx] ? x : add<Fr>(acc, x);
    store(out + 8 * idx, acc);
  }
  store(carry + 8 * t, acc);
}

// ---- K3/K4: all radix-2 stages of one row, resident in shared memory ------
// Replaces field_pallas.ntt_low_stages_lm (:363, low mode) and
// ntt_mid_stages_lm (:416, mid mode). Bound: operations: a 1024-row does
// 10 * 512 butterfly multiplies (+ up to 2 * 1024 pointwise) per 64 KB of
// row traffic. Design: one block per row, the row (L * 32 B, 32 KB at
// L = 1024) in shared memory for all stages; each stage's twiddle is read
// from the row's root table, tw[(j % half) * (L / 2 / half)], so no
// per-stage twiddle stack exists. Order: optional pre-multiply, DIF stages
// (descending, tw_dif), optional mid multiply, DIT stages (ascending,
// tw_dit), optional post multiply (post_op 0) or post - x (post_op 1).
__global__ void ntt_rows_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                                const uint32_t* __restrict__ tw_dif, const uint32_t* __restrict__ tw_dit,
                                const uint32_t* __restrict__ pre, const uint32_t* __restrict__ mid,
                                const uint32_t* __restrict__ post, int post_op, int log_len) {
  extern __shared__ uint4 smem[];
  Fe* s = reinterpret_cast<Fe*>(smem);
  const int L = 1 << log_len;
  const int H = L >> 1;
  const int nt = blockDim.x;
  const long long base = (long long)blockIdx.x * L;

  for (int l = threadIdx.x; l < L; l += nt) {
    Fe v = load(x + 8 * (base + l));
    if (pre) v = mul_lazy<Fr>(load(pre + 8 * (base + l)), v);
    s[l] = v;
  }
  __syncthreads();
  if (tw_dif) {
    for (int st = log_len - 1; st >= 0; --st) {
      const int half = 1 << st;
      const int stride = H >> st;
      for (int j = threadIdx.x; j < H; j += nt) {
        const int pos = j & (half - 1);
        const int i0 = ((j >> st) << (st + 1)) + pos;
        const int i1 = i0 + half;
        const Fe u = s[i0], v = s[i1];
        const Fe w = load(tw_dif + 8 * (pos * stride));
        s[i0] = add<Fr>(u, v);
        s[i1] = mul_lazy<Fr>(w, sub<Fr>(u, v));
      }
      __syncthreads();
    }
  }
  if (mid) {
    for (int l = threadIdx.x; l < L; l += nt) s[l] = mul_lazy<Fr>(load(mid + 8 * (base + l)), s[l]);
    __syncthreads();
  }
  if (tw_dit) {
    for (int st = 0; st < log_len; ++st) {
      const int half = 1 << st;
      const int stride = H >> st;
      for (int j = threadIdx.x; j < H; j += nt) {
        const int pos = j & (half - 1);
        const int i0 = ((j >> st) << (st + 1)) + pos;
        const int i1 = i0 + half;
        const Fe u = s[i0];
        const Fe t = mul_lazy<Fr>(load(tw_dit + 8 * (pos * stride)), s[i1]);
        s[i0] = add<Fr>(u, t);
        s[i1] = sub<Fr>(u, t);
      }
      __syncthreads();
    }
  }
  for (int l = threadIdx.x; l < L; l += nt) {
    Fe v = s[l];
    if (post) {
      const Fe q = load(post + 8 * (base + l));
      v = post_op == 0 ? mul_lazy<Fr>(q, v) : sub<Fr>(q, v);
    }
    store(out + 8 * (base + l), v);
  }
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

// x, out (n, 8) words; tw the (n/2, 8) table of the n-th root; half = 2^log_half
int ccf_fr_butterfly_stage(const void* x, const void* tw, void* out, long long n, int log_half, int dif,
                           void* stream) {
  const long long pairs = n / 2;
  if (pairs > 0) {
    const int threads = 256;
    const long long tw_stride = pairs >> log_half;
    auto kernel = dif ? butterfly_stage_kernel<true> : butterfly_stage_kernel<false>;
    kernel<<<blocks_for(pairs, threads), threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (const uint32_t*)tw, (uint32_t*)out, pairs, log_half, tw_stride);
  }
  return (int)cudaGetLastError();
}

int ccf_fq_op_chain(const void* a, const void* b, void* out, long long n, int op, int k, void* stream) {
  if (n > 0) {
    const int threads = 256;
    void (*kernels[])(const uint32_t*, const uint32_t*, uint32_t*, long long, int) = {
        fq_op_chain_kernel<0>, fq_op_chain_kernel<1>, fq_op_chain_kernel<2>,
        fq_op_chain_kernel<3>, fq_op_chain_kernel<4>, fq_op_chain_kernel<5>};
    if (op < 0 || op > 5) return (int)cudaErrorInvalidValue;
    kernels[op]<<<blocks_for(n, threads), threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, k);
  }
  return (int)cudaGetLastError();
}

int ccf_fr_tile_scan(const void* v, const void* flags, void* out, void* carry, long long T, int K,
                     void* stream) {
  if (T > 0) {
    const int threads = 128;
    fr_tile_scan_kernel<<<blocks_for(T, threads), threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)v, (const uint8_t*)flags, (uint32_t*)out, (uint32_t*)carry, T, K);
  }
  return (int)cudaGetLastError();
}

int ccf_ntt_rows(const void* x, void* out, const void* tw_dif, const void* tw_dit, const void* pre,
                 const void* mid, const void* post, int post_op, long long rows, int log_len,
                 void* stream) {
  if (rows > 0) {
    const int L = 1 << log_len;
    const size_t smem = (size_t)L * sizeof(Fe);
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(ntt_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    }
    const int threads = L / 2 < 512 ? (L / 2 > 0 ? L / 2 : 1) : 512;
    ntt_rows_kernel<<<(unsigned)rows, threads, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (uint32_t*)out, (const uint32_t*)tw_dif, (const uint32_t*)tw_dit,
        (const uint32_t*)pre, (const uint32_t*)mid, (const uint32_t*)post, post_op, log_len);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
