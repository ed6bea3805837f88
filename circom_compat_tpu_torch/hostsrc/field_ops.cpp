// Native host-side BN254 field helpers for the zkey/staging pipeline.
//
// The role of this file is the same as ark-ff's x86 asm backend in the
// reference stack (Cargo.toml:25 `features = ["asm"]`): bulk Montgomery
// arithmetic on the HOST, used where the data is still host-resident —
// stripping the R factor from multi-million-entry .zkey coefficient
// sections (reference: src/zkey.rs:320-325 reads Fr values stored as
// v*R^2 and reduces once) before limb-decomposed device staging.
//
// Layout contract: elements are contiguous 32-byte little-endian values —
// the .zkey wire encoding, which on a little-endian machine is also the
// byte image of both the numpy (n, 16) uint16 limb arrays and the 4x64
// limb vectors used here.  So the strip is a cast, not a conversion.
//
// Build: g++ -O3 -shared -fPIC -pthread, at first use, by
// circom_compat_tpu_torch/_host_build.py (ops/native_field.py).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

typedef unsigned __int128 u128;

// out = a * 2^-256 mod p (Montgomery REDC, 4x64 CIOS). np64 = -p^-1 mod 2^64.
// Valid for any a < 2^256 (< R*p); result fully reduced to [0, p).
static inline void redc_one(const uint64_t* a, uint64_t* out,
                            const uint64_t* p, uint64_t np64) {
  uint64_t t0 = a[0], t1 = a[1], t2 = a[2], t3 = a[3], t4 = 0;
  for (int i = 0; i < 4; ++i) {
    uint64_t m = t0 * np64;
    u128 s = (u128)m * p[0] + t0;
    uint64_t c = (uint64_t)(s >> 64);
    s = (u128)m * p[1] + t1 + c; t0 = (uint64_t)s; c = (uint64_t)(s >> 64);
    s = (u128)m * p[2] + t2 + c; t1 = (uint64_t)s; c = (uint64_t)(s >> 64);
    s = (u128)m * p[3] + t3 + c; t2 = (uint64_t)s; c = (uint64_t)(s >> 64);
    s = (u128)t4 + c;            t3 = (uint64_t)s; t4 = (uint64_t)(s >> 64);
  }
  // conditional subtract: result < 2p, so one pass suffices.
  u128 d = (u128)t0 - p[0];
  uint64_t r0 = (uint64_t)d, br = (uint64_t)(d >> 64) & 1;
  d = (u128)t1 - p[1] - br; uint64_t r1 = (uint64_t)d; br = (uint64_t)(d >> 64) & 1;
  d = (u128)t2 - p[2] - br; uint64_t r2 = (uint64_t)d; br = (uint64_t)(d >> 64) & 1;
  d = (u128)t3 - p[3] - br; uint64_t r3 = (uint64_t)d; br = (uint64_t)(d >> 64) & 1;
  if (t4 || !br) { out[0] = r0; out[1] = r1; out[2] = r2; out[3] = r3; }
  else           { out[0] = t0; out[1] = t1; out[2] = t2; out[3] = t3; }
}

// out = a * b * 2^-256 mod p (Montgomery CIOS multiply), fully reduced.
static inline void mont_mul_one(const uint64_t* a, const uint64_t* b,
                                uint64_t* out, const uint64_t* p, uint64_t np64) {
  uint64_t t[5] = {0, 0, 0, 0, 0};
  for (int i = 0; i < 4; ++i) {
    uint64_t c = 0;
    u128 s;
    s = (u128)a[0] * b[i] + t[0];     t[0] = (uint64_t)s; c = (uint64_t)(s >> 64);
    s = (u128)a[1] * b[i] + t[1] + c; t[1] = (uint64_t)s; c = (uint64_t)(s >> 64);
    s = (u128)a[2] * b[i] + t[2] + c; t[2] = (uint64_t)s; c = (uint64_t)(s >> 64);
    s = (u128)a[3] * b[i] + t[3] + c; t[3] = (uint64_t)s; c = (uint64_t)(s >> 64);
    s = (u128)t[4] + c;               t[4] = (uint64_t)s;
    uint64_t hi = (uint64_t)(s >> 64);

    uint64_t m = t[0] * np64;
    s = (u128)m * p[0] + t[0];        c = (uint64_t)(s >> 64);
    s = (u128)m * p[1] + t[1] + c;    t[0] = (uint64_t)s; c = (uint64_t)(s >> 64);
    s = (u128)m * p[2] + t[2] + c;    t[1] = (uint64_t)s; c = (uint64_t)(s >> 64);
    s = (u128)m * p[3] + t[3] + c;    t[2] = (uint64_t)s; c = (uint64_t)(s >> 64);
    s = (u128)t[4] + c;               t[3] = (uint64_t)s;
    t[4] = hi + (uint64_t)(s >> 64);
  }
  u128 d = (u128)t[0] - p[0];
  uint64_t r0 = (uint64_t)d, br = (uint64_t)(d >> 64) & 1;
  d = (u128)t[1] - p[1] - br; uint64_t r1 = (uint64_t)d; br = (uint64_t)(d >> 64) & 1;
  d = (u128)t[2] - p[2] - br; uint64_t r2 = (uint64_t)d; br = (uint64_t)(d >> 64) & 1;
  d = (u128)t[3] - p[3] - br; uint64_t r3 = (uint64_t)d; br = (uint64_t)(d >> 64) & 1;
  if (t[4] || !br) { out[0] = r0; out[1] = r1; out[2] = r2; out[3] = r3; }
  else { out[0] = t[0]; out[1] = t[1]; out[2] = t[2]; out[3] = t[3]; }
}

static void run_threaded(uint64_t n, int nthreads,
                         const std::function<void(uint64_t, uint64_t)>& body) {
  if (nthreads <= 1 || n < 4096) { body(0, n); return; }
  std::vector<std::thread> ts;
  uint64_t chunk = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    uint64_t lo = (uint64_t)t * chunk;
    if (lo >= n) break;
    uint64_t hi = lo + chunk < n ? lo + chunk : n;
    ts.emplace_back([&body, lo, hi] { body(lo, hi); });
  }
  for (auto& t : ts) t.join();
}

// ---------------------------------------------------------------------------
// Host Pippenger G1 MSM, a CPU baseline beside the device MSM. Plays the role of
// ark-ec's parallel MSM (reference: Cargo.toml:26 ark-ec features
// ["parallel"], consumed by the Groth16 prover hot path, SURVEY §3.4):
// Jacobian bucket accumulation with mixed adds, one thread per window.
// Coordinates stay in the Montgomery domain end to end.
// ---------------------------------------------------------------------------

struct Fp {
  const uint64_t* p;
  uint64_t np64;
};

static inline void fp_add(const Fp& f, const uint64_t* a, const uint64_t* b,
                          uint64_t* out) {
  u128 s = (u128)a[0] + b[0];
  uint64_t t0 = (uint64_t)s, c = (uint64_t)(s >> 64);
  s = (u128)a[1] + b[1] + c; uint64_t t1 = (uint64_t)s; c = (uint64_t)(s >> 64);
  s = (u128)a[2] + b[2] + c; uint64_t t2 = (uint64_t)s; c = (uint64_t)(s >> 64);
  s = (u128)a[3] + b[3] + c; uint64_t t3 = (uint64_t)s; c = (uint64_t)(s >> 64);
  // conditional subtract p (inputs < p so sum < 2p; carry c means >= 2^256 > p)
  u128 d = (u128)t0 - f.p[0];
  uint64_t r0 = (uint64_t)d, br = (uint64_t)(d >> 64) & 1;
  d = (u128)t1 - f.p[1] - br; uint64_t r1 = (uint64_t)d; br = (uint64_t)(d >> 64) & 1;
  d = (u128)t2 - f.p[2] - br; uint64_t r2 = (uint64_t)d; br = (uint64_t)(d >> 64) & 1;
  d = (u128)t3 - f.p[3] - br; uint64_t r3 = (uint64_t)d; br = (uint64_t)(d >> 64) & 1;
  if (c || !br) { out[0] = r0; out[1] = r1; out[2] = r2; out[3] = r3; }
  else          { out[0] = t0; out[1] = t1; out[2] = t2; out[3] = t3; }
}

static inline void fp_sub(const Fp& f, const uint64_t* a, const uint64_t* b,
                          uint64_t* out) {
  u128 d = (u128)a[0] - b[0];
  uint64_t t0 = (uint64_t)d, br = (uint64_t)(d >> 64) & 1;
  d = (u128)a[1] - b[1] - br; uint64_t t1 = (uint64_t)d; br = (uint64_t)(d >> 64) & 1;
  d = (u128)a[2] - b[2] - br; uint64_t t2 = (uint64_t)d; br = (uint64_t)(d >> 64) & 1;
  d = (u128)a[3] - b[3] - br; uint64_t t3 = (uint64_t)d; br = (uint64_t)(d >> 64) & 1;
  if (br) {  // borrow: add p back
    u128 s = (u128)t0 + f.p[0];
    out[0] = (uint64_t)s; uint64_t c = (uint64_t)(s >> 64);
    s = (u128)t1 + f.p[1] + c; out[1] = (uint64_t)s; c = (uint64_t)(s >> 64);
    s = (u128)t2 + f.p[2] + c; out[2] = (uint64_t)s; c = (uint64_t)(s >> 64);
    s = (u128)t3 + f.p[3] + c; out[3] = (uint64_t)s;
  } else { out[0] = t0; out[1] = t1; out[2] = t2; out[3] = t3; }
}

static inline void fp_mul(const Fp& f, const uint64_t* a, const uint64_t* b,
                          uint64_t* out) {
  mont_mul_one(a, b, out, f.p, f.np64);
}

static inline bool fp_eq(const uint64_t* a, const uint64_t* b) {
  return a[0] == b[0] && a[1] == b[1] && a[2] == b[2] && a[3] == b[3];
}

static inline bool fp_is_zero(const uint64_t* a) {
  return (a[0] | a[1] | a[2] | a[3]) == 0;
}

// Jacobian point, Montgomery coordinates; infinity <=> Z == 0.
struct Jac {
  uint64_t X[4], Y[4], Z[4];
};

static inline void jac_set_inf(Jac& r) { std::memset(&r, 0, sizeof(Jac)); }
static inline bool jac_is_inf(const Jac& r) { return fp_is_zero(r.Z); }

// dbl-2007-bl (a = 0 curve): 4M + 5S. Alias-safe for &q == &r.
static void jac_dbl(const Fp& f, const Jac& q, Jac& r) {
  if (jac_is_inf(q)) { r = q; return; }
  uint64_t A[4], B[4], C[4], D[4], E[4], F[4], t[4], u[4], z3[4];
  fp_mul(f, q.Y, q.Z, z3); fp_add(f, z3, z3, z3);  // Z3 = 2YZ (before writes)
  fp_mul(f, q.X, q.X, A);                    // A = X^2
  fp_mul(f, q.Y, q.Y, B);                    // B = Y^2
  fp_mul(f, B, B, C);                        // C = B^2
  fp_add(f, q.X, B, t); fp_mul(f, t, t, t);  // (X+B)^2
  fp_sub(f, t, A, t); fp_sub(f, t, C, t);
  fp_add(f, t, t, D);                        // D = 2((X+B)^2 - A - C)
  fp_add(f, A, A, E); fp_add(f, E, A, E);    // E = 3A
  fp_mul(f, E, E, F);                        // F = E^2
  fp_sub(f, F, D, u); fp_sub(f, u, D, r.X);  // X3 = F - 2D
  fp_add(f, C, C, t); fp_add(f, t, t, t); fp_add(f, t, t, t);  // 8C
  fp_sub(f, D, r.X, u); fp_mul(f, E, u, u); fp_sub(f, u, t, r.Y);
  std::memcpy(r.Z, z3, 32);
}

// madd-2007-bl mixed add (Q affine with implicit Z = one_mont): 7M + 4S
static void jac_madd(const Fp& f, const Jac& q, const uint64_t* ax,
                     const uint64_t* ay, const uint64_t* one_mont, Jac& r) {
  if (jac_is_inf(q)) {
    std::memcpy(r.X, ax, 32); std::memcpy(r.Y, ay, 32);
    std::memcpy(r.Z, one_mont, 32);
    return;
  }
  uint64_t Z1Z1[4], U2[4], S2[4], H[4], HH[4], I[4], J[4], rr[4], V[4], t[4];
  fp_mul(f, q.Z, q.Z, Z1Z1);
  fp_mul(f, ax, Z1Z1, U2);
  fp_mul(f, ay, q.Z, t); fp_mul(f, t, Z1Z1, S2);
  if (fp_eq(U2, q.X)) {
    if (fp_eq(S2, q.Y)) { jac_dbl(f, q, r); return; }
    jac_set_inf(r); return;
  }
  fp_sub(f, U2, q.X, H);
  fp_mul(f, H, H, HH);
  fp_add(f, HH, HH, I); fp_add(f, I, I, I);      // I = 4HH
  fp_mul(f, H, I, J);
  fp_sub(f, S2, q.Y, rr); fp_add(f, rr, rr, rr); // r = 2(S2-Y1)
  fp_mul(f, q.X, I, V);
  fp_mul(f, rr, rr, t); fp_sub(f, t, J, t);
  fp_sub(f, t, V, t); fp_sub(f, t, V, r.X);      // X3 = r^2 - J - 2V
  uint64_t Y1J[4];
  fp_mul(f, q.Y, J, Y1J); fp_add(f, Y1J, Y1J, Y1J);
  fp_sub(f, V, r.X, t); fp_mul(f, rr, t, t); fp_sub(f, t, Y1J, r.Y);
  fp_add(f, q.Z, H, t); fp_mul(f, t, t, t);
  fp_sub(f, t, Z1Z1, t); fp_sub(f, t, HH, r.Z);  // Z3 = (Z1+H)^2 - Z1Z1 - HH
}

// add-2007-bl general Jacobian add: 11M + 5S
static void jac_add(const Fp& f, const Jac& a, const Jac& b, Jac& r) {
  if (jac_is_inf(a)) { r = b; return; }
  if (jac_is_inf(b)) { r = a; return; }
  uint64_t Z1Z1[4], Z2Z2[4], U1[4], U2[4], S1[4], S2[4], t[4];
  fp_mul(f, a.Z, a.Z, Z1Z1);
  fp_mul(f, b.Z, b.Z, Z2Z2);
  fp_mul(f, a.X, Z2Z2, U1);
  fp_mul(f, b.X, Z1Z1, U2);
  fp_mul(f, a.Y, b.Z, t); fp_mul(f, t, Z2Z2, S1);
  fp_mul(f, b.Y, a.Z, t); fp_mul(f, t, Z1Z1, S2);
  if (fp_eq(U1, U2)) {
    if (fp_eq(S1, S2)) { jac_dbl(f, a, r); return; }
    jac_set_inf(r); return;
  }
  uint64_t H[4], I[4], J[4], rr[4], V[4];
  fp_sub(f, U2, U1, H);
  fp_add(f, H, H, t); fp_mul(f, t, t, I);        // I = (2H)^2
  fp_mul(f, H, I, J);
  fp_sub(f, S2, S1, rr); fp_add(f, rr, rr, rr);  // r = 2(S2-S1)
  fp_mul(f, U1, I, V);
  fp_mul(f, rr, rr, t); fp_sub(f, t, J, t);
  fp_sub(f, t, V, t); fp_sub(f, t, V, r.X);
  uint64_t S1J[4];
  fp_mul(f, S1, J, S1J); fp_add(f, S1J, S1J, S1J);
  fp_sub(f, V, r.X, t); fp_mul(f, rr, t, t); fp_sub(f, t, S1J, r.Y);
  fp_add(f, a.Z, b.Z, t); fp_mul(f, t, t, t);
  fp_sub(f, t, Z1Z1, t); fp_sub(f, t, Z2Z2, t);
  fp_mul(f, t, H, r.Z);
}

static inline uint32_t window_digit(const uint64_t* sc, int w, int wb) {
  int bit = w * wb;
  int limb = bit >> 6, off = bit & 63;
  uint64_t lo = sc[limb] >> off;
  if (off + wb > 64 && limb + 1 < 4) lo |= sc[limb + 1] << (64 - off);
  return (uint32_t)(lo & ((1u << wb) - 1));
}

}  // namespace

extern "C" {

// out[i] = in[i] * 2^-256 mod p for n contiguous 32-byte LE elements.
void mont_strip(const uint8_t* in, uint8_t* out, uint64_t n,
                const uint64_t* p, uint64_t np64, int nthreads) {
  run_threaded(n, nthreads, [=](uint64_t lo, uint64_t hi) {
    uint64_t a[4], r[4];
    for (uint64_t i = lo; i < hi; ++i) {
      std::memcpy(a, in + i * 32, 32);
      redc_one(a, r, p, np64);
      std::memcpy(out + i * 32, r, 32);
    }
  });
}

// out[i] = in[i] * c * 2^-256 mod p — one shared Montgomery factor applied
// across a section (e.g. ceremony delta^-1 rescaling of Fr vectors).
void mont_mul_const(const uint8_t* in, uint8_t* out, uint64_t n,
                    const uint64_t* c_limbs, const uint64_t* p, uint64_t np64,
                    int nthreads) {
  run_threaded(n, nthreads, [=](uint64_t lo, uint64_t hi) {
    uint64_t a[4], r[4];
    for (uint64_t i = lo; i < hi; ++i) {
      std::memcpy(a, in + i * 32, 32);
      mont_mul_one(a, c_limbs, r, p, np64);
      std::memcpy(out + i * 32, r, 32);
    }
  });
}

// Pippenger window sums for G1. xs/ys: n affine Montgomery coordinates
// (32-byte LE each, infinity encoded as x == y == 0 per the zkey
// convention); scalars: n plain canonical 32-byte LE values; out: W
// Jacobian points (X, Y, Z contiguous, 96 bytes each, Montgomery domain),
// W = ceil(254 / window_bits). One thread per window — each thread owns
// its buckets, no synchronization. The caller Horner-folds the W sums.
void msm_g1_window_sums(const uint8_t* xs, const uint8_t* ys,
                        const uint8_t* scalars, uint64_t n, int window_bits,
                        const uint64_t* p, uint64_t np64,
                        const uint64_t* one_mont, uint8_t* out,
                        int nthreads) {
  const int W = (254 + window_bits - 1) / window_bits;
  const uint32_t B = 1u << window_bits;
  Fp f{p, np64};
  std::vector<std::thread> threads;
  std::atomic<int> next{0};
  if (nthreads <= 0) nthreads = 1;
  auto worker = [&]() {
    std::vector<Jac> buckets(B - 1);
    for (;;) {
      int w = next.fetch_add(1);
      if (w >= W) return;
      for (auto& b : buckets) jac_set_inf(b);
      for (uint64_t i = 0; i < n; ++i) {
        const uint64_t* sc = (const uint64_t*)(scalars + i * 32);
        uint32_t d = window_digit(sc, w, window_bits);
        if (!d) continue;
        const uint64_t* ax = (const uint64_t*)(xs + i * 32);
        const uint64_t* ay = (const uint64_t*)(ys + i * 32);
        if (fp_is_zero(ax) && fp_is_zero(ay)) continue;  // infinity row
        jac_madd(f, buckets[d - 1], ax, ay, one_mont, buckets[d - 1]);
      }
      Jac running, sum;
      jac_set_inf(running); jac_set_inf(sum);
      for (uint32_t j = B - 1; j >= 1; --j) {
        jac_add(f, running, buckets[j - 1], running);
        jac_add(f, sum, running, sum);
      }
      std::memcpy(out + (uint64_t)w * 96, &sum, 96);
    }
  };
  int tcount = nthreads < W ? nthreads : W;
  for (int t = 0; t < tcount; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

}  // extern "C"
