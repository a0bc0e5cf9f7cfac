// Mamba2 SSD (state-space dual) recurrence for Hopper, chunked on the
// tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/mamba2_ssd.py::ssd_pallas
// (kernel body _kernel).  For every (batch b, head h), with the head's
// group g = h * G / H:
//
//   S_t = exp(A[h] dt_t) S_{t-1} + dt_t x_t B_t^T    S[p,n] = decay S[p,n] + dt x_t[p] B_t[g,n]
//   y_t = S_t C_t + D[h] x_t                         y_t[p] = sum_n S[p,n] C_t[g,n] + D[h] x_t[p]
//
// with x: (B,H,T,P), dt: (B,H,T), A, D: (H,), Bm, Cm: (B,G,T,N), state:
// (B,H,P,N), all float32 and contiguous, Bm, Cm and the states 16-byte
// aligned; y: (B,H,T,P), the final state: (B,H,P,N).
//
// Chunked design (T >= 64; at N = 128, T >= 32).  One CTA of 16 warps per
// (b, h, tile of kRows = 64 state rows p): the rows of S evolve
// independently, so the tiles split the state without any exchange
// (zamba2: 112 CTAs, one head each).  The CTA walks the sequence in blocks
// of 64 tokens (32 at N = 128, to fit shared memory; the last block is
// shorter and zero-filled), the next block's x, dt, B and C in flight by
// cp.async while this one computes.  Per block, with cs the inclusive
// prefix sum of A dt over the block:
//
//   G  = C B^T                          (c x c, depth N; s <= t only)
//   GL = G o L,  L[t,s] = exp(cs_t - cs_s) dt_s  for s <= t, else 0
//   y  = diag(exp(cs_t)) C S^T + GL x + D x
//   S  = exp(cs_end) S + (x o w)^T B,   w_s = dt_s exp(cs_end - cs_s)
//
// All four products run on the tensor cores as mma.sync m16n8k8 TF32
// under the 3xTF32 split (tf32x3.cuh), which keeps float32 accuracy.  The
// split costs more instructions than the products, so every operand is
// split once per block into hi and lo tiles in shared memory (x, B and C
// on arrival, G o L and S where they are written; only x o w is split as
// its fragments are loaded), and the warps' fragment loads are plain
// 8-byte loads.  The state tile stays in registers for the whole sequence
// and is read and written once, 16 bytes a thread.
//
// The TPU kernel splits the decay into C exp(cs) and B exp(-cs) over a
// chunk; exp(-cs) leaves float32's range after ~110 tokens at A dt = -0.7.
// Here every expf takes a difference cs_t - cs_s with s <= t, or cs_t
// itself: with A <= 0 and dt >= 0, cs is non-increasing, so every argument
// is <= 0 and every factor lies in [0, 1].  (The block's prefix sum is a
// shuffle scan, whose roundings may leave a neighbour an ulp out of order:
// each argument is clamped to <= 0, which moves nothing but that ulp.  The
// scan keeps cs as a float pair, so that a difference of two prefix sums
// is as exact as the difference.)
//
// Short sequences (shorter than a block: every decode step) take a
// token-step kernel chosen by the same entry point, so a call is one
// launch either way: one CTA of 4 warps per (b, h, tile of 32 rows); each
// thread holds 16-byte pieces of state rows in registers, read once and
// written once, and y[p] = sum_n S[p,n] C[n] is reduced by warp shuffles
// over the N/4 threads of a row.
//
// What bounds it on this card: the chunked kernel's operations are ~7 P N
// per token and head (the products, three tensor-core instructions each
// under 3xTF32), its bytes ~4 (2P + 2N) per token; at zamba2's prefill
// (P = N = 64) both floors are a few microseconds, and the time goes to
// issuing instructions (splits, fragment loads, the products) for one
// block after another.  The token-step kernel is bound by the state's
// bytes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libssd.so ssd.cu       (no --use_fast_math)
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int kRows = 64;            // state rows p per CTA, chunked kernel
constexpr int kWarps = 16;           // chunked kernel
constexpr int kStepRows = 32;        // state rows p per CTA, token-step kernel
constexpr int kStepThreads = 128;    // token-step kernel
// tokens per block of the chunked kernel: 64, or 32 at N = 128 (the tiles
// of B and C and their splits must fit in shared memory)
template <int N>
constexpr int block_len() { return N > 64 ? 32 : 64; }
// row strides (floats), chosen for conflict-free fragment loads: 8-byte
// row pairs want a stride of 8 mod 32, rows read down k want 4 mod 16
constexpr int kLdX = kRows + 4;      // x

// shared-memory layout of the chunked kernel, in floats: the raw tiles of
// the next block (cp.async), the working tiles of this one (x, and every
// operand split into tf32 hi and lo halves), S split, and the block's cs
// and w
template <int N>
struct Layout {
  static constexpr int kB = block_len<N>();
  static constexpr int kLdN = N + 8;                       // B, C, S rows
  static constexpr int kLdC = kLdN > kB + 8 ? kLdN : kB + 8;  // C, then G o L
  static constexpr int kX = kB * kLdX;
  static constexpr int kBm = kB * kLdN;
  static constexpr int kCm = kB * kLdC;
  static constexpr int kS = kRows * kLdN;
  // offsets
  static constexpr int rX = 0, rB = rX + kX, rC = rB + kBm, rDt = rC + kCm;
  static constexpr int wX = rDt + kB, wXh = wX + kX, wXl = wXh + kX;
  static constexpr int wBh = wXl + kX, wBl = wBh + kBm;
  static constexpr int wCh = wBl + kBm, wCl = wCh + kCm;
  static constexpr int wSh = wCl + kCm, wSl = wSh + kS;
  static constexpr int wDt = wSl + kS, wCs = wDt + kB;
  static constexpr int wCsl = wCs + kB, wW = wCsl + kB;       // cs: hi, lo
  static constexpr int kFloats = wW + kB;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
  static_assert(kBytes <= 232448, "shared memory of one CTA");
};

// s += b; returns the rounding error, so that s + error is exactly the sum
// (Knuth's two-sum, six float operations, no fast-math reassociation)
__device__ __forceinline__ float two_sum(float& s, float b) {
  const float a = s;
  s = a + b;
  const float bb = s - a;
  return (a - (s - bb)) + (b - bb);
}

// v -> (hi, lo) stored at the same offset of two tiles
__device__ __forceinline__ void put_split(float* h, float* l, int i, float v) {
  uint32_t hi, lo;
  split(v, hi, lo);
  h[i] = __uint_as_float(hi);
  l[i] = __uint_as_float(lo);
}

// fragments of pre-split tiles (the same offsets into the hi and lo tiles)
__device__ __forceinline__ FragA load_a_hl(const float* h, const float* l,
                                           int ld) {
  FragA f;
  const float2 u = *reinterpret_cast<const float2*>(h);
  const float2 v = *reinterpret_cast<const float2*>(h + 8 * ld);
  const float2 uu = *reinterpret_cast<const float2*>(l);
  const float2 vv = *reinterpret_cast<const float2*>(l + 8 * ld);
  f.hi[0] = __float_as_uint(u.x);
  f.hi[1] = __float_as_uint(v.x);
  f.hi[2] = __float_as_uint(u.y);
  f.hi[3] = __float_as_uint(v.y);
  f.lo[0] = __float_as_uint(uu.x);
  f.lo[1] = __float_as_uint(vv.x);
  f.lo[2] = __float_as_uint(uu.y);
  f.lo[3] = __float_as_uint(vv.y);
  return f;
}

__device__ __forceinline__ FragB load_b_nk_hl(const float* h, const float* l) {
  FragB f;
  const float2 u = *reinterpret_cast<const float2*>(h);
  const float2 uu = *reinterpret_cast<const float2*>(l);
  f.hi[0] = __float_as_uint(u.x);
  f.hi[1] = __float_as_uint(u.y);
  f.lo[0] = __float_as_uint(uu.x);
  f.lo[1] = __float_as_uint(uu.y);
  return f;
}

__device__ __forceinline__ FragB load_b_kn_hl(const float* h, const float* l,
                                              int ld) {
  FragB f;
  f.hi[0] = __float_as_uint(h[0]);
  f.hi[1] = __float_as_uint(h[ld]);
  f.lo[0] = __float_as_uint(l[0]);
  f.lo[1] = __float_as_uint(l[ld]);
  return f;
}

template <int N>
__global__ void __launch_bounds__(kWarps * 32, 1)
ssd_kernel_chunked(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const float* __restrict__ Bm,
                   const float* __restrict__ Cm, const float* __restrict__ D,
                   const float* __restrict__ s0, float* __restrict__ y,
                   float* __restrict__ sf, int H, int G, int T, int P,
                   int vec_x) {
  using L = Layout<N>;
  constexpr int kB = L::kB, kLdN = L::kLdN, kLdC = L::kLdC;
  constexpr int kMT = kB / 16;                      // m16 tiles of tokens
  constexpr int kNG = kMT * (kMT + 1);              // G tiles with s <= t
  constexpr int kNT = N / 8;                        // n8 tiles of the state
  constexpr int kNTW = kNT >= 4 ? kNT / 4 : 1;      // per warp (4 groups)
  constexpr int kMY = kMT / 2;                      // y m16 tiles per warp
  constexpr int kThreads = kWarps * 32;
  extern __shared__ __align__(16) float smem[];
  float* const rx = smem + L::rX;
  float* const rb = smem + L::rB;
  float* const rc = smem + L::rC;
  float* const rdt = smem + L::rDt;
  float* const xs = smem + L::wX;
  float* const xh = smem + L::wXh;
  float* const xl = smem + L::wXl;
  float* const bh_ = smem + L::wBh;
  float* const bl_ = smem + L::wBl;
  float* const ch = smem + L::wCh;
  float* const cl = smem + L::wCl;
  float* const sh = smem + L::wSh;
  float* const sl = smem + L::wSl;
  float* const dts = smem + L::wDt;
  float* const css = smem + L::wCs;
  float* const csl = smem + L::wCsl;
  float* const ws = smem + L::wW;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int ptiles = (P + kRows - 1) / kRows;
  const int64_t bh = blockIdx.x / ptiles;
  const int p0 = (int)(blockIdx.x % ptiles) * kRows;
  const int np = min(kRows, P - p0);
  const int h = (int)(bh % H);
  const int64_t bg = (bh / H) * G + (int64_t)h * G / H;
  const float a = A[h], dd = D[h];
  const float* xb = x + bh * T * P + p0;
  const float* dtb = dt + bh * T;
  const float* Bb = Bm + bg * T * N;
  const float* Cb = Cm + bg * T * N;
  float* yb = y + bh * T * P + p0;

  // start the copies of block blk into the raw tiles (rows past T zeros)
  auto load_block = [&](int blk) {
    const int t0 = blk * kB, cnt = min(kB, T - t0);
    for (int i = tid; i < kB * (N / 4); i += kThreads) {
      const int r = i / (N / 4), c = (i % (N / 4)) * 4;
      const bool ok = r < cnt;
      const int64_t off = ok ? (int64_t)(t0 + r) * N + c : 0;
      cp_async16(rb + r * kLdN + c, Bb + off, ok);
      cp_async16(rc + r * kLdC + c, Cb + off, ok);
    }
    if (vec_x) {
      for (int i = tid; i < kB * (kRows / 4); i += kThreads) {
        const int r = i / (kRows / 4), c = (i % (kRows / 4)) * 4;
        const bool ok = r < cnt && c < np;
        cp_async16(rx + r * kLdX + c,
                   xb + (ok ? (int64_t)(t0 + r) * P + c : 0), ok);
      }
    } else {
      for (int i = tid; i < kB * kRows; i += kThreads) {
        const int r = i / kRows, c = i % kRows;
        const bool ok = r < cnt && c < np;
        cp_async4(rx + r * kLdX + c,
                  xb + (ok ? (int64_t)(t0 + r) * P + c : 0), ok);
      }
    }
    for (int i = tid; i < kB; i += kThreads)
      cp_async4(rdt + i, dtb + (i < cnt ? t0 + i : 0), i < cnt);
  };

  // this warp's state tiles for S += (x o w)^T B: m16 tile mw, n8 tiles
  // nw0 .. nw0 + kNTW - 1 (none when nw0 >= kNT); its fragment offset
  const int mw = warp & 3, nw0 = (warp >> 2) * kNTW;
  const bool s_owner = nw0 < kNT;
  const int o_sacc = (16 * mw + g) * kLdN + 8 * nw0 + 2 * q;
  float sacc[kNTW][4];

  // the state tile, raw, into the hi half; then the owners take it into
  // registers and leave it split
  for (int i = tid; i < kRows * (N / 4); i += kThreads) {
    const int r = i / (N / 4), c = (i % (N / 4)) * 4;
    const bool ok = r < np;
    cp_async16(sh + r * kLdN + c,
               s0 + (ok ? (bh * P + p0 + r) * N + c : 0), ok);
  }
  load_block(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (s_owner) {
#pragma unroll
    for (int j = 0; j < kNTW; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = o_sacc + 8 * j + (e >> 1) * 8 * kLdN + (e & 1);
        sacc[j][e] = sh[o];
        put_split(sh, sl, o, sacc[j][e]);
      }
    }
  }

  // this warp's output tiles of y: n8 tile ny, m16 tiles my[0..kMY) (with
  // kMY = 2, tiles i and 3 - i: the causal product's key steps balanced)
  const int ny = warp & 7;
  int my[kMY];
#pragma unroll
  for (int m = 0; m < kMY; ++m) my[m] = m ? kMT - 1 - (warp >> 3) : warp >> 3;

  const int nblk = (T + kB - 1) / kB;
  for (int blk = 0; blk < nblk; ++blk) {
    const int t0 = blk * kB, cnt = min(kB, T - t0);
    if (blk) {
      cp_async_wait<0>();
      __syncthreads();                // (A) the raw tiles of blk landed
    }
    // the working tiles: x as is and split, B and C split, dt
    for (int i = tid; i < kB * kRows; i += kThreads) {
      const int o = (i / kRows) * kLdX + i % kRows;
      const float v = rx[o];
      xs[o] = v;
      put_split(xh, xl, o, v);
    }
    for (int i = tid; i < kB * N; i += kThreads) {
      const int r = i / N, c = i % N;
      put_split(bh_, bl_, r * kLdN + c, rb[r * kLdN + c]);
      put_split(ch, cl, r * kLdC + c, rc[r * kLdC + c]);
    }
    if (tid < kB) dts[tid] = rdt[tid];
    __syncthreads();                  // (A2) the raw tiles are free
    if (blk + 1 < nblk) {
      load_block(blk + 1);
      cp_async_commit();
    }

    if (warp == 0) {
      // cs as an unevaluated sum hi + lo (each add exact by two_sum): lane
      // l sums its kB / 32 tokens after a shuffle scan of the lanes before
      // it.  A difference cs_t - cs_s is then (hi_t - hi_s) + (lo_t - lo_s),
      // to the rounding of the difference itself, where a plain prefix sum
      // would leave the rounding of |cs| (~1e-5 of the decay at |cs| ~ 100,
      // a prefill of zamba2's).  Then w_s = dt_s exp(cs_end - cs_s).
      constexpr int kPer = kB / 32;
      float v[kPer], hi = 0.0f, lo = 0.0f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        v[j] = a * dts[kPer * lane + j];
        lo += two_sum(hi, v[j]);
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float oh = __shfl_up_sync(0xffffffffu, hi, off);
        const float ol = __shfl_up_sync(0xffffffffu, lo, off);
        if (lane >= off) {
          const float e = two_sum(hi, oh);
          lo += ol + e;
        }
      }
      float ph = __shfl_up_sync(0xffffffffu, hi, 1);
      float pl = __shfl_up_sync(0xffffffffu, lo, 1);
      if (lane == 0) ph = pl = 0.0f;
      float vh[kPer], vl[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        pl += two_sum(ph, v[j]);
        vh[j] = ph;
        vl[j] = pl;
      }
      const float eh = __shfl_sync(0xffffffffu, ph, 31);
      const float el = __shfl_sync(0xffffffffu, pl, 31);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int t = kPer * lane + j;
        css[t] = vh[j];
        csl[t] = vl[j];
        ws[t] = dts[t] * expf(fminf((eh - vh[j]) + (el - vl[j]), 0.0f));
      }
    }

    // G = C B^T on this warp's tiles of the lower triangle
    float gacc[(kNG + kWarps - 1) / kWarps][4] = {};
#pragma unroll
    for (int u = 0; u * kWarps < kNG; ++u) {
      const int idx = warp + kWarps * u;
      if (idx < kNG) {
        int gi = 0;
        while ((gi + 1) * (gi + 2) <= idx) ++gi;
        const int gj = idx - gi * (gi + 1);
        const int oa = (16 * gi + g) * kLdC + 2 * q;
        const int ob = (8 * gj + g) * kLdN + 2 * q;
#pragma unroll
        for (int ks = 0; ks < N / 8; ++ks)
          mma3(gacc[u], load_a_hl(ch + oa + 8 * ks, cl + oa + 8 * ks, kLdC),
               load_b_nk_hl(bh_ + ob + 8 * ks, bl_ + ob + 8 * ks));
      }
    }
    // y = C S^T on this warp's output tiles (scaled by exp(cs_t) below)
    float yacc[kMY][4] = {};
    const int os = (8 * ny + g) * kLdN + 2 * q;
#pragma unroll
    for (int ks = 0; ks < N / 8; ++ks) {
      const FragB fb = load_b_nk_hl(sh + os + 8 * ks, sl + os + 8 * ks);
#pragma unroll
      for (int m = 0; m < kMY; ++m) {
        const int oa = (16 * my[m] + g) * kLdC + 2 * q + 8 * ks;
        mma3(yacc[m], load_a_hl(ch + oa, cl + oa, kLdC), fb);
      }
    }
    __syncthreads();                  // (B) cs, w visible; C consumed

    // G o L, split, in the C tiles' place; y rows scaled by exp(cs_t)
#pragma unroll
    for (int u = 0; u * kWarps < kNG; ++u) {
      const int idx = warp + kWarps * u;
      if (idx < kNG) {
        int gi = 0;
        while ((gi + 1) * (gi + 2) <= idx) ++gi;
        const int gj = idx - gi * (gi + 1);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = 16 * gi + g + (e >> 1) * 8;
          const int s = 8 * gj + 2 * q + (e & 1);
          const float v = s <= t ? gacc[u][e] *
                                       expf(fminf((css[t] - css[s]) +
                                                      (csl[t] - csl[s]),
                                                  0.0f)) *
                                       dts[s]
                                 : 0.0f;
          put_split(ch, cl, t * kLdC + s, v);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kMY; ++m) {
      const int t = 16 * my[m] + g;
      const float e0 = expf(fminf(css[t] + csl[t], 0.0f));
      const float e1 = expf(fminf(css[t + 8] + csl[t + 8], 0.0f));
      yacc[m][0] *= e0;
      yacc[m][1] *= e0;
      yacc[m][2] *= e1;
      yacc[m][3] *= e1;
    }
    __syncthreads();                  // (C) G o L visible

    // y += (G o L) x: m16 tile i needs the keys s < 16 (i + 1)
    const int ox = 2 * q * kLdX + 8 * ny + g;
#pragma unroll
    for (int ks = 0; ks < kB / 8; ++ks) {
      const FragB fb = load_b_kn_hl(xh + ox + 8 * ks * kLdX,
                                    xl + ox + 8 * ks * kLdX, kLdX);
#pragma unroll
      for (int m = 0; m < kMY; ++m) {
        if (ks < 2 * my[m] + 2) {
          const int oa = (16 * my[m] + g) * kLdC + 2 * q + 8 * ks;
          mma3(yacc[m], load_a_hl(ch + oa, cl + oa, kLdC), fb);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kMY; ++m) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 16 * my[m] + g + (e >> 1) * 8;
        const int p = 8 * ny + 2 * q + (e & 1);
        if (t < cnt && p < np)
          yb[(int64_t)(t0 + t) * P + p] = yacc[m][e] + dd * xs[t * kLdX + p];
      }
    }

    // S = exp(cs_end) S + (x o w)^T B, then S split for the next block
    if (s_owner) {
      const float dec = expf(fminf(css[kB - 1] + csl[kB - 1], 0.0f));
#pragma unroll
      for (int j = 0; j < kNTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[j][e] *= dec;
      const int oxw = 2 * q * kLdX + 16 * mw + g;
      const int ob = 2 * q * kLdN + 8 * nw0 + g;
#pragma unroll
      for (int ks = 0; ks < kB / 8; ++ks) {
        const float w0 = ws[8 * ks + 2 * q], w1 = ws[8 * ks + 2 * q + 1];
        const float* px = xs + oxw + 8 * ks * kLdX;
        const FragA fa = frag_a(px[0] * w0, px[8] * w0, px[kLdX] * w1,
                                px[kLdX + 8] * w1);
#pragma unroll
        for (int j = 0; j < kNTW; ++j) {
          const int o = ob + 8 * ks * kLdN + 8 * j;
          mma3(sacc[j], fa, load_b_kn_hl(bh_ + o, bl_ + o, kLdN));
        }
      }
#pragma unroll
      for (int j = 0; j < kNTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          put_split(sh, sl, o_sacc + 8 * j + (e >> 1) * 8 * kLdN + (e & 1),
                    sacc[j][e]);
    }
  }
  // the final state: registers -> shared (raw) -> 16-byte stores
  __syncthreads();
  if (s_owner) {
#pragma unroll
    for (int j = 0; j < kNTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sh[o_sacc + 8 * j + (e >> 1) * 8 * kLdN + (e & 1)] = sacc[j][e];
  }
  __syncthreads();
  for (int i = tid; i < np * (N / 4); i += kThreads) {
    const int r = i / (N / 4), c = (i % (N / 4)) * 4;
    *reinterpret_cast<float4*>(sf + (bh * P + p0 + r) * N + c) =
        *reinterpret_cast<const float4*>(sh + r * kLdN + c);
  }
}

// Token-step kernel (T < block_len<N>()).  Thread slot i = tid +
// kStepThreads * j holds S[row i / (N/4)][4 (i % (N/4)) .. + 3] of the
// CTA's 32 rows.
template <int N>
__global__ void __launch_bounds__(kStepThreads)
ssd_kernel_step(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ D,
                const float* __restrict__ s0, float* __restrict__ y,
                float* __restrict__ sf, int H, int G, int T, int P) {
  constexpr int kLanes = N / 4;                     // threads per row
  constexpr int kSlots = kStepRows * kLanes;
  constexpr int kJ = (kSlots + kStepThreads - 1) / kStepThreads;
  extern __shared__ __align__(16) float smem[];
  float* b_s = smem;                                // T x N
  float* c_s = b_s + T * N;                         // T x N
  float* x_s = c_s + T * N;                         // T x kStepRows
  float* dt_s = x_s + T * kStepRows;                // T

  const int tid = threadIdx.x;
  const int ptiles = (P + kStepRows - 1) / kStepRows;
  const int64_t bh = blockIdx.x / ptiles;
  const int p0 = (int)(blockIdx.x % ptiles) * kStepRows;
  const int np = min(kStepRows, P - p0);
  const int h = (int)(bh % H);
  const int64_t bg = (bh / H) * G + (int64_t)h * G / H;
  const float a = A[h], dd = D[h];

  // the state first: its loads are the bytes that count
  float4 S[kJ];
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int i = tid + kStepThreads * j, r = i / kLanes;
    S[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < kSlots && r < np)
      S[j] = *reinterpret_cast<const float4*>(
          s0 + (bh * P + p0 + r) * N + (i % kLanes) * 4);
  }
  for (int i = tid; i < T * kLanes; i += kStepThreads) {
    const int64_t off = bg * T * N + (int64_t)i * 4;
    *reinterpret_cast<float4*>(b_s + i * 4) =
        *reinterpret_cast<const float4*>(Bm + off);
    *reinterpret_cast<float4*>(c_s + i * 4) =
        *reinterpret_cast<const float4*>(Cm + off);
  }
  for (int i = tid; i < T * kStepRows; i += kStepThreads) {
    const int t = i / kStepRows, c = i % kStepRows;
    x_s[i] = c < np ? x[(bh * T + t) * P + p0 + c] : 0.0f;
  }
  for (int i = tid; i < T; i += kStepThreads) dt_s[i] = dt[bh * T + i];
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float dtt = dt_s[t];
    const float decay = expf(a * dtt);
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int i = tid + kStepThreads * j, r = i / kLanes;
      if (kSlots % kStepThreads && i >= kSlots) break;   // whole warps
      const int n = (i % kLanes) * 4;
      const float xp = x_s[t * kStepRows + r];
      const float dx = dtt * xp;
      const float4 bt = *reinterpret_cast<const float4*>(b_s + t * N + n);
      const float4 ct = *reinterpret_cast<const float4*>(c_s + t * N + n);
      S[j].x = decay * S[j].x + dx * bt.x;
      S[j].y = decay * S[j].y + dx * bt.y;
      S[j].z = decay * S[j].z + dx * bt.z;
      S[j].w = decay * S[j].w + dx * bt.w;
      float acc = S[j].x * ct.x + S[j].y * ct.y + S[j].z * ct.z +
                  S[j].w * ct.w;
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (i % kLanes == 0 && r < np)
        y[(bh * T + t) * P + p0 + r] = acc + dd * xp;
    }
  }

#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int i = tid + kStepThreads * j, r = i / kLanes;
    if (i < kSlots && r < np)
      *reinterpret_cast<float4*>(sf + (bh * P + p0 + r) * N +
                                 (i % kLanes) * 4) = S[j];
  }
}

template <int N>
int launch(const float* x, const float* dt, const float* A, const float* Bm,
           const float* Cm, const float* D, const float* s0, float* y,
           float* sf, int B, int H, int G, int T, int P, cudaStream_t stream) {
  cudaError_t err;
  if (T < block_len<N>()) {
    const int64_t grid = (int64_t)B * H * ((P + kStepRows - 1) / kStepRows);
    if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
    const size_t smem =
        sizeof(float) * (size_t)T * (2 * N + kStepRows + 1);
    err = cudaFuncSetAttribute(ssd_kernel_step<N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    ssd_kernel_step<N><<<(unsigned int)grid, kStepThreads, smem, stream>>>(
        x, dt, A, Bm, Cm, D, s0, y, sf, H, G, T, P);
  } else {
    const int64_t grid = (int64_t)B * H * ((P + kRows - 1) / kRows);
    if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(ssd_kernel_chunked<N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Layout<N>::kBytes);
    if (err != cudaSuccess) return (int)err;
    ssd_kernel_chunked<N><<<(unsigned int)grid, kWarps * 32,
                            Layout<N>::kBytes, stream>>>(
        x, dt, A, Bm, Cm, D, s0, y, sf, H, G, T, P,
        P % 4 == 0 && (uintptr_t)x % 16 == 0);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the launch's CUDA error (0 = success).  N must be one of 8, 16,
// 32, 64, 128, P at most 256, H a multiple of G, and Bm, Cm, s0 and sf
// 16-byte aligned (the wrapper sees to all four first).
int ssd_forward(const float* x, const float* dt, const float* A,
                const float* Bm, const float* Cm, const float* D,
                const float* s0, float* y, float* sf, int32_t B, int32_t H,
                int32_t G, int32_t T, int32_t P, int32_t N, void* stream) {
  if (P < 1 || P > 256 || G < 1 || H % G != 0 || T < 0 ||
      (int64_t)B * H < 1)
    return (int)cudaErrorInvalidValue;
  for (const float* p : {Bm, Cm, s0, (const float*)sf})
    if ((uintptr_t)p % 16) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  switch (N) {
    case 8: return launch<8>(x, dt, A, Bm, Cm, D, s0, y, sf, B, H, G, T, P, s);
    case 16: return launch<16>(x, dt, A, Bm, Cm, D, s0, y, sf, B, H, G, T, P, s);
    case 32: return launch<32>(x, dt, A, Bm, Cm, D, s0, y, sf, B, H, G, T, P, s);
    case 64: return launch<64>(x, dt, A, Bm, Cm, D, s0, y, sf, B, H, G, T, P, s);
    case 128: return launch<128>(x, dt, A, Bm, Cm, D, s0, y, sf, B, H, G, T, P, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* ssd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
