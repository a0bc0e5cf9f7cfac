// RWKV6 WKV recurrence for Hopper, chunked, its block products on the
// tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_wkv.py::wkv6_pallas
// (kernel body _kernel).  For every (batch b, head h):
//
//   y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)       y_t[v] = sum_k r_t[k] (S[k,v] + u[k] k_t[k] v_t[v])
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T           S[k,v] = w_t[k] S[k,v] + k_t[k] v_t[v]
//
// with r, k, w: (B,H,T,K), v: (B,H,T,V), u: (H,K), state: (B,H,K,V), all
// float32 and contiguous, r, k, w and the states 16-byte aligned; y:
// (B,H,T,V), the final state: (B,H,K,V).
//
// Chunked design (T >= kBlock).  One CTA of 8 warps per (b, h, tile of
// kVT = 16 value columns v).  The columns of S evolve independently, so
// the tiles split the state without any exchange, and the grid fills the
// card at B = 1 (rwkv6: 64 heads x 4 tiles).  The CTA walks the sequence
// in blocks of kBlock = 16 tokens (the last one shorter, zero-filled),
// with r, k, w and v of the next block in flight through a two-stage
// cp.async ring while this one computes.  Per block, with cs_t[k] the
// inclusive prefix sum of log(max(w, 1e-38)) over the block and cs_{-1} =
// 0 (as ref.wkv6_chunked_ref):
//
//   M[t,s] = sum_k r_t[k] k_s[k] exp(cs_{t-1}[k] - cs_s[k])   s < t
//   M[t,t] = sum_k r_t[k] u[k] k_t[k]                         (the bonus)
//   y      = M v + (r o exp(cs_{t-1})) S
//   S      = diag(exp(cs_end)) S + (k o exp(cs_end - cs_s))^T v
//
// M is not a plain product (its decay depends on k, t and s): two threads
// per (t, s) sum it over half the channels each in float32 FMAs, kBlock^2
// K / 2 exponentials per block, which is why the block is short.  The
// kernel keeps cs in base 2 (log2f, exp2f: the same factors to float
// rounding, each a few instructions cheaper than logf and expf).  The logs,
// the prefix sums (one thread per channel) and the decayed r and k are
// each spread over the CTA, a barrier apart.  The three products of the
// last two lines run on the tensor cores as mma.sync m16n8k8 TF32 under
// the 3xTF32 split (tf32x3.cuh), which keeps float32 accuracy: warps 0-1
// take y, warps 2-7 the state.  The state tile stays in registers (and a copy
// in shared memory for the y product) for the whole sequence and is read
// and written once.
//
// The TPU kernel splits the decay into r exp(cs_prev) and k exp(-cs) over a
// chunk; exp(-cs) leaves float32's range after ~90 tokens of decay e^-1.
// Here every exponential (exp2f) takes cs_{t-1} - cs_s with s <= t - 1,
// cs_end - cs_s, cs_{t-1} or cs_end: with decays w in (0, 1], cs is
// non-increasing in t (a serial sum of non-positive terms, and float
// rounding is monotone), so every argument is <= 0 and every factor lies
// in [0, 1].
//
// Short sequences (T < kBlock = 16: every decode step) take a token-step
// kernel chosen by the same entry point, so a call is one launch either
// way: one CTA of 128 threads per (b, h, tile of 16 columns), thread (v,
// k0) holding S[k0 + 8j, v] in registers, read once and written once by
// rows of 64 contiguous bytes; y is reduced over k by a shuffle and shared
// memory.
//
// What bounds it on this card: neither its bytes (~4 (3K + 2V) per token
// and head) nor its operations.  The chunked kernel's time goes to the
// pairwise scores (their shared-memory reads and exponentials, recomputed
// by each column tile of a head) and to the y product's chain of
// tensor-core instructions, block after block, a barrier between phases.
// The token-step kernel is bound by the state's bytes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libwkv6.so wkv6.cu     (no --use_fast_math)
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int kBlock = 16;           // tokens per block of the chunked kernel
constexpr int kVT = 16;              // value columns per CTA
constexpr int kThreads = 256;        // chunked kernel
constexpr int kStepThreads = 128;    // token-step kernel
// row strides (floats), chosen for conflict-free fragment loads: 8-byte
// row pairs want a stride of 8 mod 32, rows read down k want 4 mod 16
constexpr int kLdV = kVT + 4;        // v and S
constexpr int kLdM = kBlock + 8;     // M
constexpr int kPairs = kBlock * (kBlock - 1) / 2;
static_assert(kBlock == 16 && kVT == 16 && 2 * kPairs + kBlock == kThreads,
              "one m16 tile of tokens, two n8 tiles of columns, two threads "
              "per score and one per bonus");

// shared-memory layout of the chunked kernel, in floats
template <int K>
struct Layout {
  static constexpr int kKP = K < 16 ? 16 : K;   // S rows, padded to m16
  static constexpr int kLdK = K + 8;            // r, k, w, cs, r o exp rows
  static constexpr int kLdKd = kKP + 4;         // k o exp rows (read down k)
  static constexpr int kIn = kBlock * kLdK;     // one of r, k, w
  static constexpr int kStage = 3 * kIn + kBlock * kLdV;
  static constexpr int kCs = (kBlock + 1) * kLdK;
  static constexpr int kFloats = 2 * kStage + kCs + kIn + kBlock * kLdKd +
                                 kBlock * kLdM + kKP * kLdV + kKP + K;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

template <int K>
__global__ void __launch_bounds__(kThreads, 2)
wkv6_kernel_chunked(const float* __restrict__ r, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ u, const float* __restrict__ s0,
                    float* __restrict__ y, float* __restrict__ sf, int H,
                    int T, int V, int vec_v) {
  using L = Layout<K>;
  constexpr int kKP = L::kKP, kLdK = L::kLdK, kLdKd = L::kLdKd;
  constexpr int kMT = (kKP / 16 + 5) / 6;       // S m16 tiles per warp 2..7
  extern __shared__ __align__(16) float smem[];
  float* cs_s = smem + 2 * L::kStage;           // row t + 1: cs_t; row 0: 0
  float* rd_s = cs_s + L::kCs;                  // r_t o exp(cs_{t-1})
  float* kd_s = rd_s + L::kIn;                  // k_s o exp(cs_end - cs_s)
  float* m_s = kd_s + kBlock * kLdKd;           // M with the bonus diagonal
  float* s_s = m_s + kBlock * kLdM;             // S tile (kKP x kVT)
  float* dec_s = s_s + kKP * kLdV;              // exp(cs_end)
  float* u_s = dec_s + kKP;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int vtiles = (V + kVT - 1) / kVT;
  const int64_t bh = blockIdx.x / vtiles;
  const int v0 = (int)(blockIdx.x % vtiles) * kVT;
  const int nv = min(kVT, V - v0);
  const int h = (int)(bh % H);
  const float* rb = r + bh * T * K;
  const float* kb = k + bh * T * K;
  const float* wb = w + bh * T * K;
  const float* vb = v + bh * T * V + v0;

  auto stage_ptr = [&](int st) { return smem + st * L::kStage; };
  // start the copies of block blk into stage st (rows past T are zeros)
  auto load_block = [&](int blk, int st) {
    float* sr = stage_ptr(st);
    float* sk = sr + L::kIn;
    float* sw = sk + L::kIn;
    float* sv = sw + L::kIn;
    const int t0 = blk * kBlock, cnt = min(kBlock, T - t0);
    for (int i = tid; i < kBlock * (K / 4); i += kThreads) {
      const int row = i / (K / 4), c = (i % (K / 4)) * 4;
      const bool ok = row < cnt;
      const int64_t off = ok ? (int64_t)(t0 + row) * K + c : 0;
      cp_async16(sr + row * kLdK + c, rb + off, ok);
      cp_async16(sk + row * kLdK + c, kb + off, ok);
      cp_async16(sw + row * kLdK + c, wb + off, ok);
    }
    if (vec_v) {
      for (int i = tid; i < kBlock * (kVT / 4); i += kThreads) {
        const int row = i / (kVT / 4), c = (i % (kVT / 4)) * 4;
        const bool ok = row < cnt && c < nv;
        cp_async16(sv + row * kLdV + c,
                   vb + (ok ? (int64_t)(t0 + row) * V + c : 0), ok);
      }
    } else {
      for (int i = tid; i < kBlock * kVT; i += kThreads) {
        const int row = i / kVT, c = i % kVT;
        const bool ok = row < cnt && c < nv;
        cp_async4(sv + row * kLdV + c,
                  vb + (ok ? (int64_t)(t0 + row) * V + c : 0), ok);
      }
    }
  };

  // the state tile (rows past K and columns past V are zeros), with block
  // 0's inputs
  for (int i = tid; i < kKP * kVT; i += kThreads) {
    const int row = i / kVT, c = i % kVT;
    const bool ok = row < K && c < nv;
    const float* src = s0 + (ok ? (bh * K + row) * V + v0 + c : 0);
    if (!vec_v)
      cp_async4(s_s + row * kLdV + c, src, ok);
    else if (c % 4 == 0)
      cp_async16(s_s + row * kLdV + c, src, ok);
  }
  load_block(0, 0);
  cp_async_commit();
  for (int i = tid; i < K; i += kThreads) u_s[i] = u[(int64_t)h * K + i];
  for (int i = tid; i < kKP; i += kThreads) dec_s[i] = 0.0f;
  for (int i = tid; i < kLdK; i += kThreads) cs_s[i] = 0.0f;
  for (int i = tid; i < kBlock * kLdM; i += kThreads) m_s[i] = 0.0f;
  for (int i = tid; i < kBlock * kLdKd; i += kThreads) kd_s[i] = 0.0f;

  // this thread's score: half `half` of the channels of pair (pt, ps),
  // ps < pt; threads 2 kPairs .. + 15: the bonus of token tid - 2 kPairs
  const int pair = tid >> 1, half = tid & 1;
  int pt = 1;
  while (pt * (pt + 1) / 2 <= pair) ++pt;
  const int ps = pair - pt * (pt - 1) / 2;

  // warps 2..7: their state tiles, m16 tiles mi = warp - 2 + 6j
  float sacc[kMT][2][4];
  const int o_s = (16 * (warp - 2) + g) * kLdV + 2 * q;

  const int nblk = (T + kBlock - 1) / kBlock;
  for (int blk = 0; blk < nblk; ++blk) {
    const int st = blk & 1;
    if (blk + 1 < nblk) load_block(blk + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                                        // (A)
    const float* sr = stage_ptr(st);
    const float* sk = sr + L::kIn;
    const float* sw = sk + L::kIn;
    const float* sv = sw + L::kIn;
    const int t0 = blk * kBlock, cnt = min(kBlock, T - t0);

    if (blk == 0 && warp >= 2) {
#pragma unroll
      for (int j = 0; j < kMT; ++j) {
        if (warp - 2 + 6 * j < kKP / 16) {
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const float* p = s_s + o_s + 96 * j * kLdV + 8 * n;
            sacc[j][n][0] = p[0];
            sacc[j][n][1] = p[1];
            sacc[j][n][2] = p[8 * kLdV];
            sacc[j][n][3] = p[8 * kLdV + 1];
          }
        }
      }
    }
    // log w of every (token, channel); padded tokens decay by 1
    for (int i = tid; i < kBlock * K; i += kThreads) {
      const int t = i / K, c = i % K;
      cs_s[(t + 1) * kLdK + c] =
          t < cnt ? log2f(fmaxf(sw[t * kLdK + c], 1e-38f)) : 0.0f;
    }
    __syncthreads();                                        // (B1)
    // their prefix sums over the block, one thread per channel
    for (int c = tid; c < K; c += kThreads) {
      float cs[kBlock];
#pragma unroll
      for (int t = 0; t < kBlock; ++t) cs[t] = cs_s[(t + 1) * kLdK + c];
#pragma unroll
      for (int t = 1; t < kBlock; ++t) cs[t] += cs[t - 1];
#pragma unroll
      for (int t = 1; t < kBlock; ++t) cs_s[(t + 1) * kLdK + c] = cs[t];
      dec_s[c] = exp2f(cs[kBlock - 1]);
    }
    __syncthreads();                                        // (B2)

    // the decayed r and k of every (token, channel)
    for (int i = tid; i < kBlock * K; i += kThreads) {
      const int t = i / K, c = i % K;
      const float cend = cs_s[kBlock * kLdK + c];
      const float ct = cs_s[(t + 1) * kLdK + c];
      rd_s[t * kLdK + c] = sr[t * kLdK + c] * exp2f(cs_s[t * kLdK + c]);
      kd_s[t * kLdKd + c] = sk[t * kLdK + c] * exp2f(cend - ct);
    }
    // M: threads 0 .. 2 kPairs - 1 half a score each (all 256 threads reach
    // the shuffle that adds the halves), the last kBlock the bonuses
    float acc = 0.0f;
    if (tid < 2 * kPairs) {
      // M[pt, ps] = sum_k r_pt k_ps exp(cs_{pt-1} - cs_ps), half the k here
      const int c0 = half * (K / 2);
      const float* rt = sr + pt * kLdK + c0;
      const float* ks = sk + ps * kLdK + c0;
      const float* ct = cs_s + pt * kLdK + c0;
      const float* cs = cs_s + (ps + 1) * kLdK + c0;
      float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll 4
      for (int c = 0; c < K / 2; c += 4) {
        const float4 a = *reinterpret_cast<const float4*>(rt + c);
        const float4 b = *reinterpret_cast<const float4*>(ks + c);
        const float4 e = *reinterpret_cast<const float4*>(ct + c);
        const float4 f = *reinterpret_cast<const float4*>(cs + c);
        acc0 += a.x * b.x * exp2f(e.x - f.x);
        acc1 += a.y * b.y * exp2f(e.y - f.y);
        acc0 += a.z * b.z * exp2f(e.z - f.z);
        acc1 += a.w * b.w * exp2f(e.w - f.w);
      }
      acc = acc0 + acc1;
    } else {
      // the bonus: M[t, t] = sum_k r_t u k_t
      const int t = tid - 2 * kPairs;
      const float* rt = sr + t * kLdK;
      const float* kt = sk + t * kLdK;
      float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll 4
      for (int c = 0; c < K; c += 4) {
        const float4 a = *reinterpret_cast<const float4*>(rt + c);
        const float4 b = *reinterpret_cast<const float4*>(kt + c);
        const float4 e = *reinterpret_cast<const float4*>(u_s + c);
        acc0 += a.x * e.x * b.x;
        acc1 += a.y * e.y * b.y;
        acc0 += a.z * e.z * b.z;
        acc1 += a.w * e.w * b.w;
      }
      acc = acc0 + acc1;
    }
    const float other = __shfl_xor_sync(0xffffffffu, acc, 1);
    if (tid < 2 * kPairs) {
      if (half == 0) m_s[pt * kLdM + ps] = acc + other;
    } else {
      const int t = tid - 2 * kPairs;
      m_s[t * kLdM + t] = acc;
    }
    __syncthreads();                                        // (C)

    if (warp < 2) {
      // y = M v + (r o exp(cs_{t-1})) S on the n8 tile `warp`, two chains
      float y0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, y1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const int o_v = 2 * q * kLdV + 8 * warp + g;
#pragma unroll
      for (int ks = 0; ks < kBlock / 8; ++ks)
        mma3(y0, load_a(m_s + g * kLdM + 8 * ks + 2 * q, kLdM),
             load_b_kn(sv + o_v + 8 * ks * kLdV, kLdV));
#pragma unroll
      for (int ks = 0; ks < K / 8; ++ks)
        mma3(ks & 1 ? y1 : y0,
             load_a(rd_s + g * kLdK + 8 * ks + 2 * q, kLdK),
             load_b_kn(s_s + o_v + 8 * ks * kLdV, kLdV));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = g + (e >> 1) * 8, c = 8 * warp + 2 * q + (e & 1);
        if (t < cnt && c < nv)
          y[(bh * T + t0 + t) * V + v0 + c] = y0[e] + y1[e];
      }
    } else {
      // S = diag(exp(cs_end)) S + (k o exp(cs_end - cs_s))^T v
#pragma unroll
      for (int j = 0; j < kMT; ++j) {
        const int mi = warp - 2 + 6 * j;
        if (mi < kKP / 16) {
          const float d0 = dec_s[16 * mi + g], d1 = dec_s[16 * mi + g + 8];
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            sacc[j][n][0] *= d0;
            sacc[j][n][1] *= d0;
            sacc[j][n][2] *= d1;
            sacc[j][n][3] *= d1;
          }
#pragma unroll
          for (int ks = 0; ks < kBlock / 8; ++ks) {
            const float* p = kd_s + (8 * ks + 2 * q) * kLdKd + 16 * mi + g;
            const FragA fa = frag_a(p[0], p[8], p[kLdKd], p[kLdKd + 8]);
#pragma unroll
            for (int n = 0; n < 2; ++n)
              mma3(sacc[j][n], fa,
                   load_b_kn(sv + (8 * ks + 2 * q) * kLdV + 8 * n + g, kLdV));
          }
        }
      }
    }
    __syncthreads();                  // (D) S, the stage and the scores read
    if (warp >= 2) {
#pragma unroll
      for (int j = 0; j < kMT; ++j) {
        if (warp - 2 + 6 * j < kKP / 16) {
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            float* p = s_s + o_s + 96 * j * kLdV + 8 * n;
            *reinterpret_cast<float2*>(p) =
                make_float2(sacc[j][n][0], sacc[j][n][1]);
            *reinterpret_cast<float2*>(p + 8 * kLdV) =
                make_float2(sacc[j][n][2], sacc[j][n][3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < K * kVT; i += kThreads) {
    const int row = i / kVT, c = i % kVT;
    if (c < nv) sf[(bh * K + row) * V + v0 + c] = s_s[row * kLdV + c];
  }
}

// Token-step kernel (T < kBlock).  Thread (c = tid % 16, k0 = tid / 16)
// holds S[k0 + 8j, v0 + c] for j < K / 8.
template <int K>
__global__ void __launch_bounds__(kStepThreads)
wkv6_kernel_step(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 float* __restrict__ y, float* __restrict__ sf, int H, int T,
                 int V) {
  constexpr int kJ = K / 8;
  extern __shared__ __align__(16) float smem[];
  float* r_s = smem;                                // T x K
  float* k_s = r_s + T * K;
  float* w_s = k_s + T * K;
  float* v_s = w_s + T * K;                         // T x kVT
  float* u_s = v_s + T * kVT;                       // K
  float* red = u_s + K;                             // 2 x 4 warps x kVT

  const int tid = threadIdx.x, warp = tid >> 5;
  const int c = tid % kVT, k0 = tid / kVT;
  const int vtiles = (V + kVT - 1) / kVT;
  const int64_t bh = blockIdx.x / vtiles;
  const int v0 = (int)(blockIdx.x % vtiles) * kVT;
  const int nv = min(kVT, V - v0);
  const int h = (int)(bh % H);

  // the state first: its loads are the bytes that count
  float S[kJ];
#pragma unroll
  for (int j = 0; j < kJ; ++j)
    S[j] = c < nv ? s0[(bh * K + k0 + 8 * j) * V + v0 + c] : 0.0f;
  for (int i = tid; i < T * K / 4; i += kStepThreads) {
    const int64_t off = bh * T * K + (int64_t)i * 4;
    *reinterpret_cast<float4*>(r_s + 4 * i) =
        *reinterpret_cast<const float4*>(r + off);
    *reinterpret_cast<float4*>(k_s + 4 * i) =
        *reinterpret_cast<const float4*>(k + off);
    *reinterpret_cast<float4*>(w_s + 4 * i) =
        *reinterpret_cast<const float4*>(w + off);
  }
  for (int i = tid; i < T * kVT; i += kStepThreads) {
    const int t = i / kVT, cc = i % kVT;
    v_s[i] = cc < nv ? v[(bh * T + t) * V + v0 + cc] : 0.0f;
  }
  for (int i = tid; i < K; i += kStepThreads) u_s[i] = u[(int64_t)h * K + i];
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float vv = v_s[t * kVT + c];
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int kk = t * K + k0 + 8 * j;
      const float kv = k_s[kk] * vv;
      acc += r_s[kk] * (S[j] + u_s[k0 + 8 * j] * kv);
      S[j] = w_s[kk] * S[j] + kv;
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 16);
    float* rb = red + (t & 1) * 4 * kVT;
    if ((tid & 31) < kVT) rb[warp * kVT + c] = acc;
    __syncthreads();
    if (tid < nv)
      y[(bh * T + t) * V + v0 + tid] =
          rb[tid] + rb[kVT + tid] + rb[2 * kVT + tid] + rb[3 * kVT + tid];
  }

#pragma unroll
  for (int j = 0; j < kJ; ++j)
    if (c < nv) sf[(bh * K + k0 + 8 * j) * V + v0 + c] = S[j];
}

template <int K>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* y, float* sf, int B,
           int H, int T, int V, cudaStream_t stream) {
  const int vtiles = (V + kVT - 1) / kVT;
  const int64_t grid = (int64_t)B * H * vtiles;
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (T < kBlock) {
    const size_t smem =
        sizeof(float) * ((size_t)T * (3 * K + kVT) + K + 8 * kVT);
    wkv6_kernel_step<K><<<(unsigned int)grid, kStepThreads, smem, stream>>>(
        r, k, v, w, u, s0, y, sf, H, T, V);
  } else {
    err = cudaFuncSetAttribute(wkv6_kernel_chunked<K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Layout<K>::kBytes);
    if (err != cudaSuccess) return (int)err;
    wkv6_kernel_chunked<K><<<(unsigned int)grid, kThreads, Layout<K>::kBytes,
                             stream>>>(
        r, k, v, w, u, s0, y, sf, H, T, V,
        V % 4 == 0 && (uintptr_t)v % 16 == 0);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the launch's CUDA error (0 = success).  K must be one of 8, 16,
// 32, 64, 128, V at most 256, and r, k, w, s0 and sf 16-byte aligned (the
// wrapper sees to all of them first).
int wkv6_forward(const float* r, const float* k, const float* v,
                 const float* w, const float* u, const float* s0, float* y,
                 float* sf, int32_t B, int32_t H, int32_t T, int32_t K,
                 int32_t V, void* stream) {
  if (V < 1 || V > 256 || T < 0 || (int64_t)B * H < 1)
    return (int)cudaErrorInvalidValue;
  for (const float* p : {r, k, w, s0, (const float*)sf})
    if ((uintptr_t)p % 16) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  switch (K) {
    case 8: return launch<8>(r, k, v, w, u, s0, y, sf, B, H, T, V, s);
    case 16: return launch<16>(r, k, v, w, u, s0, y, sf, B, H, T, V, s);
    case 32: return launch<32>(r, k, v, w, u, s0, y, sf, B, H, T, V, s);
    case 64: return launch<64>(r, k, v, w, u, s0, y, sf, B, H, T, V, s);
    case 128: return launch<128>(r, k, v, w, u, s0, y, sf, B, H, T, V, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* wkv6_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
