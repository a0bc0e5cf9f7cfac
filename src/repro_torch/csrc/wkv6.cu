// RWKV6 WKV recurrence for Hopper, as a sequential scan over the tokens.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_wkv.py::wkv6_pallas
// (kernel body _kernel).  For every (batch b, head h):
//
//   y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)       y_t[v] = sum_k r_t[k] (S[k,v] + u[k] k_t[k] v_t[v])
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T           S[k,v] = w_t[k] S[k,v] + k_t[k] v_t[v]
//
// with r, k, w: (B,H,T,K), v: (B,H,T,V), u: (H,K), state: (B,H,K,V), all
// float32 and contiguous; y: (B,H,T,V), the final state: (B,H,K,V).
//
// Design.  One CTA per (b, h), one thread per value column v: the thread
// keeps S[:, v] (K floats) in registers for the whole sequence, so the
// state is read once and written once.  Tokens are staged a chunk at a
// time in shared memory (r_t, k_t, w_t and v_t of TC tokens, loaded by the
// whole CTA with neighbouring threads on neighbouring addresses); every
// thread then reads r_t[k], k_t[k], w_t[k] as broadcasts.
//
// Unlike the TPU kernel, which splits the decay into r exp(cs_prev) and
// k exp(-cs) over a chunk (exp(-cs) leaves float32's range after ~90
// tokens of decay e^-1), each step here only multiplies the state by a
// decay in (0, 1]: the result is finite wherever the recurrence is.
//
// What bounds it on this card: neither bytes nor operations.  The T steps
// depend on each other, so a call costs about T times one step's latency
// (K dependent multiply-adds per thread, and a shared-memory reload every
// TC tokens); only B*H CTAs of V threads are in flight.  A chunk-parallel
// form on the tensor cores is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libwkv6.so wkv6.cu     (no --use_fast_math)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kSmemFloats = 12288;   // 48 KB of staged tokens at most
constexpr int kMaxChunk = 32;

template <int K>
__global__ void __launch_bounds__(kMaxThreads)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ sf,
            int H, int T, int V, int TC) {
  extern __shared__ float smem[];
  float* u_s = smem;                 // K
  float* r_s = u_s + K;              // TC * K
  float* k_s = r_s + TC * K;         // TC * K
  float* w_s = k_s + TC * K;         // TC * K
  float* v_s = w_s + TC * K;         // TC * V

  const int64_t bh = blockIdx.x;
  const int h = (int)(bh % H);
  const int j = threadIdx.x;         // value column
  const int nt = blockDim.x;

  for (int i = j; i < K; i += nt) u_s[i] = u[(int64_t)h * K + i];

  float S[K];
  const float* s_in = s0 + bh * K * V;
#pragma unroll
  for (int kk = 0; kk < K; ++kk) S[kk] = s_in[(int64_t)kk * V + j];

  const int64_t tok0 = bh * T;       // first token row of this (b, h)
  for (int t0 = 0; t0 < T; t0 += TC) {
    const int n = min(TC, T - t0);
    __syncthreads();                 // the previous chunk is consumed
    const int64_t rows = tok0 + t0;
    for (int i = j; i < n * K; i += nt) {
      r_s[i] = r[rows * K + i];
      k_s[i] = k[rows * K + i];
      w_s[i] = w[rows * K + i];
    }
    for (int i = j; i < n * V; i += nt) v_s[i] = v[rows * V + i];
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vv = v_s[tt * V + j];
      const float* rt = r_s + tt * K;
      const float* kt = k_s + tt * K;
      const float* wt = w_s + tt * K;
      float acc = 0.0f;
#pragma unroll
      for (int kk = 0; kk < K; ++kk) {
        const float kv = kt[kk] * vv;
        acc += rt[kk] * (S[kk] + u_s[kk] * kv);
        S[kk] = wt[kk] * S[kk] + kv;
      }
      y[(rows + tt) * V + j] = acc;
    }
  }

  float* s_out = sf + bh * K * V;
#pragma unroll
  for (int kk = 0; kk < K; ++kk) s_out[(int64_t)kk * V + j] = S[kk];
}

template <int K>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* y, float* sf, int B,
           int H, int T, int V, cudaStream_t stream) {
  int TC = (kSmemFloats - K) / (3 * K + V);
  TC = TC < kMaxChunk ? TC : kMaxChunk;
  if (TC < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)(K + TC * (3 * K + V));
  wkv6_kernel<K><<<(unsigned int)((int64_t)B * H), V, smem, stream>>>(
      r, k, v, w, u, s0, y, sf, H, T, V, TC);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the launch's CUDA error (0 = success).  K must be one of 8, 16,
// 32, 64, 128 and V at most 256 (the wrapper checks both first).
int wkv6_forward(const float* r, const float* k, const float* v,
                 const float* w, const float* u, const float* s0, float* y,
                 float* sf, int32_t B, int32_t H, int32_t T, int32_t K,
                 int32_t V, void* stream) {
  if (V < 1 || V > kMaxThreads || (int64_t)B * H < 1)
    return (int)cudaErrorInvalidValue;
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
