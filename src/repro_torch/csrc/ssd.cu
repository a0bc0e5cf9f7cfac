// Mamba2 SSD (state-space dual) recurrence for Hopper, as a sequential
// scan over the tokens.
//
// Replaces the TPU kernel src/repro/kernels/mamba2_ssd.py::ssd_pallas
// (kernel body _kernel).  For every (batch b, head h), with the head's
// group g = h * G / H:
//
//   S_t = exp(A[h] dt_t) S_{t-1} + dt_t x_t B_t^T    S[p,n] = decay S[p,n] + dt x_t[p] B_t[g,n]
//   y_t = S_t C_t + D[h] x_t                         y_t[p] = sum_n S[p,n] C_t[g,n] + D[h] x_t[p]
//
// with x: (B,H,T,P), dt: (B,H,T), A, D: (H,), Bm, Cm: (B,G,T,N), state:
// (B,H,P,N), all float32 and contiguous; y: (B,H,T,P), the final state:
// (B,H,P,N).  The update comes before the read (the WKV kernel reads
// first).
//
// Design.  One CTA per (b, h), one thread per state row p: the thread
// keeps S[p, :] (N floats) in registers for the whole sequence.  Tokens
// are staged a chunk at a time in shared memory (x_t, dt_t, B_t and C_t of
// TC tokens); every thread reads dt_t, B_t[n] and C_t[n] as broadcasts and
// computes the decay with expf (no fast-math).
//
// Unlike the TPU kernel, which splits the decay into C exp(cs) and
// B exp(-cs) over a chunk (exp(-cs) leaves float32's range after ~110
// tokens at A dt = -0.7), each step here only multiplies the state by a
// decay in (0, 1]: the result is finite wherever the recurrence is.
//
// What bounds it on this card: neither bytes nor operations.  The T steps
// depend on each other, so a call costs about T times one step's latency
// (N dependent multiply-adds per thread, and a shared-memory reload every
// TC tokens); only B*H CTAs of P threads are in flight.  A chunk-parallel
// form on the tensor cores is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libssd.so ssd.cu       (no --use_fast_math)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kSmemFloats = 12288;   // 48 KB of staged tokens at most
constexpr int kMaxChunk = 32;

template <int N>
__global__ void __launch_bounds__(kMaxThreads)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const float* __restrict__ Bm,
           const float* __restrict__ Cm, const float* __restrict__ D,
           const float* __restrict__ s0, float* __restrict__ y,
           float* __restrict__ sf, int H, int G, int T, int P, int TC) {
  extern __shared__ float smem[];
  float* b_s = smem;                 // TC * N
  float* c_s = b_s + TC * N;         // TC * N
  float* x_s = c_s + TC * N;         // TC * P
  float* dt_s = x_s + TC * P;        // TC

  const int64_t bh = blockIdx.x;
  const int64_t b = bh / H;
  const int h = (int)(bh % H);
  const int64_t g = (int64_t)h * G / H;
  const int p = threadIdx.x;         // state row
  const int nt = blockDim.x;
  const float a = A[h];
  const float d = D[h];

  float S[N];
  const float* s_in = s0 + (bh * P + p) * N;
#pragma unroll
  for (int n = 0; n < N; ++n) S[n] = s_in[n];

  const int64_t xrow0 = bh * T;            // token rows of x, dt and y
  const int64_t grow0 = (b * G + g) * T;   // token rows of Bm and Cm
  for (int t0 = 0; t0 < T; t0 += TC) {
    const int cnt = min(TC, T - t0);
    __syncthreads();                 // the previous chunk is consumed
    for (int i = p; i < cnt * N; i += nt) {
      b_s[i] = Bm[(grow0 + t0) * N + i];
      c_s[i] = Cm[(grow0 + t0) * N + i];
    }
    for (int i = p; i < cnt * P; i += nt) x_s[i] = x[(xrow0 + t0) * P + i];
    for (int i = p; i < cnt; i += nt) dt_s[i] = dt[xrow0 + t0 + i];
    __syncthreads();
    for (int tt = 0; tt < cnt; ++tt) {
      const float dtt = dt_s[tt];
      const float decay = expf(a * dtt);
      const float xp = x_s[tt * P + p];
      const float dx = dtt * xp;
      const float* bt = b_s + tt * N;
      const float* ct = c_s + tt * N;
      float acc = 0.0f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        S[n] = decay * S[n] + dx * bt[n];
        acc += S[n] * ct[n];
      }
      y[(xrow0 + t0 + tt) * P + p] = acc + d * xp;
    }
  }

  float* s_out = sf + (bh * P + p) * N;
#pragma unroll
  for (int n = 0; n < N; ++n) s_out[n] = S[n];
}

template <int N>
int launch(const float* x, const float* dt, const float* A, const float* Bm,
           const float* Cm, const float* D, const float* s0, float* y,
           float* sf, int B, int H, int G, int T, int P,
           cudaStream_t stream) {
  int TC = kSmemFloats / (2 * N + P + 1);
  TC = TC < kMaxChunk ? TC : kMaxChunk;
  if (TC < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)(TC * (2 * N + P + 1));
  ssd_kernel<N><<<(unsigned int)((int64_t)B * H), P, smem, stream>>>(
      x, dt, A, Bm, Cm, D, s0, y, sf, H, G, T, P, TC);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the launch's CUDA error (0 = success).  N must be one of 8, 16,
// 32, 64, 128, P at most 256 and H a multiple of G (the wrapper checks
// all three first).
int ssd_forward(const float* x, const float* dt, const float* A,
                const float* Bm, const float* Cm, const float* D,
                const float* s0, float* y, float* sf, int32_t B, int32_t H,
                int32_t G, int32_t T, int32_t P, int32_t N, void* stream) {
  if (P < 1 || P > kMaxThreads || G < 1 || H % G != 0 ||
      (int64_t)B * H < 1)
    return (int)cudaErrorInvalidValue;
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
