// Blocked flash attention (forward) for Hopper: causal, sliding-window and
// GQA attention from position 0, with an online softmax over KV tiles.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_pallas (kernel body _kernel).  For every batch b, query
// head h (reading KV head g = h*KV/H) and query row t:
//
//   s[t, j] = (q_t . k_j) * hd^-0.5,  masked to -1e30 unless
//             (!causal || t >= j) && (window == 0 || t - j < window)
//   o_t     = sum_j softmax_j(s[t, :]) v_j
//
// computed as the TPU kernel does: q, k, v read as float32, one KV tile at
// a time with the state (m, l, acc) in float32, m_new = max(m, max_j s),
// p = exp(s - m_new), corr = exp(m - m_new), l = l*corr + sum p,
// acc = acc*corr + p v, and at the end o = acc / max(l, 1e-30), written in
// the inputs' dtype (float32 or bf16, round to nearest even).
//
// Layout: q (B,T,H,hd), k and v (B,S,KV,hd), each read through its four
// element strides (no transposes on the host); o (B,T,H,hd) contiguous.
// hd is a multiple of 8 up to 128; T and S are any lengths (the ragged
// edges are masked here, where the TPU kernel asserts T % block_q == 0).
//
// Design.  One CTA of 256 threads per (query tile of 64 rows, head,
// batch): four neighbouring threads own one query row.  The Q tile and one
// K and one V tile of 64 keys at a time are staged in shared memory as
// float32, rows padded to hd+1 floats so that the four threads of a row,
// and the eight rows of a warp, fall in distinct banks.  Each thread
// computes 16 of its row's 64 scores (keys sub, sub+4, ...), the row's max
// and sum come from two warp shuffles, the probabilities go through a
// shared 64x65 tile, and each thread accumulates hd/4 output columns
// (sub, sub+4, ...) in registers.  KV tiles that lie wholly past the
// causal diagonal or wholly before the window of every row of the CTA are
// skipped: they would add exp(-1e30 - m) = 0 to every row that has a key
// (the wrapper refuses inputs with a row that has none).  Keys past S
// score -inf and add exactly 0.  IEEE expf and division (no fast-math).
//
// What bounds it on this card.  The least time for the work is set by
// bytes (q, k, v read once and o written once over 3.35 TB/s, ~0.5-1.4 us
// at the served prefill shapes); its 4*hd operations per unmasked (query,
// key) pair would take far less on the tensor cores.  This kernel is held
// back by neither: it runs B*H*ceil(T/64) CTAs (32 to 192 at the served
// shapes, on 132 SMs), one per SM for its ~116 KB of shared memory at
// hd=128, and each thread does its tiles' float32 products serially on
// the CUDA cores.  mma/wgmma tiles, TMA loads, more CTAs per SM and
// pipelining are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;           // query rows per CTA
constexpr int kBKV = 64;          // keys per tile
constexpr int kThreads = 256;     // 4 per query row
constexpr int kCols = kBKV / 4;   // scores per thread per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Strides {
  int64_t b, t, h, d;
};

// Stage rows [row0, row0 + 64) of head `head` of x (rows past n read as 0)
// into s (64 rows of ld floats).
template <typename T>
__device__ void stage(float* s, const T* __restrict__ x, Strides st, int b,
                      int head, int row0, int n, int hd, int ld) {
  for (int i = threadIdx.x; i < kBQ * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd, t = row0 + r;
    s[r * ld + d] = t < n ? load(x + b * st.b + (int64_t)t * st.t +
                                 head * st.h + d * st.d)
                          : 0.0f;
  }
}

template <typename T, int HDMAX>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int nT,
                       int S, int H, int KV, int hd, Strides sq, Strides sk,
                       Strides sv, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* qs = smem;                  // kBQ x ld
  float* ks = qs + kBQ * ld;         // kBKV x ld
  float* vs = ks + kBKV * ld;        // kBKV x ld
  float* ps = vs + kBKV * ld;        // kBQ x (kBKV + 1)

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = (int)((int64_t)h * KV / H);
  const int row = threadIdx.x >> 2;
  const int sub = threadIdx.x & 3;
  const int qpos = q0 + row;

  stage(qs, q, sq, b, h, q0, nT, hd, ld);

  // the KV tiles some row of this CTA may attend to
  const int q_last = min(q0 + kBQ, nT) - 1;
  const int kv_end = causal ? min(S, q_last + 1) : S;
  int kv_begin = 0;
  if (window > 0 && q0 - window + 1 > 0)
    kv_begin = ((q0 - window + 1) / kBKV) * kBKV;

  float m = kNegInf, l = 0.0f;
  float acc[HDMAX / 4];
#pragma unroll
  for (int i = 0; i < HDMAX / 4; ++i) acc[i] = 0.0f;

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += kBKV) {
    __syncthreads();                 // the previous tiles are consumed
    stage(ks, k, sk, b, g, kv0, S, hd, ld);
    stage(vs, v, sv, b, g, kv0, S, hd, ld);
    __syncthreads();

    float s[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[j] = 0.0f;
    const float* qrow = qs + row * ld;
    for (int d = 0; d < hd; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[j] += qd * ks[(sub + 4 * j) * ld + d];
    }
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int kpos = kv0 + sub + 4 * j;
      bool ok = (!causal || qpos >= kpos) &&
                (window <= 0 || qpos - kpos < window);
      s[j] = kpos >= S ? -INFINITY : (ok ? s[j] * scale : kNegInf);
      mt = fmaxf(mt, s[j]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);
    float psum = 0.0f;
    float* prow = ps + row * (kBKV + 1);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
      prow[sub + 4 * j] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float corr = expf(m - m_new);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();                    // a row's probabilities are written
#pragma unroll
    for (int i = 0; i < HDMAX / 4; ++i) acc[i] *= corr;
    const int nk = min(kBKV, S - kv0);
    for (int c = 0; c < nk; ++c) {
      const float p = prow[c];
      const float* vrow = vs + c * ld;
#pragma unroll
      for (int i = 0; i < HDMAX / 4; ++i) {
        const int d = sub + 4 * i;
        if (d < hd) acc[i] += p * vrow[d];
      }
    }
  }

  if (qpos < nT) {
    const float den = fmaxf(l, 1e-30f);
    T* out = o + (((int64_t)b * nT + qpos) * H + h) * hd;
#pragma unroll
    for (int i = 0; i < HDMAX / 4; ++i) {
      const int d = sub + 4 * i;
      if (d < hd) store(out + d, acc[i] / den);
    }
  }
}

size_t smem_bytes(int hd) {
  return sizeof(float) *
         ((size_t)(kBQ + 2 * kBKV) * (hd + 1) + (size_t)kBQ * (kBKV + 1));
}

template <typename T, int HDMAX>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int nT, int S, int H, int KV, int hd, Strides sq, Strides sk,
           Strides sv, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, HDMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((nT + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  flash_attention_kernel<T, HDMAX><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, nT, S, H, KV, hd, sq,
      sk, sv, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o, int B,
                int nT, int S, int H, int KV, int hd, Strides sq, Strides sk,
                Strides sv, int causal, int window, float scale,
                cudaStream_t stream) {
  if (hd <= 32)
    return launch<T, 32>(q, k, v, o, B, nT, S, H, KV, hd, sq, sk, sv, causal,
                         window, scale, stream);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, B, nT, S, H, KV, hd, sq, sk, sv, causal,
                         window, scale, stream);
  return launch<T, 128>(q, k, v, o, B, nT, S, H, KV, hd, sq, sk, sv, causal,
                        window, scale, stream);
}

}  // namespace

extern "C" {

// Returns the launch's CUDA error (0 = success).  dtype: 0 = float32,
// 1 = bfloat16 (q, k, v and o alike).  Strides are in elements.  The
// wrapper checks every argument first; this re-checks what would make the
// launch unsafe.
int flash_attention_forward(const void* q, const void* k, const void* v,
                            void* o, int32_t B, int32_t nT, int32_t S,
                            int32_t H, int32_t KV, int32_t hd,
                            int64_t sqb, int64_t sqt, int64_t sqh,
                            int64_t sqd, int64_t skb, int64_t skt,
                            int64_t skh, int64_t skd, int64_t svb,
                            int64_t svt, int64_t svh, int64_t svd,
                            int32_t causal, int32_t window, float scale,
                            int32_t dtype, void* stream) {
  if (B < 1 || nT < 1 || S < 1 || H < 1 || KV < 1 || H % KV != 0 ||
      hd < 8 || hd > 128 || hd % 8 != 0 || H > 65535 || B > 65535 ||
      window < 0)
    return (int)cudaErrorInvalidValue;
  const Strides sq{sqb, sqt, sqh, sqd}, sk{skb, skt, skh, skd},
      sv{svb, svt, svh, svd};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, o, B, nT, S, H, KV, hd, sq, sk, sv,
                              causal, window, scale, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, B, nT, S, H, KV, hd, sq,
                                      sk, sv, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
