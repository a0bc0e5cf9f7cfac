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
// computed as the TPU kernel does: one KV tile at a time with the state
// (m, l, acc) in float32, m_new = max(m, max_j s), p = exp(s - m_new),
// corr = exp(m - m_new), l = l*corr + sum p, acc = acc*corr + p v, and at
// the end o = acc / max(l, 1e-30), written in the inputs' dtype (float32,
// or bf16 rounded to nearest even).
//
// Layout: q (B,T,H,hd), k and v (B,S,KV,hd), each read through its four
// element strides (no transposes on the host); o (B,T,H,hd) contiguous.
// hd is a multiple of 8 up to 128; T and S are any lengths (the ragged
// edges are masked here, where the TPU kernel asserts T % block_q == 0).
// KV tiles that lie wholly past the causal diagonal or wholly before the
// window of every row of a CTA are skipped: they would add exp(-1e30 - m)
// = 0 to every row that has a key (the wrapper refuses inputs with a row
// that has none).  Keys past S score -inf and add exactly 0.  IEEE expf
// and division (no fast-math).
//
// Two kernels, by dtype, one launch per call either way:
//
// * bf16 (what the served models call): flash_attention_bf16_kernel, on
//   the tensor cores.  One CTA of 8 warps per (64 query rows, head,
//   batch): each 16 query rows belong to two warps, and each of the two
//   takes half of every KV tile's keys.  The Q tile is staged once and
//   held in registers as mma A fragments (ldmatrix).  K and V tiles of 128
//   keys are staged in bf16 by cp.async in 16-byte chunks into a two-stage
//   ring, so the next tile's copy overlaps this tile's products (element
//   loads instead when a stride or the base is not 16-byte aligned; rows
//   past T or S are zero-filled).  Shared-memory rows are padded by 8 bf16
//   (16 bytes) so that the eight rows an ldmatrix phase reads fall in
//   distinct banks; a head dimension that is not a multiple of 16 (8, 24,
//   40, ...) is zero-padded to the k16 step there.  S = Q K^T is mma.sync
//   m16n8k16 (bf16 in, float32 sums; products exact) with K's B fragments
//   by ldmatrix.  The mask is applied on the accumulator layout (thread
//   lane holds rows lane/4 and lane/4 + 8, keys 2*(lane%4) and +1 of each
//   8-key tile), and skipped for a warp whose keys every one of its rows
//   sees.  The row max goes across the 4 threads of a row by
//   __shfl_xor_sync over 1 and 2 and then across the two warps of the
//   rows through shared memory, so both hold the running max that a
//   sequential pass over the tile would: the probabilities, and their
//   rounding to bf16, are those of one warp taking all 128 keys.  l is
//   summed from the float32 probabilities (as FlashAttention-2 does), per
//   warp.  P is rounded to bf16 in registers and used as the A operand of
//   O += P V directly: the accumulators of two adjacent 8-key tiles are
//   the A fragment of one k16 step.  V's B fragments come from
//   ldmatrix.trans.  At the end the second warp's acc and l join the
//   first's through shared memory.  Rounding P to bf16 before P V is what
//   the models' attention_ref does; the plain version's round_p=True does
//   the same.  Shared memory per CTA: (64 + 4*128) rows of hd_pad + 8
//   bf16, 153 KB at hd=128 (one CTA per SM), 81 KB at hd=64 (two).
//   Tiles of 128 keys beat tiles of 64 (two CTAs per SM at hd=128) by
//   3-18% at every shape measured, grids of 512 CTAs included; 32-row
//   CTAs and one warp per 16 rows were slower still (PERF.md).
//
// * float32: flash_attention_f32_kernel, on the CUDA cores (TF32 tensor
//   cores would miss the 1e-5 the float32 fixtures are held to).  One CTA
//   of 256 threads per (64 query rows, head, batch), four threads per row;
//   Q, one K and one V tile staged as float32 with rows padded to hd+1;
//   each thread computes 16 of its row's 64 scores and hd/4 output columns
//   serially; the probabilities go through a shared 64x65 tile.
//
// What bounds it on this card.  The least time for the work is set by
// bytes: q, k, v read once and o written once over 3.35 TB/s is ~0.2-1.4
// us at the served prefill shapes, while the 4*hd operations per unmasked
// (query, key) pair over the 989 TFLOP/s of the bf16 tensor cores take
// 100x less.  So mma.sync, at a fraction of wgmma's rate, is not what
// limits the bf16 kernel: its time goes to the serial chain per KV tile
// (copy wait, S, softmax with IEEE expf, P V, three barriers) in few CTAs
// (B*H*ceil(T/64): 32-96 at the served shapes on 132 SMs, two warps per
// SM scheduler), and to the launch.  Splitting each tile's keys between
// two warps halves the chain's per-warp work, and 128-key tiles halve the
// number of links; wgmma, TMA and more warps per SM at short prompts are
// later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float kNegInf = -1e30f;

struct Strides {
  int64_t b, t, h, d;
};

// cudaFuncSetAttribute once per kernel instantiation and device: the
// largest dynamic shared memory that instantiation ever asks for.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes,
                       std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? (uint64_t)1 << dev : 0;
  if (bit != 0 && (done.load() & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

// ------------------------------------------------------ float32 kernel

constexpr int kBQ = 64;           // query rows per CTA
constexpr int kBKV = 64;          // keys per tile
constexpr int kThreads = 256;     // 4 per query row
constexpr int kCols = kBKV / 4;   // scores per thread per tile

// Stage rows [row0, row0 + 64) of head `head` of x (rows past n read as 0)
// into s (64 rows of ld floats).
__device__ void stage(float* s, const float* __restrict__ x, Strides st,
                      int b, int head, int row0, int n, int hd, int ld) {
  for (int i = threadIdx.x; i < kBQ * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd, t = row0 + r;
    s[r * ld + d] = t < n ? x[b * st.b + (int64_t)t * st.t + head * st.h +
                              d * st.d]
                          : 0.0f;
  }
}

template <int HDMAX>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ o, int nT, int S, int H,
                           int KV, int hd, Strides sq, Strides sk,
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
    float* out = o + (((int64_t)b * nT + qpos) * H + h) * hd;
#pragma unroll
    for (int i = 0; i < HDMAX / 4; ++i) {
      const int d = sub + 4 * i;
      if (d < hd) out[d] = acc[i] / den;
    }
  }
}

constexpr size_t f32_smem_bytes(int hd) {
  return sizeof(float) *
         ((size_t)(kBQ + 2 * kBKV) * (hd + 1) + (size_t)kBQ * (kBKV + 1));
}

template <int HDMAX>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int nT, int S, int H, int KV, int hd, Strides sq, Strides sk,
               Strides sv, int causal, int window, float scale,
               cudaStream_t stream) {
  static std::atomic<uint64_t> done{0};
  cudaError_t err = allow_smem(flash_attention_f32_kernel<HDMAX>,
                               f32_smem_bytes(HDMAX), done);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((nT + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  flash_attention_f32_kernel<HDMAX><<<grid, kThreads, f32_smem_bytes(hd),
                                      stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, nT, S, H,
      KV, hd, sq, sk, sv, causal, window, scale);
  return (int)cudaGetLastError();
}

// --------------------------------------------- bf16 tensor-core kernel

typedef __nv_bfloat16 bf16;

constexpr int kTcBQ = 64;                 // query rows per CTA
constexpr int kTcRowWarps = kTcBQ / 16;   // warps per key half
constexpr int kTcWarps = 2 * kTcRowWarps; // two per 16 rows
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcBKV = 128;               // keys per tile
constexpr int kTcKeys = kTcBKV / 2;       // keys per warp per tile
constexpr int kTcNT = kTcKeys / 8;        // 8-key mma tiles per warp

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; the bytes past src_bytes (0 or 16) are zero.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix
// i, and register i gets its fragment (row lane/4, columns 2*(lane%4)+0,1;
// with .trans the transpose: rows 2*(lane%4)+0,1 of column lane/4).
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b: a 16x16 (row), b 16x8 (col), bf16 in, float32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// Stage rows [row0, row0 + nrows) of head `head` of x, columns [0, hd),
// into s (rows of ld bf16); rows at or past n are zero.  vec: 16-byte
// cp.async chunks (the caller commits them); else element loads.
__device__ __forceinline__ void stage_bf16(bf16* s, int ld,
                                           const bf16* __restrict__ x,
                                           Strides st, int b, int head,
                                           int row0, int nrows, int n,
                                           int hd, bool vec) {
  const bf16* base = x + b * st.b + head * st.h;
  if (vec) {
    // chunk i = threadIdx.x + j*kTcThreads is (row r, chunk c) of cpr
    // chunks per row; r and c advance by a fixed step (no division)
    const int cpr = hd >> 3, dr = kTcThreads / cpr, dc = kTcThreads % cpr;
    int r = threadIdx.x / cpr, c = threadIdx.x % cpr;
    for (; r < nrows; r += dr, c += dc) {
      if (c >= cpr) {
        c -= cpr;
        ++r;
        if (r >= nrows) break;
      }
      const int t = row0 + r;
      cp_async16(smem_u32(s + r * ld + (c << 3)),
                 t < n ? base + (int64_t)t * st.t + (c << 3) : x,
                 t < n ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * hd; i += kTcThreads) {
      const int r = i / hd, d = i - r * hd, t = row0 + r;
      s[r * ld + d] = t < n ? base[(int64_t)t * st.t + (int64_t)d * st.d]
                            : __float2bfloat16_rn(0.0f);
    }
  }
}

template <int HDMAX>
__global__ void __launch_bounds__(kTcThreads)
flash_attention_bf16_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ o,
                            int nT, int S, int H, int KV, int hd, Strides sq,
                            Strides sk, Strides sv, int causal, int window,
                            float scale, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int hdp = (hd + 15) & ~15;   // padded to the k16 step
  const int ld = hdp + 8;            // +16 bytes: ldmatrix conflict-free
  bf16* qs = smem;                   // kTcBQ rows
  bf16* ks = qs + kTcBQ * ld;        // 2 stages x kTcBKV rows
  bf16* vs = ks + 2 * kTcBKV * ld;   // 2 stages x kTcBKV rows

  const int q0 = blockIdx.x * kTcBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = (int)((int64_t)h * KV / H);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;   // mma row group, its thread
  // this warp's 16 rows, and its share of each tile's keys
  const int rw = warp % kTcRowWarps, k0 = (warp / kTcRowWarps) * kTcKeys;

  // the KV tiles some row of this CTA may attend to (at least one: the
  // wrapper checked that every row has a key)
  const int q_last = min(q0 + kTcBQ, nT) - 1;
  const int kv_end = causal ? min(S, q_last + 1) : S;
  int kv_begin = 0;
  if (window > 0 && q0 - window + 1 > 0)
    kv_begin = ((q0 - window + 1) / kTcBKV) * kTcBKV;
  const int n_tiles = (kv_end - kv_begin + kTcBKV - 1) / kTcBKV;

  // zero the columns [hd, hdp) of every row (copies never write them)
  if (hdp > hd) {
    const int pad = hdp - hd, rows = kTcBQ + 4 * kTcBKV;
    for (int i = threadIdx.x; i < rows * pad; i += kTcThreads) {
      const int r = i / pad;
      smem[r * ld + hd + (i - r * pad)] = __float2bfloat16_rn(0.0f);
    }
  }
  stage_bf16(qs, ld, q, sq, b, h, q0, kTcBQ, nT, hd, vec);
  stage_bf16(ks, ld, k, sk, b, g, kv_begin, kTcBKV, S, hd, vec);
  stage_bf16(vs, ld, v, sv, b, g, kv_begin, kTcBKV, S, hd, vec);
  cp_async_commit();

  // the row maxima the two warps of a row share exchange here
  __shared__ float red[kTcWarps][32][2];
  uint32_t qf[HDMAX / 16][4];
  float acc[HDMAX / 8][4];
#pragma unroll
  for (int n = 0; n < HDMAX / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  const int w0 = q0 + rw * 16;               // this warp's first row
  const int row0 = w0 + gr;                  // this thread's rows: +0, +8

  for (int it = 0; it < n_tiles; ++it) {
    const int kv0 = kv_begin + it * kTcBKV;
    if (it + 1 < n_tiles) {          // the next tile into the other stage
      const int nx = ((it + 1) & 1) * kTcBKV * ld;
      stage_bf16(ks + nx, ld, k, sk, b, g, kv0 + kTcBKV, kTcBKV, S, hd, vec);
      stage_bf16(vs + nx, ld, v, sv, b, g, kv0 + kTcBKV, kTcBKV, S, hd, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                 // this tile (and Q) have landed
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < HDMAX / 16; ++kk)
        if (kk * 16 < hdp)
          ldsm_x4(smem_u32(qs + (rw * 16 + (lane & 7) +
                                 ((lane >> 3) & 1) * 8) * ld +
                           kk * 16 + (lane >> 4) * 8),
                  qf[kk]);
    }
    const bf16* kt = ks + (it & 1) * kTcBKV * ld;
    const bf16* vt = vs + (it & 1) * kTcBKV * ld;
    const int kw = kv0 + k0;         // this warp's first key

    // S = Q K^T: 16 rows x kTcKeys keys per warp, tiles of 8 keys
    float s[kTcNT][4];
#pragma unroll
    for (int j = 0; j < kTcNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HDMAX / 16; ++kk) {
      if (kk * 16 >= hdp) break;
#pragma unroll
      for (int jj = 0; jj < kTcNT / 2; ++jj) {
        uint32_t kb[4];
        ldsm_x4(smem_u32(kt + (k0 + jj * 16 + (lane & 7) +
                               ((lane >> 4) << 3)) * ld +
                         kk * 16 + ((lane >> 3) & 1) * 8),
                kb);
        mma_bf16(s[2 * jj], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * jj + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // mask, scale, online softmax; s[j][e] is row row0 + (e/2)*8, key
    // kw + 8j + 2tq + e%2.  Keys that every row of the warp sees need no
    // mask (the test is uniform across the warp).
    const bool whole = kw + kTcKeys <= S &&
                       (!causal || kw + kTcKeys - 1 <= w0) &&
                       (window <= 0 || w0 + 15 - kw < window);
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kTcNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (!whole) {
          const int qpos = row0 + (e >> 1) * 8;
          const int kpos = kw + j * 8 + tq * 2 + (e & 1);
          const bool ok = (!causal || qpos >= kpos) &&
                          (window <= 0 || qpos - kpos < window);
          x = kpos >= S ? -INFINITY : (ok ? x : kNegInf);
        }
        s[j][e] = x;
        mt[e >> 1] = fmaxf(mt[e >> 1], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
    }
    // the whole tile's row maxima, from the other half of its keys
    red[warp][lane][0] = mt[0];
    red[warp][lane][1] = mt[1];
    __syncthreads();
    const int other = (warp + kTcRowWarps) % kTcWarps;
    mt[0] = fmaxf(mt[0], red[other][lane][0]);
    mt[1] = fmaxf(mt[1], red[other][lane][1]);
    float corr[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], mt[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kTcNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        psum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      l[r] = l[r] * corr[r] + psum[r];
    }
#pragma unroll
    for (int n = 0; n < HDMAX / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P V over this warp's keys: P in bf16 as the A operand, steps
    // of 16 keys
#pragma unroll
    for (int kk = 0; kk < kTcNT / 2; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dd = 0; dd < HDMAX / 16; ++dd) {
        if (dd * 16 >= hdp) break;
        uint32_t vb[4];
        ldsm_x4_trans(smem_u32(vt + (k0 + kk * 16 + (lane & 7) +
                                     ((lane >> 3) & 1) * 8) * ld +
                               dd * 16 + (lane >> 4) * 8),
                      vb);
        mma_bf16(acc[2 * dd], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * dd + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();                 // this stage is consumed
  }

  // the second key share's sums (same maxima, same corrections) join
  // the first's through the idle K/V stages; its warps are done
  float* mb = reinterpret_cast<float*>(ks);
  const int t = rw * 32 + lane, stride = kTcRowWarps * 32;
  const int na = hdp / 2;          // accumulators in use per thread
  if (k0 > 0) {
#pragma unroll
    for (int n = 0; n < HDMAX / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n * 8 < hdp) mb[(n * 4 + e) * stride + t] = acc[n][e];
    mb[na * stride + t] = l[0];
    mb[(na + 1) * stride + t] = l[1];
  }
  __syncthreads();
  if (k0 > 0) return;
#pragma unroll
  for (int n = 0; n < HDMAX / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (n * 8 < hdp) acc[n][e] += mb[(n * 4 + e) * stride + t];
  l[0] += mb[na * stride + t];
  l[1] += mb[(na + 1) * stride + t];

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row0 + r * 8;
    if (qpos >= nT) continue;
    const float den = fmaxf(l[r], 1e-30f);
    bf16* out = o + (((int64_t)b * nT + qpos) * H + h) * hd;
#pragma unroll
    for (int n = 0; n < HDMAX / 8; ++n) {
      const int col = n * 8 + tq * 2;
      if (col < hd)
        *reinterpret_cast<__nv_bfloat162*>(out + col) =
            __floats2bfloat162_rn(acc[n][2 * r] / den,
                                  acc[n][2 * r + 1] / den);
    }
  }
}

constexpr size_t bf16_smem_bytes(int hd) {
  return sizeof(bf16) * (size_t)(kTcBQ + 4 * kTcBKV) *
         (size_t)(((hd + 15) & ~15) + 8);
}

// 16-byte copies need unit d-stride and 16-byte aligned rows and heads.
bool aligned16(const void* p, Strides s) {
  return ((uintptr_t)p & 15) == 0 && s.d == 1 && s.t % 8 == 0 &&
         s.h % 8 == 0 && s.b % 8 == 0;
}

template <int HDMAX>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int nT, int S, int H, int KV, int hd, Strides sq, Strides sk,
                Strides sv, int causal, int window, float scale,
                cudaStream_t stream) {
  static std::atomic<uint64_t> done{0};
  cudaError_t err = allow_smem(flash_attention_bf16_kernel<HDMAX>,
                               bf16_smem_bytes(HDMAX), done);
  if (err != cudaSuccess) return (int)err;
  const int vec = aligned16(q, sq) && aligned16(k, sk) && aligned16(v, sv);
  dim3 grid((unsigned)((nT + kTcBQ - 1) / kTcBQ), (unsigned)H, (unsigned)B);
  flash_attention_bf16_kernel<HDMAX><<<grid, kTcThreads, bf16_smem_bytes(hd),
                                       stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, nT, S, H, KV,
      hd, sq, sk, sv, causal, window, scale, vec);
  return (int)cudaGetLastError();
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
      window < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Strides sq{sqb, sqt, sqh, sqd}, sk{skb, skt, skh, skd},
      sv{svb, svt, svh, svd};
  cudaStream_t s = (cudaStream_t)stream;
#define FA_ARGS q, k, v, o, B, nT, S, H, KV, hd, sq, sk, sv, causal, window, \
                scale, s
  if (dtype == 0) {
    if (hd <= 32) return launch_f32<32>(FA_ARGS);
    if (hd <= 64) return launch_f32<64>(FA_ARGS);
    return launch_f32<128>(FA_ARGS);
  }
  if (hd <= 32) return launch_bf16<32>(FA_ARGS);
  if (hd <= 64) return launch_bf16<64>(FA_ARGS);
  return launch_bf16<128>(FA_ARGS);
#undef FA_ARGS
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
