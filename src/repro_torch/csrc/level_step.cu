// Batched (max,+) level recurrence over a level-partitioned CSR, for Hopper.
//
// Replaces the TPU kernel src/repro/core/backend.py::_pallas_level_step
// (driven level by level by _accumulate_jax over padded rectangles built by
// _jax_padded).  Here the kernel reads the level CSR directly:
//
//   for every level l >= 1, for every run j of equal destination d in l and
//   every sweep column c:
//       m      = max_{u in preds(d)} F[u, c]          (np.maximum semantics)
//       R[d,c] = m                                     (when R is requested)
//       m      = max(m, F[qpred[d], c])                (when slot chains exist)
//       m      = max(m, 0)                             (when clamp is on)
//       F[d,c] = m + F[d,c]                            (one IEEE add)
//   and for every queue-only vertex d of level l (a slot chain, no DAG
//   predecessor):
//       F[d,c] = F[d,c] + (clamp ? max(F[qpred[d],c], 0) : F[qpred[d],c])
//
// What bounds it on this card: neither bytes nor operations.  Each level
// depends on the one before, so the pace is set by the number of non-empty
// levels (one grid launch each, issued from the host loop below) times the
// launch latency; a level's own work is a few gathers per thread.  This
// first version is deliberately simple: one thread per (run, column), one
// launch per level, runs and queue-only vertices of a level in one grid.
//
// Exactness: max is exact and each finish is one add, so the result is
// bit-identical to the float64 numpy reference for the float64
// instantiation, and to the float32 certificate's reasoning for the float32
// one.  Build with -fmad=false and without --use_fast_math (no FTZ, no
// contraction); max is written out so that NaN propagates like np.maximum.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -fmad=false -o liblevel_step.so level_step.cu
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// np.maximum(a, b) exactly: NaN in either operand gives NaN; otherwise the
// larger, and b when the two compare equal (so max(-0.0, 0.0) is 0.0).
template <typename T>
__device__ __forceinline__ T np_max(T a, T b) {
  return (a > b || a != a) ? a : b;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
level_kernel(const int32_t* __restrict__ esrc,
             const int32_t* __restrict__ run_dst,
             const int32_t* __restrict__ run_starts,
             const int32_t* __restrict__ run_lens,
             int64_t r0, int64_t nr,
             const int32_t* __restrict__ qpred,
             const int32_t* __restrict__ qonly_dst,
             int64_t q0, int64_t nq,
             T* F, T* R, int64_t k, int clamp) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (nr + nq) * k) return;
  const int64_t j = t / k;
  const int64_t c = t - j * k;
  if (j < nr) {
    const int64_t r = r0 + j;
    const int64_t d = run_dst[r];
    const int64_t s0 = run_starts[r];
    const int32_t len = run_lens[r];
    T m = F[(int64_t)esrc[s0] * k + c];
    for (int32_t e = 1; e < len; ++e)
      m = np_max(m, F[(int64_t)esrc[s0 + e] * k + c]);
    if (R != nullptr) R[d * k + c] = m;
    if (qpred != nullptr) m = np_max(m, F[(int64_t)qpred[d] * k + c]);
    if (clamp) m = np_max(m, T(0));
    F[d * k + c] = m + F[d * k + c];
  } else {
    const int64_t d = qonly_dst[q0 + (j - nr)];
    T fq = F[(int64_t)qpred[d] * k + c];
    if (clamp) fq = np_max(fq, T(0));
    F[d * k + c] = F[d * k + c] + fq;
  }
}

// The level loop.  run_ptr / qonly_ptr are HOST arrays of n_levels + 1
// entries (qonly_ptr may be null); every other pointer is device memory.
// Empty levels launch nothing.  Returns the first CUDA error (0 = success)
// and the number of grids launched through *launches.
template <typename T>
int run_levels(const int32_t* esrc, const int32_t* run_dst,
               const int32_t* run_starts, const int32_t* run_lens,
               const int32_t* run_ptr, const int32_t* qpred,
               const int32_t* qonly_dst, const int32_t* qonly_ptr,
               int32_t n_levels, T* F, T* R, int64_t k, int clamp,
               cudaStream_t stream, int64_t* launches) {
  *launches = 0;
  if (k <= 0) return 0;
  for (int32_t lvl = 1; lvl < n_levels; ++lvl) {
    const int64_t r0 = run_ptr[lvl];
    const int64_t nr = run_ptr[lvl + 1] - r0;
    int64_t q0 = 0, nq = 0;
    if (qonly_ptr != nullptr) {
      q0 = qonly_ptr[lvl];
      nq = qonly_ptr[lvl + 1] - q0;
    }
    const int64_t total = (nr + nq) * k;
    if (total == 0) continue;
    const int64_t blocks = (total + kThreads - 1) / kThreads;
    level_kernel<T><<<(unsigned int)blocks, kThreads, 0, stream>>>(
        esrc, run_dst, run_starts, run_lens, r0, nr, qpred, qonly_dst, q0,
        nq, F, R, k, clamp);
    ++*launches;
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" {

int level_step_f32(const int32_t* esrc, const int32_t* run_dst,
                   const int32_t* run_starts, const int32_t* run_lens,
                   const int32_t* run_ptr, const int32_t* qpred,
                   const int32_t* qonly_dst, const int32_t* qonly_ptr,
                   int32_t n_levels, float* F, float* R, int64_t k,
                   int32_t clamp, void* stream, int64_t* launches) {
  return run_levels<float>(esrc, run_dst, run_starts, run_lens, run_ptr,
                           qpred, qonly_dst, qonly_ptr, n_levels, F, R, k,
                           clamp, (cudaStream_t)stream, launches);
}

int level_step_f64(const int32_t* esrc, const int32_t* run_dst,
                   const int32_t* run_starts, const int32_t* run_lens,
                   const int32_t* run_ptr, const int32_t* qpred,
                   const int32_t* qonly_dst, const int32_t* qonly_ptr,
                   int32_t n_levels, double* F, double* R, int64_t k,
                   int32_t clamp, void* stream, int64_t* launches) {
  return run_levels<double>(esrc, run_dst, run_starts, run_lens, run_ptr,
                            qpred, qonly_dst, qonly_ptr, n_levels, F, R, k,
                            clamp, (cudaStream_t)stream, launches);
}

const char* level_step_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
