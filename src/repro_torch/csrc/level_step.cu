// Batched (max,+) level recurrence over a level-partitioned CSR, for Hopper.
//
// Replaces the TPU kernel src/repro/core/backend.py::_pallas_level_step
// (driven level by level by _accumulate_jax over padded rectangles built by
// _jax_padded).  Here the kernels read the level CSR directly:
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
// depends on the one before, so the pace is set by the number of dependent
// levels times what one level costs.  A replay plan has thousands of levels
// of a few runs each (gemm N=20: 7,703 levels, at most 9 runs); a level's
// own work is a few gathers per thread, so a grid launch per level would
// cost ~3.8 us of launch overhead for well under that of work.
//
// Design.  The sweep columns are independent longest-path problems, so a
// CTA that owns a tile of columns can run many levels in a row with only a
// barrier between them: no other CTA reads or writes its columns.  The
// wrapper hands the host loop a plan (LevelCSR.level_plan) of rows
// (l0, l1, wide):
//   * a narrow row, a stretch of consecutive levels whose runs plus
//     queue-only vertices each fit a few passes of one CTA, is one launch of
//     segment_kernel: one CTA of kSegThreads per tile of kColTile columns
//     loops over the levels, threads over the level's (run, column) pairs,
//     __syncthreads() between levels.  The next level's index ranges and
//     each thread's first pair there (destination, edge range, first
//     source, queue predecessor: gathered by run on the host, so these are
//     independent loads) depend on no F: their loads go out before
//     this level's gathers.  Every F row a pair reads was finished at an
//     earlier level, so its gathers go out together.  A level then costs
//     about one round of F gathers from L2, a store and a barrier.
//   * a wide row, one level too wide for one CTA, is one launch of
//     level_kernel as before: one thread per (run, column) over the card.
// F (and R) are written and re-read by one CTA within a launch: they are
// read with plain loads, never through the non-coherent read-only path;
// __syncthreads() makes a level's stores visible to the next level.  The
// CSR arrays are read-only and go through __ldg.
//
// Exactness: max is exact and each finish is one add, so the result is
// bit-identical to the float64 numpy reference for the float64
// instantiation, and to the float32 certificate's reasoning for the float32
// one.  Build with -fmad=false and without --use_fast_math (no FTZ, no
// contraction); max is written out so that NaN propagates like np.maximum.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -fmad=false -DLEVEL_STEP_SEG_THREADS=512
//        -DLEVEL_STEP_COL_TILE=8 -o liblevel_step.so level_step.cu
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// segment_kernel's threads per CTA and most columns per CTA come from the
// wrapper (kernels/level_step.py), which plans the launches with them.
#if !defined(LEVEL_STEP_SEG_THREADS) || !defined(LEVEL_STEP_COL_TILE)
#error "build with -DLEVEL_STEP_SEG_THREADS=... -DLEVEL_STEP_COL_TILE=..."
#endif
constexpr int kThreads = 256;     // level_kernel: threads per CTA
constexpr int kSegThreads = LEVEL_STEP_SEG_THREADS;
constexpr int kColTile = LEVEL_STEP_COL_TILE;

// np.maximum(a, b) exactly: NaN in either operand gives NaN; otherwise the
// larger, and b when the two compare equal (so max(-0.0, 0.0) is 0.0).
template <typename T>
__device__ __forceinline__ T np_max(T a, T b) {
  return (a > b || a != a) ? a : b;
}

// The level CSR, with what a pair needs gathered by run (and by queue-only
// vertex) on the host, so that a pair's reads are independent loads.
struct Csr {
  const int32_t* esrc;
  const int32_t* run_dst;
  const int32_t* run_starts;
  const int32_t* run_lens;
  const int32_t* run_src0;   // esrc[run_starts[r]]
  const int32_t* run_qp;     // qpred[run_dst[r]]; null without slot chains
  const int32_t* qonly_dst;  // null without queue-only vertices
  const int32_t* qonly_qp;   // qpred[qonly_dst[i]]
};

// One pair's CSR reads (none depends on F): the destination row, the run's
// edges (len 0 for a queue-only vertex) and its first source, and the queue
// predecessor (-1 without slot chains).
struct Item {
  int64_t d, qp, src0;
  int32_t s0, len;
};

// Item j of a level with nr runs from r0 and queue-only vertices from q0.
__device__ __forceinline__ Item load_item(const Csr& g, int64_t j,
                                          int64_t r0, int64_t nr,
                                          int64_t q0) {
  Item it;
  if (j < nr) {
    const int64_t r = r0 + j;
    it.d = __ldg(g.run_dst + r);
    it.s0 = __ldg(g.run_starts + r);
    it.len = __ldg(g.run_lens + r);
    it.src0 = __ldg(g.run_src0 + r);
    it.qp = g.run_qp != nullptr ? __ldg(g.run_qp + r) : -1;
  } else {
    const int64_t i = q0 + (j - nr);
    it.d = __ldg(g.qonly_dst + i);
    it.qp = __ldg(g.qonly_qp + i);
    it.s0 = 0;
    it.len = 0;
    it.src0 = 0;
  }
  return it;
}

// Finish column c of an item's destination.  F and R are plain pointers:
// F is re-read after other threads of the CTA wrote it.  Every row read
// (the sources, the queue predecessor, d itself) was finished at an
// earlier level, so the loads go out together before the max.
template <typename T>
__device__ __forceinline__ void finish(const Csr& g, const Item& it, T* F,
                                       T* R, int64_t k, int64_t c,
                                       int clamp) {
  const int64_t dc = it.d * k + c;
  const T fd = F[dc];
  const T fq = it.qp >= 0 ? F[it.qp * k + c] : T(0);
  if (it.len > 0) {
    T m = F[it.src0 * k + c];
#pragma unroll 4
    for (int32_t e = 1; e < it.len; ++e)
      m = np_max(m, F[(int64_t)__ldg(g.esrc + it.s0 + e) * k + c]);
    if (R != nullptr) R[dc] = m;
    if (it.qp >= 0) m = np_max(m, fq);
    if (clamp) m = np_max(m, T(0));
    F[dc] = m + fd;
  } else {
    F[dc] = fd + (clamp ? np_max(fq, T(0)) : fq);
  }
}

// One wide level: one thread per (run or queue-only vertex, column).
template <typename T>
__global__ void __launch_bounds__(kThreads)
level_kernel(Csr g, int64_t r0, int64_t nr, int64_t q0, int64_t nq, T* F,
             T* R, int64_t k, int clamp) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (nr + nq) * k) return;
  const int64_t j = t / k;
  finish(g, load_item(g, j, r0, nr, q0), F, R, k, t - j * k, clamp);
}

// The pairs of one level in a CTA that owns kc columns.
struct Level {
  int64_t r0, nr, q0, nq;
};

__device__ __forceinline__ Level load_level(const int32_t* run_ptr,
                                            const int32_t* qonly_ptr,
                                            int32_t lvl) {
  Level L;
  L.r0 = __ldg(run_ptr + lvl);
  L.nr = __ldg(run_ptr + lvl + 1) - L.r0;
  L.q0 = 0;
  L.nq = 0;
  if (qonly_ptr != nullptr) {
    L.q0 = __ldg(qonly_ptr + lvl);
    L.nq = __ldg(qonly_ptr + lvl + 1) - L.q0;
  }
  return L;
}

// Levels [l0, l1) in one launch: CTA b owns columns [b*kColTile, ...).
// run_ptr / qonly_ptr are device copies (qonly_ptr null without queue-only
// vertices).
template <typename T>
__global__ void __launch_bounds__(kSegThreads)
segment_kernel(Csr g, const int32_t* __restrict__ run_ptr,
               const int32_t* __restrict__ qonly_ptr, int32_t l0, int32_t l1,
               T* F, T* R, int64_t k, int clamp) {
  const int64_t c0 = (int64_t)blockIdx.x * kColTile;
  // the plan keeps a narrow level's pairs to a few passes of the CTA, so
  // 32-bit pair indices suffice here
  const int kc = (int)(k - c0 < kColTile ? k - c0 : kColTile);
  const int tid = threadIdx.x;
  const int j0 = tid / kc;                 // this thread's first pair
  const int64_t c = c0 + (tid - j0 * kc);  // ... and its column
  Level cur = load_level(run_ptr, qonly_ptr, l0);
  Item it{};
  if (tid < (cur.nr + cur.nq) * kc)
    it = load_item(g, j0, cur.r0, cur.nr, cur.q0);
  for (int32_t lvl = l0; lvl < l1; ++lvl) {
    // the next level's ranges and this thread's first pair there depend
    // on no F: their loads go out before this level's gathers
    const bool more = lvl + 1 < l1;
    Level nxt{};
    Item nit{};
    if (more) {
      nxt = load_level(run_ptr, qonly_ptr, lvl + 1);
      if (tid < (nxt.nr + nxt.nq) * kc)
        nit = load_item(g, j0, nxt.r0, nxt.nr, nxt.q0);
    }
    const int pairs = (int)((cur.nr + cur.nq) * kc);
    if (tid < pairs) finish(g, it, F, R, k, c, clamp);
    for (int p = tid + kSegThreads; p < pairs; p += kSegThreads) {
      const int j = p / kc;
      finish(g, load_item(g, j, cur.r0, cur.nr, cur.q0), F, R, k,
             c0 + (p - j * kc), clamp);
    }
    if (!more) break;
    if (pairs > 0) __syncthreads();   // uniform: this level's F is written
    cur = nxt;
    it = nit;
  }
}

// The host loop over the plan: n_plan rows (l0, l1, wide, levels) of
// int32, a HOST array, as are run_ptr_h / qonly_ptr_h (n_levels + 1
// entries, qonly_ptr_h null without queue-only vertices); every other
// pointer is device memory.  Returns the first CUDA error (0 = success)
// and the number of grids launched through *launches.
template <typename T>
int run_plan(const Csr& g, const int32_t* run_ptr_d,
             const int32_t* qonly_ptr_d, const int32_t* run_ptr_h,
             const int32_t* qonly_ptr_h, const int32_t* plan, int32_t n_plan,
             T* F, T* R, int64_t k, int clamp, cudaStream_t stream,
             int64_t* launches) {
  *launches = 0;
  if (k <= 0) return 0;
  const unsigned seg_blocks = (unsigned)((k + kColTile - 1) / kColTile);
  for (int32_t i = 0; i < n_plan; ++i) {
    const int32_t l0 = plan[4 * i], l1 = plan[4 * i + 1];
    if (plan[4 * i + 2]) {
      const int64_t r0 = run_ptr_h[l0], nr = run_ptr_h[l0 + 1] - r0;
      int64_t q0 = 0, nq = 0;
      if (qonly_ptr_h != nullptr) {
        q0 = qonly_ptr_h[l0];
        nq = qonly_ptr_h[l0 + 1] - q0;
      }
      const int64_t total = (nr + nq) * k;
      if (total == 0) continue;
      level_kernel<T><<<(unsigned)((total + kThreads - 1) / kThreads),
                        kThreads, 0, stream>>>(g, r0, nr, q0, nq, F, R, k,
                                               clamp);
    } else {
      segment_kernel<T><<<seg_blocks, kSegThreads, 0, stream>>>(
          g, run_ptr_d, qonly_ptr_d, l0, l1, F, R, k, clamp);
    }
    ++*launches;
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" {

#define LEVEL_STEP_ENTRY(NAME, T)                                            \
  int NAME(const int32_t* esrc, const int32_t* run_dst,                      \
           const int32_t* run_starts, const int32_t* run_lens,               \
           const int32_t* run_src0, const int32_t* run_qp,                   \
           const int32_t* qonly_dst, const int32_t* qonly_qp,                \
           const int32_t* run_ptr_d, const int32_t* qonly_ptr_d,             \
           const int32_t* run_ptr_h, const int32_t* qonly_ptr_h,             \
           const int32_t* plan, int32_t n_plan, T* F, T* R, int64_t k,       \
           int32_t clamp, void* stream, int64_t* launches) {                 \
    const Csr g{esrc,     run_dst, run_starts, run_lens,                     \
                run_src0, run_qp,  qonly_dst,  qonly_qp};                    \
    return run_plan<T>(g, run_ptr_d, qonly_ptr_d, run_ptr_h, qonly_ptr_h,    \
                       plan, n_plan, F, R, k, clamp, (cudaStream_t)stream,   \
                       launches);                                            \
  }

LEVEL_STEP_ENTRY(level_step_f32, float)
LEVEL_STEP_ENTRY(level_step_f64, double)

#undef LEVEL_STEP_ENTRY

const char* level_step_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
