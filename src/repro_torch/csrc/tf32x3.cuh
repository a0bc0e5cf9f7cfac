// Shared by the recurrence kernels (ssd.cu, wkv6.cu): float32 matrix
// products on Hopper's tensor cores with the 3xTF32 split, and cp.async
// copies into shared memory.
//
// 3xTF32.  A float32 operand a is split into a_hi = tf32(a) and a_lo =
// tf32(a - a_hi), both rounded to nearest with ties away from zero
// (cvt.rna.tf32.f32); a = a_hi + a_lo to about 2^-22 of |a|.  A
// product a*b is taken as a_lo*b_hi + a_hi*b_lo + a_hi*b_hi with float32
// sums (the small terms first): three mma.sync m16n8k8 TF32 instructions,
// within ~1e-6 of the float32 product, where one plain TF32 product (10-bit
// mantissas) is off by ~5e-4.  A NaN operand stays a NaN in a_hi.
//
// Fragments of mma.sync.m16n8k8 .tf32 (PTX ISA), with g = lane / 4 and
// q = lane % 4:
//   A (16 x 8, row):  a0 (g, q)  a1 (g+8, q)  a2 (g, q+4)  a3 (g+8, q+4)
//   B (8 x 8, col):   b0 (k=q, n=g)  b1 (k=q+4, n=g)
//   C (16 x 8):       c0 (g, 2q)  c1 (g, 2q+1)  c2 (g+8, 2q)  c3 (g+8, 2q+1)
// The loaders below feed the k slots q and q + 4 from the adjacent columns
// 2q and 2q + 1 of each k8 step: a permutation of k that A and B share, so
// the product is unchanged and a row's two values are one 8-byte load.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b in 3xTF32
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2,
                                        float a3) {
  FragA f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
  return f;
}

// A tile of a row-major m[row][k] (row stride ld): p = &m[row0 + g][k0 + 2q]
__device__ __forceinline__ FragA load_a(const float* p, int ld) {
  const float2 u = *reinterpret_cast<const float2*>(p);
  const float2 v = *reinterpret_cast<const float2*>(p + 8 * ld);
  return frag_a(u.x, v.x, u.y, v.y);
}

// B tile where B[k][n] = m[k][n] (row stride ld): p = &m[k0 + 2q][n0 + g]
__device__ __forceinline__ FragB load_b_kn(const float* p, int ld) {
  return frag_b(p[0], p[ld]);
}

// ------------------------------------------------------------ cp.async

// 16 bytes global -> shared; bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most `n` committed groups are still in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

}  // namespace tf32x3
