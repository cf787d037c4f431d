// Warp-level tensor-core products in 3xTF32, and cp.async staging (sm_80+).
//
// mma.sync m16n8k8 takes TF32 operands and accumulates in FP32. A float x
// is split in registers into big = tf32(x) and small = tf32(x - big), both
// rounded to nearest with ties away from zero (as cvt.rna does); a product
// then accumulates small*big + big*small + big*big, which keeps FP32's
// accuracy (the dropped small*small term lies below FP32's rounding). Plain
// TF32 keeps about three decimal digits, too few for a softmax at tau = 0.05.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 with .tf32; lane = 4 g + t):
//   A 16x8, row-major: a0 (g, t)    a1 (g+8, t)    a2 (g, t+4)    a3 (g+8, t+4)
//   B 8x8, column:     b0 (k=t, n=g)               b1 (k=t+4, n=g)
//   C 16x8:            c0 (g, 2t)   c1 (g, 2t+1)   c2 (g+8, 2t)   c3 (g+8, 2t+1)
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace swem {

// x rounded to TF32 (10-bit mantissa), kept in FP32 layout with the low 13
// bits zero: half a TF32 ulp added to the magnitude, then truncated. For a
// finite x this is cvt.rna.tf32.f32's result, in two integer operations
// (with cvt.rna itself the read kernel ran measurably slower on the H100).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

struct SplitTf32 {
  uint32_t big, small;
};

__device__ __forceinline__ SplitTf32 split_tf32(float x) {
  const uint32_t big = to_tf32(x);
  return {big, to_tf32(x - __uint_as_float(big))};
}

// d += a * b on one 16x8x8 tile
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += a * b in 3xTF32, the small terms first, in the tensor cores' own
// FP32 accumulator. That accumulator does not round to nearest: over a long
// sum its error grows past FP32's (on the H100, the read accumulated so over
// all 512 bases left dozens of flagship outputs outside the float64 check),
// so keep each sum this takes short and add it to a longer one with
// mma_3xtf32_add.
__device__ __forceinline__ void mma_3xtf32_acc(float (&d)[4], const SplitTf32 (&a)[4],
                                               const SplitTf32 (&b)[2]) {
  mma_tf32(d, a[0].small, a[1].small, a[2].small, a[3].small, b[0].big, b[1].big);
  mma_tf32(d, a[0].big, a[1].big, a[2].big, a[3].big, b[0].small, b[1].small);
  mma_tf32(d, a[0].big, a[1].big, a[2].big, a[3].big, b[0].big, b[1].big);
}

// d += a * b in 3xTF32, the 8-deep product taken from zero and added to d on
// the CUDA cores, which round to nearest.
__device__ __forceinline__ void mma_3xtf32_add(float (&d)[4], const SplitTf32 (&a)[4],
                                               const SplitTf32 (&b)[2]) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma_3xtf32_acc(p, a, b);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += p[i];
}

// 16-byte asynchronous copy global -> shared; writes zeros when !full
// (gmem must still be a valid address).
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool full) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` of this thread's committed groups are in flight
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

}  // namespace swem
