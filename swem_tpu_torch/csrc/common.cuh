// Shared pieces of the EM loop kernel (em_loop.cu): block shape, warp
// reductions and the FP32 register-tiled block GEMM it builds on. The memory
// read (read_memory.cu) runs on the tensor cores instead (mma_tf32.cuh).
//
// A block of 256 threads computes a 32 x 128 output tile per pass. Thread
// (tr, tc) = (tid / 32, tid % 32) owns rows 4*tr .. 4*tr+3 and columns
// tc, tc+32, tc+64, tc+96, so within a warp the A operand is a broadcast
// and the B operand a run of consecutive words: no shared-memory bank
// conflicts. Products are FP32 FMAs in a fixed order (no TF32, no atomics),
// so every run gives the same bits.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace swem {

constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTP = 32;         // output rows per block
constexpr int kXP = kTP + 1;    // pitch of a transposed 32-row operand
constexpr int kTN = 128;        // output columns per pass
constexpr int kKC = 32;         // contraction chunk staged in shared memory
constexpr int kKP = kTN + 1;    // pitch of a staged contraction chunk

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[i][jx] += sum_{k < kn} A[k * kXP + 4*tr + i] * B[k * kKP + tc + 32*jx]
__device__ __forceinline__ void mma_chunk(const float* A, const float* B, int kn,
                                          float (&acc)[4][4]) {
  const int tr = threadIdx.x / 32, tc = threadIdx.x % 32;
#pragma unroll 4
  for (int k = 0; k < kn; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[k * kXP + 4 * tr + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[k * kKP + tc + 32 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// xs[c * kXP + r] = src[(p0 + r) * C + c] for the 32 rows from p0; zero past P.
__device__ __forceinline__ void load_rows_transposed(float* xs, const float* src, int p0,
                                                     int P, int C) {
  for (int i = threadIdx.x; i < kTP * C; i += kThreads) {
    const int r = i / C, c = i - r * C, p = p0 + r;
    xs[c * kXP + r] = p < P ? src[(size_t)p * C + c] : 0.f;
  }
}

// Product of a transposed 32-row tile xs (C x 32) with one object's prototype
// columns: column j < 2L is (branch s = j / L, base l = j % L) and reads
// kb[(s * C + c) * L + l]. ks is kKC x kKP scratch. store(r, j, value) gets
// each result; the function ends with a barrier.
template <class Store>
__device__ __forceinline__ void tile_times_columns(const float* xs, float* ks, const float* kb,
                                                   int C, int L, Store store) {
  const int W2 = 2 * L, tr = threadIdx.x / 32, tc = threadIdx.x % 32;
  for (int j0 = 0; j0 < W2; j0 += kTN) {
    float acc[4][4] = {};
    for (int k0 = 0; k0 < C; k0 += kKC) {
      __syncthreads();
      for (int i = threadIdx.x; i < kKC * kTN; i += kThreads) {
        const int kk = i / kTN, jj = i - kk * kTN, j = j0 + jj, c = k0 + kk;
        float v = 0.f;
        if (j < W2 && c < C) {
          const int s = j / L;
          v = kb[((size_t)s * C + c) * L + (j - s * L)];
        }
        ks[kk * kKP + jj] = v;
      }
      __syncthreads();
      mma_chunk(xs + k0 * kXP, ks, min(kKC, C - k0), acc);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jx = 0; jx < 4; ++jx) {
        const int j = j0 + tc + 32 * jx;
        if (j < W2) store(4 * tr + i, j, acc[i][jx]);
      }
  }
  __syncthreads();
}

}  // namespace swem
