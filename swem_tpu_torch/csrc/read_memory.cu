// The SWEM memory read, fused, in FP32 on Hopper.
//
// Replaces the TPU kernel swem_tpu/ops/read_pallas.py::_read_kernel (reached
// through read_memory_pallas). For each pixel p and object n, over the
// object's 2 * Lm bases j = (branch s, base l):
//   a[j] = qk[p] . mk[n, s, :, l]          (both l2-normalized by the caller)
//   e[j] = valid[j] ? exp((a[j] - max_valid a) / tau) : 0
//   mem_out[n, p, :] = sum_j e[j] mv[n, s, :, l] / (sum_j e[j] + 1e-30)
// and writes e as exp_aff (B, N, 2, Lm, P), the layout the top-l feature
// reads. An object with no valid base gives mem_out = 0 and exp_aff = 0.
//
// What bounds it: operations. At the flagship shapes (P = 1620, Ck = 128,
// 2 objects, Lm = 256, Cv = 512) it is about 2.1 GFLOP of FP32 products
// against about 17 MB of inputs and outputs. Each block takes 32 pixels of
// one object: with at most 2 * Lm = 512 keys the whole affinity row block
// (32 x 512 FP32, 64 KB) stays in shared memory, so the softmax needs no
// online rescaling and the affinities never reach device memory except as
// the exp_aff output. The value read then streams the object's mv (1 MB,
// too large for shared memory) through shared memory in 32-base chunks; it
// is re-read by every pixel tile but from L2. One block per (pixel tile,
// object) gives only 102 blocks at the flagship shape for 132 SMs, so the
// value read's Cv = 512 columns are split over 4 blocks, each of which
// recomputes the (cheaper) affinities. exp_aff is written directly in
// (Lm, P) order, pixels contiguous, by the first block of each split: the
// TPU version paid a separate relayout for that layout.
#include "common.cuh"

namespace swem {
namespace {

// qk (B, P, C); mk (B, G, C, Lm); mv (B, G, Cv, Lm); valid (B, G, Lm) bytes;
// out (B, G/2, P, Cv); exp_aff (B, G, Lm, P).
// Grid: (32-pixel tile x 128-column slice of Cv) x object x batch.
__global__ void __launch_bounds__(kThreads)
read_kernel(const float* __restrict__ qk, const float* __restrict__ mk,
            const float* __restrict__ mv, const unsigned char* __restrict__ valid,
            float* __restrict__ out, float* __restrict__ exp_aff,
            int P, int C, int Cv, int Lm, int G, float tau) {
  extern __shared__ float smem[];
  const int W2 = 2 * Lm;
  const int n_vs = (Cv + kTN - 1) / kTN, vs = blockIdx.x % n_vs;
  const int n = blockIdx.y, b = blockIdx.z, p0 = (blockIdx.x / n_vs) * kTP;
  float* xs = smem;              // C x kXP: the query tile, transposed
  float* ks = xs + C * kXP;      // kKC x kKP: staged operand chunk
  float* S = ks + kKC * kKP;     // W2 x kXP: affinities, then exp, S[j * kXP + r]
  float* red = S + W2 * kXP;     // kWarps x 32 partial row reductions
  float* row = red + kThreads;   // kTP: row max, then row sum + 1e-30
  const size_t obj = (size_t)b * G + 2 * n;
  const float* kb = mk + obj * C * Lm;
  const float* vb = mv + obj * Cv * Lm;
  const unsigned char* vd = valid + obj * Lm;

  load_rows_transposed(xs, qk + (size_t)b * P * C, p0, P, C);
  tile_times_columns(xs, ks, kb, C, Lm, [&](int r, int j, float v) { S[j * kXP + r] = v; });

  // masked joint softmax over the 2 * Lm bases: lane = pixel row, warps split bases
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float m = -INFINITY;
  for (int j = warp; j < W2; j += kWarps)
    if (vd[j]) m = fmaxf(m, S[j * kXP + lane]);
  red[warp * 32 + lane] = m;
  __syncthreads();
  if (warp == 0) {
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w * 32 + lane]);
    row[lane] = m;
  }
  __syncthreads();
  m = row[lane];
  const int p = p0 + lane;
  float sum = 0.f;
  for (int j = warp; j < W2; j += kWarps) {
    const float e = vd[j] ? expf((S[j * kXP + lane] - m) / tau) : 0.f;
    S[j * kXP + lane] = e;
    sum += e;
    if (vs == 0 && p < P) exp_aff[(obj * Lm + j) * P + p] = e;
  }
  red[warp * 32 + lane] = sum;
  __syncthreads();
  if (warp == 0) {
    for (int w = 1; w < kWarps; ++w) sum += red[w * 32 + lane];
    row[lane] = sum + 1e-30f;
  }

  // value read of this block's 128 columns: out[r, v] = sum_j S[j, r] mv[j, v] / row[r]
  const int tr = threadIdx.x / 32, tc = threadIdx.x % 32;
  {
    const int v0 = vs * kTN;
    float acc[4][4] = {};
    for (int k0 = 0; k0 < W2; k0 += kKC) {
      __syncthreads();
      // consecutive threads take consecutive bases: coalesced reads along l
      for (int i = threadIdx.x; i < kKC * kTN; i += kThreads) {
        const int vv = i / kKC, kk = i - vv * kKC, j = k0 + kk, v = v0 + vv;
        float val = 0.f;
        if (j < W2 && v < Cv) {
          const int s = j / Lm;
          val = vb[((size_t)s * Cv + v) * Lm + (j - s * Lm)];
        }
        ks[kk * kKP + vv] = val;
      }
      __syncthreads();
      mma_chunk(S + k0 * kXP, ks, min(kKC, W2 - k0), acc);
    }
    float* ob = out + (((size_t)b * (G / 2) + n) * P + p0) * Cv;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * tr + i;
      if (p0 + r >= P) continue;
#pragma unroll
      for (int jx = 0; jx < 4; ++jx) {
        const int v = v0 + tc + 32 * jx;
        if (v < Cv) ob[(size_t)r * Cv + v] = acc[i][jx] / row[r];
      }
    }
  }
}

}  // namespace
}  // namespace swem

// Runs the read on `stream`. Returns the first CUDA error, or 0.
extern "C" int swem_read_memory(const float* qk, const float* mk, const float* mv,
                                const unsigned char* valid, float* out, float* exp_aff,
                                int B, int G, int P, int C, int Cv, int Lm, float tau,
                                void* stream_ptr) {
  using namespace swem;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t smem =
      sizeof(float) * ((size_t)C * kXP + kKC * kKP + (size_t)2 * Lm * kXP + kThreads + kTP);
  cudaError_t err = cudaFuncSetAttribute(read_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((P + kTP - 1) / kTP) * ((Cv + kTN - 1) / kTN), G / 2, B);
  read_kernel<<<grid, kThreads, smem, stream>>>(qk, mk, mv, valid, out, exp_aff, P, C, Cv, Lm,
                                                G, tau);
  return cudaGetLastError();
}
