// The Sequential Weighted EM loop of one memorize, in FP32 on Hopper.
//
// Replaces the TPU kernel swem_tpu/ops/em_pallas.py::_em_kernel (reached
// through em_loop_pallas -> _em_loop_impl). For each batch row it runs
// n_iters rounds of
//   W (not before the first E): per-object {bg, fg} coupling of the pixel weights,
//   E: z = softmax_L(x . l2norm(kappa) / tau) * weights,
//   M: zita = zita0 + sum_p z,  kappa = (zita0 * kappa0 + x^T z) / zita,
// and writes the last z, kappa and zita.
//
// What bounds it: operations. At the flagship shapes (P = 1620 pixels,
// Ck = 128, two objects x two branches x L = 128 bases, 4 rounds) the loop
// is about 2.3 GFLOP of FP32 products on well under 2 MB of operands, far
// above the card's FP32 ridge point. The design therefore keeps every
// operand that a product re-reads in shared memory and registers:
//   * em_e_kernel (grid: 32-pixel tile x object x batch) computes the
//     affinity S = x . kappa of its tile against both branches of its object
//     once, and uses it twice: the W step of the round (S * |x|^-1, as the
//     TPU kernel does) and the E step (S / tau). That shares one GEMM
//     between the W step of round i-1 and the E step of round i.
//   * the M step sums over P. On the TPU the grid runs in order and can
//     carry the sum; here blocks run in no order, so em_m_partial_kernel
//     writes one partial sum per 128-pixel chunk and em_m_final_kernel adds
//     the chunks in a fixed order. No atomics: every run gives the same bits.
//   * z (B, N*2, P, L) goes to device memory: at flagship shapes it is
//     3.3 MB and stays in the 50 MB L2 between the E and M kernels.
// Three launches per round; fusing the rounds into one launch is later work.
#include "common.cuh"

namespace swem {
namespace {

// E step (with the W step of the previous round when with_w != 0).
// x (B, P, C); kappa (B, N2, C, L); masks (B, N2, P); z (B, N2, P, L).
__global__ void __launch_bounds__(kThreads)
em_e_kernel(const float* __restrict__ x, const float* __restrict__ kappa,
            const float* __restrict__ masks, float* __restrict__ z,
            int P, int C, int L, int N2, float tau, int with_w) {
  extern __shared__ float smem[];
  const int W2 = 2 * L, sp = W2 + 1;
  const int n = blockIdx.y, b = blockIdx.z, p0 = blockIdx.x * kTP;
  float* xs = smem;               // C x kXP: the pixel tile, transposed
  float* ks = xs + C * kXP;       // kKC x kKP: staged prototype chunk
  float* S = ks + kKC * kKP;      // kTP x sp: affinities of the tile
  float* invn = S + kTP * sp;     // W2: 1 / (|kappa column| + 1e-6)
  const float* kb = kappa + ((size_t)b * N2 + 2 * n) * C * L;

  load_rows_transposed(xs, x + (size_t)b * P * C, p0, P, C);
  for (int j = threadIdx.x; j < W2; j += kThreads) {
    const int s = j / L;
    const float* col = kb + (size_t)s * C * L + (j - s * L);
    float ss = 0.f;
    for (int c = 0; c < C; ++c) ss = fmaf(col[(size_t)c * L], col[(size_t)c * L], ss);
    invn[j] = 1.f / (sqrtf(ss) + 1e-6f);
  }
  // tile_times_columns synchronizes before its first product, so invn is
  // complete when the stores below read it
  tile_times_columns(xs, ks, kb, C, L,
                     [&](int r, int j, float v) { S[r * sp + j] = v * invn[j]; });

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kTP; r += kWarps) {
    const int p = p0 + r;
    if (p >= P) break;
    const float* Sr = S + r * sp;
    const float* mb = masks + ((size_t)b * N2 + 2 * n) * P + p;
    float w[2] = {mb[0], mb[P]};
    if (with_w) {
      float ss = 0.f;
      for (int c = lane; c < C; c += 32) ss = fmaf(xs[c * kXP + r], xs[c * kXP + r], ss);
      const float xi = 1.f / (sqrtf(warp_sum(ss)) + 1e-6f);
      float m = -INFINITY;
      for (int j = lane; j < W2; j += 32) m = fmaxf(m, Sr[j] * xi);
      m = warp_max(m);
      float e[2];
      for (int s = 0; s < 2; ++s) {
        float acc = 0.f;
        for (int l = lane; l < L; l += 32) acc += expf((Sr[s * L + l] * xi - m) / tau);
        e[s] = warp_sum(acc);
      }
      const float tot = e[0] + e[1];
      w[0] *= 1.f - e[0] / tot;
      w[1] *= 1.f - e[1] / tot;
    }
    for (int s = 0; s < 2; ++s) {
      const float* Ss = Sr + s * L;
      float m = -INFINITY;
      for (int l = lane; l < L; l += 32) m = fmaxf(m, Ss[l] / tau);
      m = warp_max(m);
      float acc = 0.f;
      for (int l = lane; l < L; l += 32) acc += expf(Ss[l] / tau - m);
      const float sum = warp_sum(acc);
      float* zr = z + (((size_t)b * N2 + 2 * n + s) * P + p) * L;
      for (int l = lane; l < L; l += 32) zr[l] = expf(Ss[l] / tau - m) / sum * w[s];
    }
  }
}

// Partial M-step sums over one chunk of pixels, for 32 key channels.
// part (B, N2, n_chunks, C, L) = sum_p x[p, c] z[p, l];
// zpart (B, N2, n_chunks, L) = sum_p z[p, l] (written by channel tile 0).
__global__ void __launch_bounds__(kThreads)
em_m_partial_kernel(const float* __restrict__ x, const float* __restrict__ z,
                    float* __restrict__ part, float* __restrict__ zpart,
                    int P, int C, int L, int N2, int p_chunk, int n_chunks) {
  __shared__ float xs[kKC * kXP];  // xs[pp][cc] = x[q0 + pp][c0 + cc]
  __shared__ float zs[kKC * kKP];  // zs[pp][ll] = z[q0 + pp][l0 + ll]
  const int n_ct = (C + kTP - 1) / kTP;
  const int ct = blockIdx.x % n_ct, chunk = blockIdx.x / n_ct;
  const int g = blockIdx.y, b = blockIdx.z, c0 = ct * kTP;
  const int pbeg = chunk * p_chunk, pend = min(P, pbeg + p_chunk);
  const float* xb = x + (size_t)b * P * C;
  const float* zb = z + ((size_t)b * N2 + g) * P * L;
  const size_t slot = ((size_t)b * N2 + g) * n_chunks + chunk;
  const int tr = threadIdx.x / 32, tc = threadIdx.x % 32;
  const bool sums = ct == 0 && threadIdx.x < kTN;

  for (int l0 = 0; l0 < L; l0 += kTN) {
    float acc[4][4] = {};
    float zsum = 0.f;
    for (int q0 = pbeg; q0 < pend; q0 += kKC) {
      __syncthreads();
      for (int i = threadIdx.x; i < kKC * kTP; i += kThreads) {
        const int pp = i / kTP, cc = i - pp * kTP, p = q0 + pp, c = c0 + cc;
        xs[pp * kXP + cc] = (p < pend && c < C) ? xb[(size_t)p * C + c] : 0.f;
      }
      for (int i = threadIdx.x; i < kKC * kTN; i += kThreads) {
        const int pp = i / kTN, ll = i - pp * kTN, p = q0 + pp, l = l0 + ll;
        zs[pp * kKP + ll] = (p < pend && l < L) ? zb[(size_t)p * L + l] : 0.f;
      }
      __syncthreads();
      mma_chunk(xs, zs, kKC, acc);
      if (sums)
        for (int pp = 0; pp < kKC; ++pp) zsum += zs[pp * kKP + threadIdx.x];
    }
    float* pb = part + slot * C * L;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jx = 0; jx < 4; ++jx) {
        const int c = c0 + 4 * tr + i, l = l0 + tc + 32 * jx;
        if (c < C && l < L) pb[(size_t)c * L + l] = acc[i][jx];
      }
    if (sums && l0 + threadIdx.x < L) zpart[slot * L + l0 + threadIdx.x] = zsum;
  }
}

// kappa = (zita0 * kappa0 + sum_chunks part) / zita, zita = zita0 + sum_chunks zpart,
// with the chunks added in order.
__global__ void __launch_bounds__(kThreads)
em_m_final_kernel(const float* __restrict__ part, const float* __restrict__ zpart,
                  const float* __restrict__ kappa0, const float* __restrict__ zita0,
                  float* __restrict__ kappa, float* __restrict__ zita,
                  int C, int L, int n_chunks, int total) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int l = idx % L, c = (idx / L) % C, bg = idx / (L * C);
  float zs = 0.f, xs = 0.f;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const size_t slot = (size_t)bg * n_chunks + ch;
    zs += zpart[slot * L + l];
    xs += part[(slot * C + c) * L + l];
  }
  const float z0 = zita0[(size_t)bg * L + l];
  const float zt = z0 + zs;
  kappa[idx] = (z0 * kappa0[idx] + xs) / zt;
  if (c == 0) zita[(size_t)bg * L + l] = zt;
}

}  // namespace
}  // namespace swem

// Runs the whole loop on `stream`. Shapes: x (B, P, C); masks (B, N2, P);
// kappa0 and kappa (B, N2, C, L); zita0 and zita (B, N2, L); z (B, N2, P, L);
// part (B, N2, ceil(P / p_chunk), C, L) and zpart (B, N2, ceil(P / p_chunk), L)
// are scratch. Returns the first CUDA error, or 0.
extern "C" int swem_em_loop(const float* x, const float* masks, const float* kappa0,
                            const float* zita0, float* z, float* kappa, float* zita,
                            float* part, float* zpart, int B, int N2, int P, int C, int L,
                            int n_iters, float tau, int p_chunk, void* stream_ptr) {
  using namespace swem;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t smem = sizeof(float) * ((size_t)C * kXP + kKC * kKP + kTP * (2 * L + 1) + 2 * L);
  cudaError_t err = cudaFuncSetAttribute(em_e_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int n_chunks = (P + p_chunk - 1) / p_chunk;
  const int n_ct = (C + kTP - 1) / kTP;
  const int total = B * N2 * C * L;
  const dim3 e_grid((P + kTP - 1) / kTP, N2 / 2, B), m_grid(n_chunks * n_ct, N2, B);
  for (int it = 0; it < n_iters; ++it) {
    em_e_kernel<<<e_grid, kThreads, smem, stream>>>(x, it ? kappa : kappa0, masks, z, P, C, L,
                                                     N2, tau, it > 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    em_m_partial_kernel<<<m_grid, kThreads, 0, stream>>>(x, z, part, zpart, P, C, L, N2,
                                                         p_chunk, n_chunks);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    em_m_final_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        part, zpart, kappa0, zita0, kappa, zita, C, L, n_chunks, total);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return 0;
}
