// The SWEM memory read, fused, on Hopper's tensor cores in 3xTF32.
//
// Replaces the TPU kernel swem_tpu/ops/read_pallas.py::_read_kernel (reached
// through read_memory_pallas). For each pixel p and object n, over the
// object's W2 = 2 * Lm bases j = (branch s, base l):
//   a[j] = qk[p] . mk[n, s, :, l]          (both l2-normalized by the caller)
//   e[j] = valid[j] ? exp((a[j] - max_valid a) / tau) : 0
//   mem_out[n, p, :] = sum_j e[j] mv[n, s, :, l] / (sum_j e[j] + 1e-30)
// and writes e as exp_aff (B, N, 2, Lm, P), pixels contiguous, the layout
// the top-l feature reads. An object with no valid base gives mem_out = 0
// and exp_aff = 0 exactly.
//
// Grid: one CTA of 16 warps per (64-pixel tile x 256-column slice of Cv x
// object x batch); at the flagship shape (P = 1620, Ck = 128, N = 2,
// Lm = 256, Cv = 512) that is 26 x 2 x 2 = 104 CTAs of 204.5 KiB of shared
// memory each, at most one per SM, so 28 of the H100 SXM's 132 SMs (21%) get
// no work; a grid that fills all 132 (smaller pixel tiles, or the two Cv
// slices as a 2-CTA cluster) is a next step. Two instantiations: up to 512
// bases (2 Lm), padded to 512, in 64-pixel tiles (smaller shapes pad up to
// it), where the query tile fits (Ck <= 352); and any other shape in 32-pixel
// tiles and blocks of 1024 columns, which read more than 1024 bases in two
// passes over the blocks: the affinity of every block for the joint row
// maximum, then each block's affinity again, its exponentials (relative to
// the joint maximum, as exp_aff must be) and its part of the value read,
// added in block order. The query tile is staged again for every block (the
// mv chunks reuse its space), so that path takes Ck <= 752. Both products run
// through mma.sync m16n8k8 in 3xTF32 (mma_tf32.cuh), which keeps FP32's
// accuracy at three TF32 products each; every long sum is added on the CUDA
// cores, since the tensor cores' own accumulator does not round to nearest.
// 1. Affinity: the 64 x Ck query tile and Ck-chunks of 32 rows of mk are
//    staged with cp.async, double-buffered, so the next chunk loads while
//    the tensor cores work on this one. Each warp holds a 32-row x
//    W2p/8-column block of the affinities in registers.
// 2. Masked joint softmax in registers: row max and row sum across the
//    warps through shared memory, in a fixed order (no atomics, the same
//    bits every run). The 64 x W2 block of e goes to shared memory (over the
//    dead mk chunks), so there is no online rescaling, and the first Cv
//    slice writes exp_aff from registers.
// 3. Value read: 32-base chunks of this slice's 256 mv columns, double-
//    buffered the same way (the first loads during the softmax); each warp
//    owns a 32-row block of the output, 32 columns wide (16 at 1024 bases).
// Narrow keys (Ck <= 32) take the affinity's products and sums in FP64 on the
// CUDA cores instead, in instantiations of their own (about 2 k FMAs per
// thread per chunk, rounded once to FP32): each 3xTF32 product is good to
// about 2^-21, and with few channels a few products make up each affinity,
// whose error exp(a / tau) magnifies 20 times. At Ck 8 that took the worst
// output to 2.0 times the float64 check's limit (rtol 1e-4, atol 1e-6), 1.2
// with FP64 products; float32 itself reaches 2.4 there (the value read's
// 3xTF32 products and FP32's own rounding remain).
// Ragged edges (P, Ck, Cv, W2) are zero-filled by cp.async and masked at the
// stores. The kernel needs Ck % 4 == 0, Lm % 4 == 0 and 16-byte-aligned
// inputs; the wrapper pads Ck and Lm (padded bases invalid) and aligns.
//
// What bounds it: operations. The function is 2.12 GFLOP of FP32 products
// (0.425 affinity + 1.70 value read) on 16.7 MB of inputs and outputs:
// 0.0317 ms at the H100 SXM's 67 TFLOP/s of FP32 on the CUDA cores, 0.0129
// ms for this route's 3 x 2.12 GFLOP at 495 TFLOP/s of dense TF32, against
// 0.005 ms for the bytes at 3.35 TB/s. The design spends more than that
// least work in three places: each of the 2 Cv slices recomputes the
// affinity (0.85 GFLOP of the 2.55 it runs); per launch the CTAs re-read
// from L2 about 27 MB of mk (each CTA its object's 256 KiB) and 55 MB of mv
// (each 64-pixel tile its object's 1 MiB, over its 2 slices); and mma.sync
// takes its operands from registers, so every element is split there and
// every 8-deep (affinity) or 32-deep (value read) sum added there, on a
// 128-register budget at 16 warps (ptxas spills a little). wgmma with
// operands in shared memory, and TMA multicast of mk and mv across a
// cluster, are the next steps.
#include <math.h>

#include <mutex>

#include "mma_tf32.cuh"

namespace swem {
namespace {

constexpr int kThreads = 512;  // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 256;     // Cv columns per CTA
constexpr int kJc = 32;        // bases per staged mv chunk
constexpr int kVP = kJc + 4;   // pitch of a staged mv chunk: rows v, bases contiguous
constexpr int kMaxSmem = 232448;  // an H100 block's dynamic shared memory
constexpr int kExactC = 32;       // up to this Ck the affinity runs in FP64 on the CUDA cores

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// The CTA's tiling for W2p = 64 NT padded bases. 64 pixel rows, two warp rows
// of 32; at W2p = 1024 the affinity block only fits shared memory at 32 rows,
// and the mk chunks only at 16 rows of Ck. mk and mv are double-buffered.
// kBlocked: 2 Lm may exceed W2p, in column blocks of W2p.
template <int NT>
struct Tiling {
  static constexpr bool kBlocked = NT > 8;
  static constexpr int W2p = 64 * NT;
  static constexpr int kRows = NT <= 8 ? 64 : 32;     // pixels per CTA
  static constexpr int kWarpsN = kWarps / (kRows / 32);  // warps along the columns
  static constexpr int kTilesS = W2p / kWarpsN / 8;   // 8-wide affinity tiles per warp
  static constexpr int kTilesO = kCols / kWarpsN / 8;  // 8-wide output tiles per warp
  static constexpr int kKc = NT <= 8 ? 32 : 16;      // Ck rows per staged mk chunk
  // Shared memory, in floats. Pitches make every fragment load conflict-free:
  // the query tile's, pS and kVP are 4 mod 8 words (A operands, and mv's B),
  // pK is 8 mod 32 (mk's B).
  static constexpr int pK = W2p + 8, pS = W2p + 4;
  // U: the query tile (phase 1), then the mv chunks (phase 3).
  // SK: the mk chunks (phase 1), then the kRows x W2p block of e (phases 2-3).
  __host__ __device__ static constexpr int query_pitch(int C) { return round_up(C, kKc) + 4; }
  __host__ __device__ static constexpr int region_u(int C) {
    return imax(kRows * query_pitch(C), 2 * kCols * kVP);
  }
  static constexpr int kRegionSK = imax(kRows * pS, 2 * kKc * pK);
  static constexpr int kRed = kWarpsN * kRows + 2 * kRows;  // partials, row max, row sum
  __host__ __device__ static constexpr size_t smem_bytes(int C) {
    return sizeof(float) * ((size_t)region_u(C) + kRegionSK + kRed);
  }
};

// qk (B, P, C); mk (B, G, C, Lm); mv (B, G, Cv, Lm); valid (B, G, Lm) bytes;
// out (B, G/2, P, Cv); exp_aff (B, G, Lm, P). W2p = 64 * NT >= 2 * Lm, or any
// 2 Lm in blocks of W2p where kBlocked. kNarrow: C <= kExactC, whose affinity
// runs in FP64 on the CUDA cores.
template <int NT, bool kNarrow>
__global__ void __launch_bounds__(kThreads, 1)
read_kernel(const float* __restrict__ qk, const float* __restrict__ mk,
            const float* __restrict__ mv, const unsigned char* __restrict__ valid,
            float* __restrict__ out, float* __restrict__ exp_aff,
            int P, int C, int Cv, int Lm, int G, float tau) {
  using T = Tiling<NT>;
  constexpr int kRows = T::kRows, kKc = T::kKc, pK = T::pK, pS = T::pS;
  extern __shared__ __align__(16) float smem[];
  const int W2 = 2 * Lm, Cpad = round_up(C, kKc), pQ = T::query_pitch(C);
  const int n_vs = (Cv + kCols - 1) / kCols, vs = blockIdx.x % n_vs;
  const int n = blockIdx.y, b = blockIdx.z, p0 = (blockIdx.x / n_vs) * kRows, v0 = vs * kCols;
  float* U = smem;
  float* SK = U + T::region_u(C);
  float* part = SK + T::kRegionSK;  // kWarpsN x kRows
  float* row_max = part + T::kWarpsN * kRows;
  float* row_sum = row_max + kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wm = warp / T::kWarpsN, wn = warp % T::kWarpsN;  // warp: rows 32 wm.., column block wn
  const size_t obj = (size_t)b * G + 2 * n;
  const float* qb = qk + (size_t)b * P * C;
  const float* kb = mk + obj * C * Lm;
  const float* vb = mv + obj * Cv * Lm;
  const unsigned char* vd = valid + obj * Lm;

  // ---- 1. affinity of column block cb, S = q (kRows x C) . k (C x W2p), in
  // registers; warp (wm, wn) owns rows 32 wm .. 32 wm + 31, columns
  // wn * 8 kTilesS .. of the block, global columns cb W2p + those
  auto load_k = [&](int cb, int chunk) {
    float* ks = SK + (chunk & 1) * kKc * pK;
    for (int i = threadIdx.x; i < kKc * (T::W2p / 4); i += kThreads) {
      const int kk = i / (T::W2p / 4), j = cb * T::W2p + 4 * (i % (T::W2p / 4));
      const int c = chunk * kKc + kk;
      const bool ok = c < C && j < W2;
      const int s = j >= Lm;
      cp_async16(ks + kk * pK + j - cb * T::W2p,
                 ok ? kb + ((size_t)s * C + c) * Lm + (j - s * Lm) : kb, ok);
    }
  };
  const int col0 = wn * 8 * T::kTilesS + 2 * t;  // this thread's first column in the block
  float acc[2][T::kTilesS][4];
  uint32_t valid_bits;  // bit 2 nt + e: column col0 + 8 nt + e of the block is a valid base
  auto affinity = [&](int cb) {
    __syncthreads();  // every warp is done with U and SK
    for (int i = threadIdx.x; i < kRows * (Cpad / 4); i += kThreads) {
      const int r = i / (Cpad / 4), c = 4 * (i % (Cpad / 4)), p = p0 + r;
      const bool ok = p < P && c < C;
      cp_async16(U + r * pQ + c, ok ? qb + (size_t)p * C + c : qb, ok);
    }
    load_k(cb, 0);  // in one group with the query tile
    cp_async_commit();
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < T::kTilesS; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    const int nk = Cpad / kKc;
    for (int kc = 0; kc < nk; ++kc) {
      cp_async_wait<0>();
      __syncthreads();  // chunk kc is in; every warp is done with the other buffer
      if (kc + 1 < nk) load_k(cb, kc + 1);
      cp_async_commit();
      if constexpr (kNarrow) {  // narrow keys: FP64 products and sums on the CUDA cores
        const float* ks = SK + (kc & 1) * kKc * pK + col0;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float* qa = U + (32 * wm + 16 * mt + 8 * h + g) * pQ + kc * kKc;
#pragma unroll
            for (int nt = 0; nt < T::kTilesS; ++nt)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float* kp = ks + 8 * nt + e;
                double d = 0.0;
#pragma unroll 8
                for (int k = 0; k < kKc; ++k) d = fma((double)qa[k], (double)kp[k * pK], d);
                acc[mt][nt][2 * h + e] += (float)d;
              }
          }
        continue;
      }
      const float* ks = SK + (kc & 1) * kKc * pK + wn * 8 * T::kTilesS + g;
#pragma unroll
      for (int k8 = 0; k8 < kKc; k8 += 8) {
        SplitTf32 a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* qa = U + (32 * wm + 16 * mt + g) * pQ + kc * kKc + k8 + t;
          a[mt][0] = split_tf32(qa[0]);
          a[mt][1] = split_tf32(qa[8 * pQ]);
          a[mt][2] = split_tf32(qa[4]);
          a[mt][3] = split_tf32(qa[8 * pQ + 4]);
        }
#pragma unroll
        for (int nt = 0; nt < T::kTilesS; ++nt) {
          const float* kp = ks + (k8 + t) * pK + nt * 8;
          const SplitTf32 bf[2] = {split_tf32(kp[0]), split_tf32(kp[4 * pK])};
          mma_3xtf32_add(acc[0][nt], a[0], bf);
          mma_3xtf32_add(acc[1][nt], a[1], bf);
        }
      }
    }
    __syncthreads();  // every warp is done with the query tile and the mk chunks
    valid_bits = 0;
#pragma unroll
    for (int nt = 0; nt < T::kTilesS; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = cb * T::W2p + col0 + 8 * nt + e;
        if (j < W2 && vd[j]) valid_bits |= 1u << (2 * nt + e);
      }
  };

  // ---- 2a. the row maxima over the valid bases of the block, joint over the
  // blocks; rows r = 32 wm + 16 mt + 8 h + g; acc[mt][nt][2 h + e] is (row r,
  // column col0 + 8 nt + e)
  auto block_max = [&](bool first) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < T::kTilesS; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (valid_bits >> (2 * nt + e) & 1u) x = fmaxf(x, acc[mt][nt][2 * h + e]);
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        if (t == 0) part[wn * kRows + 32 * wm + 16 * mt + 8 * h + g] = x;
      }
    __syncthreads();
    if (threadIdx.x < kRows) {
      float x = part[threadIdx.x];
      for (int w = 1; w < T::kWarpsN; ++w) x = fmaxf(x, part[w * kRows + threadIdx.x]);
      row_max[threadIdx.x] = first ? x : fmaxf(row_max[threadIdx.x], x);
    }
    __syncthreads();
  };
  const int nb = T::kBlocked ? (W2 + T::W2p - 1) / T::W2p : 1;
  for (int cb = 0; cb < nb; ++cb) {  // at nb = 1, acc keeps block 0's affinity
    affinity(cb);
    block_max(cb == 0);
  }

  float* S = SK;  // S[r * pS + j], j the column in the block
  float* ea = exp_aff + obj * Lm * P;
  // exp((a - max) / tau) as exp2((a - max) * log2(e) / tau): a multiply for
  // the division, within a few ulp of the plain version's exponential
  const float scale = 1.4426950408889634f / tau;
  float o[2][T::kTilesO][4] = {};
  for (int cb = 0; cb < nb; ++cb) {
    if (nb > 1) affinity(cb);
    const int j0 = cb * T::W2p, nj = round_up(min(W2 - j0, T::W2p), kJc) / kJc;
    // the block's first mv chunk loads (over the dead query tile) during the softmax
    auto load_v = [&](int chunk) {
      float* vsm = U + (chunk & 1) * kCols * kVP;
      for (int i = threadIdx.x; i < kCols * (kJc / 4); i += kThreads) {
        const int vv = i / (kJc / 4), jj = 4 * (i % (kJc / 4)), j = j0 + chunk * kJc + jj;
        const int v = v0 + vv;
        const bool ok = v < Cv && j < W2;
        const int s = j >= Lm;
        cp_async16(vsm + vv * kVP + jj, ok ? vb + ((size_t)s * Cv + v) * Lm + (j - s * Lm) : vb,
                   ok);
      }
    };
    load_v(0);
    cp_async_commit();

    // ---- 2b. the block's exponentials against the joint maxima, its row sums
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 32 * wm + 16 * mt + 8 * h + g, p = p0 + r;
        const float mx = row_max[r];
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < T::kTilesS; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = col0 + 8 * nt + e;
            const bool ok = valid_bits >> (2 * nt + e) & 1u;
            const float x = ok ? exp2f((acc[mt][nt][2 * h + e] - mx) * scale) : 0.f;
            S[r * pS + j] = x;
            sum += x;
            if (vs == 0 && p < P && j0 + j < W2) ea[(size_t)(j0 + j) * P + p] = x;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (t == 0) part[wn * kRows + r] = sum;
      }
    __syncthreads();
    if (threadIdx.x < kRows) {
      float x = part[threadIdx.x];
      for (int w = 1; w < T::kWarpsN; ++w) x += part[w * kRows + threadIdx.x];
      if (cb > 0) x += row_sum[threadIdx.x];
      row_sum[threadIdx.x] = cb == nb - 1 ? x + 1e-30f : x;
    }

    // ---- 3. value read: out (kRows x 256) += e (kRows x W2p) . mv^T (W2p x 256)
    // over the block; warp (wm, wn) owns rows 32 wm .. 32 wm + 31, columns
    // wn * 8 kTilesO ..
    for (int jc = 0; jc < nj; ++jc) {
      cp_async_wait<0>();
      __syncthreads();  // chunk jc is in; every warp is done with the other buffer
      if (jc + 1 < nj) load_v(jc + 1);
      cp_async_commit();
      const float* vsm = U + (jc & 1) * kCols * kVP + (wn * 8 * T::kTilesO + g) * kVP + t;
      float pc[2][T::kTilesO][4] = {};  // this chunk's sums, in the tensor cores' accumulator
#pragma unroll
      for (int k8 = 0; k8 < kJc; k8 += 8) {
        SplitTf32 a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* sa = S + (32 * wm + 16 * mt + g) * pS + jc * kJc + k8 + t;
          a[mt][0] = split_tf32(sa[0]);
          a[mt][1] = split_tf32(sa[8 * pS]);
          a[mt][2] = split_tf32(sa[4]);
          a[mt][3] = split_tf32(sa[8 * pS + 4]);
        }
#pragma unroll
        for (int nt = 0; nt < T::kTilesO; ++nt) {
          const float* vp = vsm + 8 * nt * kVP + k8;
          const SplitTf32 bf[2] = {split_tf32(vp[0]), split_tf32(vp[4])};
          mma_3xtf32_acc(pc[0][nt], a[0], bf);
          mma_3xtf32_acc(pc[1][nt], a[1], bf);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < T::kTilesO; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) o[mt][nt][i] += pc[mt][nt][i];
    }
  }
  float* ob = out + ((size_t)b * (G / 2) + n) * P * Cv;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 32 * wm + 16 * mt + 8 * h + g, p = p0 + r;
      if (p >= P) continue;
      const float rs = row_sum[r];
#pragma unroll
      for (int nt = 0; nt < T::kTilesO; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int v = v0 + wn * 8 * T::kTilesO + 8 * nt + 2 * t + e;
          if (v < Cv) ob[(size_t)p * Cv + v] = o[mt][nt][2 * h + e] / rs;
        }
    }
}

constexpr int kMaxDevices = 64;

// CUDA keeps a kernel's attributes per device: each instantiation sets its
// shared-memory limit once on each device, and every call checks the result
template <int NT, bool kNarrow>
cudaError_t setup_device(int dev) {
  static std::once_flag once[kMaxDevices];
  static cudaError_t err[kMaxDevices];
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(once[dev], [dev] {
    err[dev] = cudaFuncSetAttribute(read_kernel<NT, kNarrow>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  });
  return err[dev];
}

template <int NT, bool kNarrow>
cudaError_t launch(const float* qk, const float* mk, const float* mv, const unsigned char* valid,
                   float* out, float* exp_aff, int B, int G, int P, int C, int Cv, int Lm,
                   float tau, cudaStream_t stream) {
  int dev;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = setup_device<NT, kNarrow>(dev)) != cudaSuccess) return err;
  const size_t smem = Tiling<NT>::smem_bytes(C);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  constexpr int kRows = Tiling<NT>::kRows;
  const dim3 grid(((P + kRows - 1) / kRows) * ((Cv + kCols - 1) / kCols), G / 2, B);
  read_kernel<NT, kNarrow><<<grid, kThreads, smem, stream>>>(qk, mk, mv, valid, out, exp_aff,
                                                             P, C, Cv, Lm, G, tau);
  return cudaGetLastError();
}

}  // namespace
}  // namespace swem

extern "C" const char* swem_read_memory_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Runs the read on `stream`, on the current device. Returns the first CUDA
// error, or 0; a shape the kernel does not take returns cudaErrorInvalidValue.
extern "C" int swem_read_memory(const float* qk, const float* mk, const float* mv,
                                const unsigned char* valid, float* out, float* exp_aff,
                                int B, int G, int P, int C, int Cv, int Lm, float tau,
                                void* stream_ptr) {
  using namespace swem;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (C % 4 != 0 || Lm % 4 != 0 || Lm <= 0 || C <= 0) return cudaErrorInvalidValue;
  const bool narrow = C <= kExactC;
  if (2 * Lm <= 512 && Tiling<8>::smem_bytes(C) <= (size_t)kMaxSmem)
    return (narrow ? launch<8, true> : launch<8, false>)(qk, mk, mv, valid, out, exp_aff, B, G,
                                                         P, C, Cv, Lm, tau, stream);
  return (narrow ? launch<16, true> : launch<16, false>)(qk, mk, mv, valid, out, exp_aff, B, G,
                                                         P, C, Cv, Lm, tau, stream);
}
