// The Sequential Weighted EM loop of one memorize: one persistent cooperative
// launch on Hopper's tensor cores in 3xTF32.
//
// Replaces the TPU kernel swem_tpu/ops/em_pallas.py::_em_kernel (reached
// through em_loop_pallas -> _em_loop_impl). For each batch row and object it
// runs n_iters rounds of
//   W (not before the first E): per-object {bg, fg} coupling of the pixel weights,
//   E: z = softmax_L(x . l2norm(kappa) / tau) * weights,
//   M: zita = zita0 + sum_p z,  kappa = (zita0 * kappa0 + x^T z) / zita,
// and writes the last z, kappa and zita.
//
// Phases, separated by grid barriers (grid_sync), every CTA looping over the
// work items of each phase, so any P and N fit:
//   prep    column items: khat = l2norm(kappa0), written fragment-packed for
//           the tile phase's B operand. Each CTA stages its first x tile now.
//   per round:
//   (a) tile items (32-pixel tile x object x batch row): the affinity
//       S = x_tile . khat against both branches' 2L columns, once; the W step
//       reads it as S / |x| and the E step as S / tau, in one pass of
//       exponentials over the rows (4 rows per warp at once). z stays in
//       shared memory; then the tile's M-step partials x_tile^T z_tile
//       (Ck x 2L) and sum_p z_tile go to buffers indexed by pixel tile. Only
//       the last round writes z (B, N, 2, P, L).
//   (b) column items (4 columns of kappa x object x batch row): the partials
//       added over the pixel tiles in tile order, kappa and zita formed, each
//       column normalized once and written as the next round's khat (the last
//       round writes kappa and zita instead).
// That is 2 n_iters grid barriers per call (8 at 4 rounds). A barrier is an
// arrival counter in device memory (the cooperative-groups scheme: CTA 0
// adds 2^31 - (grid - 1), the others 1, so the top bit flips when all have
// arrived); its only atomics are the arrivals. The partials are indexed and
// added by pixel tile, never by CTA, so the bits are the same on every run and
// for every grid size.
//
// Both products go through mma.sync m16n8k8 in 3xTF32 (mma_tf32.cuh): each
// 8-deep product starts from zero and is added on the CUDA cores, since the
// tensor cores' own accumulator does not round to nearest. x's tile is split
// into its TF32 planes once when it is staged (kept across rounds while a CTA
// keeps its tile), in two layouts: pixel rows (A of the affinity) and channel
// rows (A of the M step); khat and z are split as their fragments load.
//
// Flagship shape (B = 1, N = 2, P = 1620, Ck = 128, L = 128): 102 tile items
// and 128 column items, so 128 CTAs of 8 warps (the grid is the larger item
// count, at most every CTA the card holds at once: one per SM), 104,576 bytes
// of shared memory each (137,344 at L = 256). Per round the CTAs exchange
// through L2 about 40 MB: each tile item reads its object's 128 KiB of khat
// (13.4 MB), and the partials (51 tiles x 2 objects x 128 x 256 floats,
// 13.4 MB) are written and read back.
//
// Shapes: the kernel takes Ck % 16 == 0 and L % 8 == 0; the wrapper pads
// other widths (zero channels; bases with kappa0 = 0, zita0 = 1) and passes
// the count of real bases Lr, past which the E step's and the W step's
// softmaxes take nothing (z = 0 there, so the padded columns' partials are 0
// and their kappa stays 0). A CTA's shared memory grows with the pixel tile
// times (4 Ck + 2 L): where the 32-pixel tile does not fit the 232,448
// bytes of a block (Ck 512 at any L, or Ck 256 with L 512), the kernel runs
// in 16-pixel tiles (one m-tile of the products), which fit up to Ck 512
// with L 512; the wrapper picks the tile and the launcher checks it.
//
// What bounds it: operations, by the least work. The loop is 8 GEMMs of
// 2 P Ck 4L (1.70 GFLOP at 4 rounds; the W step's product is the next E
// step's): 0.0254 ms at the H100 SXM's 67 TFLOP/s of FP32 on the CUDA cores,
// 0.0103 ms for this route's 3 x 1.70 GFLOP at 495 TFLOP/s of dense TF32,
// against 0.0014 ms for its 4.7 MB of inputs and outputs at 3.35 TB/s. The
// design spends more than that in the L2 exchange above, in the grid
// barriers, and in mma.sync's register operands (each element split there).
#include <math.h>

#include <mutex>

#include "mma_tf32.cuh"

namespace swem {
namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kNB = 4;         // 8-column n-tiles a warp holds at once
constexpr int kCols = 4;       // kappa columns per column item
constexpr int kBatch = 32;     // partial loads in flight per thread in the column phase
constexpr int kStages = 2;     // k-step pairs of khat in flight per warp in the affinity
constexpr int kMaxSmem = 232448;  // an H100 block's dynamic shared memory

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// The pixel tile of a tile item: 32 pixels (two 16-row m-tiles) or 16 (one).
template <int TILE>
struct Tile {
  static constexpr int kMT = TILE / 16;            // 16-row m-tiles of the affinity
  static constexpr int kK8 = TILE / 8;             // 8-pixel k-steps of the M-step product
  static constexpr int kRows = TILE / kWarps;      // pixel rows per warp in the softmax
  static constexpr int kGroups = kThreads / TILE;  // channel groups when staging x
};

// Shared memory, in 32-bit words. Pitches make every fragment load
// conflict-free: pA is 4 mod 32, pT 4 mod 32 (tile 32) or 20 (tile 16) (A
// operands), pS 8 mod 32 (z as B).
template <int kTile>
struct Smem {
  int C, W2;
  __host__ __device__ int pA() const { return round_up(C, 32) + 4; }  // x planes, pixel rows
  static constexpr int pT = kTile + 4;                                 // x planes, channel rows
  __host__ __device__ int pS() const { return round_up(W2, 32) + 8; }  // S, then z
  __host__ __device__ int xa() const { return 0; }                     // 2 planes of kTile x pA
  __host__ __device__ int xt() const { return 2 * kTile * pA(); }      // 2 planes of C x pT
  __host__ __device__ int s() const { return xt() + 2 * C * pT; }
  // the column phase reuses S's region: kCols x C kappa values, kCols norms and zita
  __host__ __device__ int s_words() const { return imax(kTile * pS(), kCols * (C + 2)); }
  __host__ __device__ int xinv() const { return s() + s_words(); }
  __host__ __device__ size_t bytes() const { return sizeof(float) * ((size_t)xinv() + kTile); }
};

struct Params {
  const float* x;       // (B, P, C)
  const float* masks;   // (B, N, 2, P)
  const float* kappa0;  // (B, N, 2, C, L)
  const float* zita0;   // (B, N, 2, L)
  float* z;             // (B, N, 2, P, L), last round
  float* kappa;         // (B, N, 2, C, L)
  float* zita;          // (B, N, 2, L)
  // scratch, written and read inside the launch (so never through the
  // read-only path; loads of it bypass L1 with __ldcg):
  float* khat;   // (B, N, C/16, 2L/8, 32 lanes, 4): B fragments of two k-steps
  float* part;   // (B, N, tiles, 2L, C): x^T z per pixel tile, by column
  float* zpart;  // (B, N, tiles, 2L)
  unsigned int* bar;  // grid barrier counter, 0 before the first launch
  int B, N, P, C, L, Lr, n_iters;  // L padded to a multiple of 8, of which Lr are real
  float tau;
};

// Cycle checkpoints, compiled only with -DSWEM_EM_CYCLES (scripts/
// em_loop_variants.py --cycles): thread 0 of CTA 0 adds the clock64 cycles
// since the previous checkpoint to slot k, after a block barrier; the slots
// go to em_cycles when the launch ends. Slots: 0 prep phase and its barrier;
// tile item 1 x staging, 2 affinity, 3 W and E steps, 4 partials; column
// item 5 partial loads, 6 zita, 7 kappa and norms, 8 writes; 9 and 10 the
// waits at the barriers after the tile and column phases.
#ifdef SWEM_EM_CYCLES
}  // namespace
__device__ long long em_cycles[11];
namespace {
__shared__ long long em_mark, em_slots[11];
#define CHECKPOINT(k)                                             \
  do {                                                            \
    __syncthreads();                                              \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                    \
      const long long now = clock64();                            \
      em_slots[k] += now - em_mark;                               \
      em_mark = now;                                              \
    }                                                             \
  } while (0)
#else
#define CHECKPOINT(k) \
  do {                \
  } while (0)
#endif

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

// Every CTA of the (co-resident) grid waits here until all have arrived.
__device__ __forceinline__ void grid_sync(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();  // this CTA's writes before its arrival
    const unsigned int old = atomicAdd(bar, add);
    while (((old ^ *(volatile unsigned int*)bar) & 0x80000000u) == 0) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ SplitTf32 plane_pair(const uint32_t* big, const uint32_t* small, int i) {
  return {big[i], small[i]};
}

// Stage pixel tile `tile` of batch row b: x split into TF32 planes in both
// layouts (zero past P), and 1 / (|x| + 1e-6) per pixel. Thread i takes
// pixel row i % kTile and every kGroups-th 4-channel group from i / kTile
// (at tile 32: lane r row r, warp w the groups from w), so the channel-row
// stores are conflict-free; uses S's region.
template <int kTile>
__device__ void stage_x(const Params& p, float* smem, const Smem<kTile>& sm, int b, int tile) {
  constexpr int kGroups = Tile<kTile>::kGroups, pT = Smem<kTile>::pT;
  uint32_t* xab = reinterpret_cast<uint32_t*>(smem + sm.xa());
  uint32_t* xas = xab + kTile * sm.pA();
  uint32_t* xtb = reinterpret_cast<uint32_t*>(smem + sm.xt());
  uint32_t* xts = xtb + p.C * pT;
  float* red = smem + sm.s();  // kGroups x kTile partial sums of squares
  const int C = p.C, pA = sm.pA(), row = threadIdx.x % kTile, grp = threadIdx.x / kTile;
  const int px = tile * kTile + row;
  const float4* xr = reinterpret_cast<const float4*>(p.x + ((size_t)b * p.P + px) * C);
  float ss = 0.f;
#pragma unroll 4
  for (int c4 = grp; c4 < C / 4; c4 += kGroups) {
    const float4 v = px < p.P ? __ldg(xr + c4) : make_float4(0.f, 0.f, 0.f, 0.f);
    const float f[4] = {v.x, v.y, v.z, v.w};
    uint32_t big[4], small[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      ss = fmaf(f[q], f[q], ss);
      const SplitTf32 h = split_tf32(f[q]);
      big[q] = h.big;
      small[q] = h.small;
      xtb[(4 * c4 + q) * pT + row] = h.big;
      xts[(4 * c4 + q) * pT + row] = h.small;
    }
    *reinterpret_cast<uint4*>(xab + row * pA + 4 * c4) = make_uint4(big[0], big[1], big[2], big[3]);
    *reinterpret_cast<uint4*>(xas + row * pA + 4 * c4) =
        make_uint4(small[0], small[1], small[2], small[3]);
  }
  red[grp * kTile + row] = ss;
  __syncthreads();
  if (threadIdx.x < kTile) {
    float t = 0.f;
    for (int w = 0; w < kGroups; ++w) t += red[w * kTile + threadIdx.x];
    smem[sm.xinv() + threadIdx.x] = 1.f / (sqrtf(t) + 1e-6f);
  }
}

// Tile item: affinity, W and E steps, and the tile's M-step partials.
template <int kTile>
__device__ void tile_item(const Params& p, float* smem, const Smem<kTile>& sm, int item, int it,
                          int& staged) {
  using Tl = Tile<kTile>;
  constexpr int kRows = Tl::kRows, kMT = Tl::kMT, kK8 = Tl::kK8, pT = Smem<kTile>::pT;
  const int N = p.N, C = p.C, W2 = 2 * p.L, NT = W2 / 8, MT = C / 16, KP = C / 16;
  const int n_tiles = (p.P + kTile - 1) / kTile;
  const int n = item % N, bt = item / N, tile = bt % n_tiles, b = bt / n_tiles;
  const int bn = b * N + n, p0 = tile * kTile;
  const bool last = it == p.n_iters - 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int pA = sm.pA(), pS = sm.pS();
  const uint32_t* xab = reinterpret_cast<const uint32_t*>(smem + sm.xa());
  const uint32_t* xas = xab + kTile * pA;
  const uint32_t* xtb = reinterpret_cast<const uint32_t*>(smem + sm.xt());
  const uint32_t* xts = xtb + C * pT;
  float* S = smem + sm.s();
  const float* xinv = smem + sm.xinv();

  __syncthreads();  // the previous item is done with shared memory
  if (staged != bt) {
    stage_x(p, smem, sm, b, tile);
    staged = bt;
    __syncthreads();
  }
  CHECKPOINT(1);
  float w[kRows][2];  // pixel weights of this warp's rows: the masks, 0 past P
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int px = p0 + warp + kWarps * i;
#pragma unroll
    for (int s = 0; s < 2; ++s) w[i][s] = px < p.P ? p.masks[((size_t)bn * 2 + s) * p.P + px] : 0.f;
  }

  // ---- affinity S (32 x 2L) = x_tile . khat; warp holds n-tiles base + warp + 8 nb
  const float4* kh = reinterpret_cast<const float4*>(p.khat) + (size_t)bn * KP * NT * 32 + lane;
  for (int base = 0; base < NT; base += kWarps * kNB) {
    float acc[kMT][kNB][4] = {};
    // a ring of kStages k-step pairs of B fragments, loaded from L2 ahead of use
    float4 bq[kStages][kNB];
    auto load_b = [&](float4 (&dst)[kNB], int kp) {
      if (kp >= KP) return;
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
        const int nt = base + warp + kWarps * nb;
        dst[nb] = nt < NT ? __ldcg(kh + ((size_t)kp * NT + nt) * 32) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    };
#pragma unroll
    for (int st = 0; st < kStages; ++st) load_b(bq[st], st);
    for (int kp0 = 0; kp0 < KP; kp0 += kStages) {
#pragma unroll
      for (int st = 0; st < kStages; ++st) {
        const int kp = kp0 + st;
        if (kp >= KP) break;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int k0 = 16 * kp + 8 * q;
          SplitTf32 a[kMT][4];
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            const int i = (16 * mt + g) * pA + k0 + t;
            a[mt][0] = plane_pair(xab, xas, i);
            a[mt][1] = plane_pair(xab, xas, i + 8 * pA);
            a[mt][2] = plane_pair(xab, xas, i + 4);
            a[mt][3] = plane_pair(xab, xas, i + 8 * pA + 4);
          }
#pragma unroll
          for (int nb = 0; nb < kNB; ++nb) {
            if (base + warp + kWarps * nb >= NT) continue;
            const float4 v = bq[st][nb];
            const SplitTf32 bf[2] = {split_tf32(q ? v.z : v.x), split_tf32(q ? v.w : v.y)};
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) mma_3xtf32_add(acc[mt][nb], a[mt], bf);
          }
        }
        load_b(bq[st], kp + kStages);
      }
    }
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      const int nt = base + warp + kWarps * nb;
      if (nt >= NT) continue;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        float* s0 = S + (16 * mt + g) * pS + 8 * nt + 2 * t;
        *reinterpret_cast<float2*>(s0) = make_float2(acc[mt][nb][0], acc[mt][nb][1]);
        *reinterpret_cast<float2*>(s0 + 8 * pS) = make_float2(acc[mt][nb][2], acc[mt][nb][3]);
      }
    }
  }
  __syncthreads();
  CHECKPOINT(2);

  // ---- W and E steps: warp w takes rows w + 8 i, all kRows at once, so their
  // reductions overlap. z overwrites S; rows past P have weight 0, so z = 0.
  // Division by tau is a multiplication by 1 / tau (within an ulp of it), and
  // max_l(S) / tau is max_l(S / tau), as rounding keeps the order. Only the
  // Lr real bases of each branch enter the maxima and the sums; the padded
  // ones get z = 0.
  const float inv_tau = 1.f / p.tau;
  const int Lb = p.L, Lr = p.Lr;
  float* Srow[kRows];
  float mx[kRows][2];  // max over each branch's L raw affinities
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    Srow[i] = S + (warp + kWarps * i) * pS;
    mx[i][0] = mx[i][1] = -INFINITY;
  }
  for (int l = lane; l < Lr; l += 32)
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int s = 0; s < 2; ++s) mx[i][s] = fmaxf(mx[i][s], Srow[i][s * Lb + l]);
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int s = 0; s < 2; ++s) mx[i][s] = warp_max(mx[i][s]);
  // one pass for the exponentials of both steps: the W step of the previous
  // round (S / |x|, from round 1 on) and this round's E step (S / tau)
  float xi[kRows], m[kRows], e[kRows][2], sum[kRows][2];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    xi[i] = xinv[warp + kWarps * i];
    m[i] = fmaxf(mx[i][0], mx[i][1]) * xi[i];  // max_j (S_j / |x|)
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      e[i][s] = sum[i][s] = 0.f;
      mx[i][s] *= inv_tau;
    }
  }
  for (int l = lane; l < Lr; l += 32)
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const float a = Srow[i][s * Lb + l];
        if (it > 0) e[i][s] += expf((a * xi[i] - m[i]) * inv_tau);
        const float v = expf(a * inv_tau - mx[i][s]);
        Srow[i][s * Lb + l] = v;
        sum[i][s] += v;
      }
  if (it > 0)
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float e0 = warp_sum(e[i][0]), e1 = warp_sum(e[i][1]), tot = e0 + e1;
      w[i][0] *= 1.f - e0 / tot;
      w[i][1] *= 1.f - e1 / tot;
    }
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int s = 0; s < 2; ++s) sum[i][s] = w[i][s] / warp_sum(sum[i][s]);
  for (int l = lane; l < Lb; l += 32)
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int px = p0 + warp + kWarps * i;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const float v = l < Lr ? Srow[i][s * Lb + l] * sum[i][s] : 0.f;
        Srow[i][s * Lb + l] = v;
        if (last && px < p.P) p.z[(((size_t)bn * 2 + s) * p.P + px) * Lb + l] = v;
      }
    }
  __syncthreads();
  CHECKPOINT(3);

  // ---- the tile's partials: sum_p z, and x_tile^T z_tile (C x 2L), stored by column
  const size_t slot = (size_t)bn * n_tiles + tile;
  for (int j = threadIdx.x; j < W2; j += kThreads) {
    float acc = 0.f;
    for (int r = 0; r < kTile; ++r) acc += S[r * pS + j];
    p.zpart[slot * W2 + j] = acc;
  }
  float* part = p.part + (slot * W2 + 2 * t) * C + g;  // part[slot][j][c]
  for (int base = 0; base < NT; base += kWarps * kNB) {
    SplitTf32 bz[kK8][kNB][2];  // z as B: k = pixel 8 k + t (+4), n = column
#pragma unroll
    for (int k = 0; k < kK8; ++k)
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
        const int col = 8 * imax(0, min(base + warp + kWarps * nb, NT - 1)) + g;
        bz[k][nb][0] = split_tf32(S[(8 * k + t) * pS + col]);
        bz[k][nb][1] = split_tf32(S[(8 * k + t + 4) * pS + col]);
      }
    for (int mt = 0; mt < MT; ++mt) {
      SplitTf32 a[kK8][4];  // x^T as A: rows = channels 16 mt + g (+8), k = pixels
#pragma unroll
      for (int k = 0; k < kK8; ++k) {
        const int i = (16 * mt + g) * pT + 8 * k + t;
        a[k][0] = plane_pair(xtb, xts, i);
        a[k][1] = plane_pair(xtb, xts, i + 8 * pT);
        a[k][2] = plane_pair(xtb, xts, i + 4);
        a[k][3] = plane_pair(xtb, xts, i + 8 * pT + 4);
      }
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
        const int nt = base + warp + kWarps * nb;
        if (nt >= NT) continue;
        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int k = 0; k < kK8; ++k) mma_3xtf32_add(d, a[k], bz[k][nb]);
        float* pc = part + (size_t)8 * nt * C + 16 * mt;
        pc[0] = d[0];
        pc[C] = d[1];
        pc[8] = d[2];
        pc[C + 8] = d[3];
      }
    }
  }
  CHECKPOINT(4);
}

// Column item: kCols columns (one branch) of one object. mode 0: khat from
// kappa0; 1: add the partials, khat for the next round; 2: add the
// partials, write kappa and zita.
template <int kTile>
__device__ void column_item(const Params& p, float* smem, const Smem<kTile>& sm, int item,
                            int mode) {
  const int C = p.C, W2 = 2 * p.L, NT = W2 / 8, KP = C / 16;
  const int n_tiles = (p.P + kTile - 1) / kTile;
  const int bn = item / (W2 / kCols), j0 = kCols * (item % (W2 / kCols)), s = j0 / p.L;
  const int l0 = j0 - s * p.L;
  const size_t bns = (size_t)bn * 2 + s;  // (b, n, s)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* kap = smem + sm.s();  // kap[jj * C + c]
  float* invn = kap + kCols * C;
  float* zt = invn + kCols;

  __syncthreads();  // the previous item is done with shared memory
  // The tiles' partials are added in tile order. Warp w < kCols also adds
  // column w's sums of z; its first 64 tiles load before the partials, and
  // kappa0 and zita0 with them, so the latencies overlap.
  const bool zita_warp = mode > 0 && warp < kCols;
  const float* zsrc = p.zpart + (size_t)bn * n_tiles * W2 + j0 + warp;  // tile stride W2
  float zv0 = 0.f, zv1 = 0.f;
  if (zita_warp) {
    if (lane < n_tiles) zv0 = __ldcg(zsrc + (size_t)lane * W2);
    if (32 + lane < n_tiles) zv1 = __ldcg(zsrc + (size_t)(32 + lane) * W2);
  }
  for (int i = threadIdx.x; i < kCols * C; i += kThreads) {
    const int jj = i / C, c = i - jj * C;
    const float k0 = p.kappa0[(bns * C + c) * p.L + l0 + jj];
    if (mode == 0) {
      kap[i] = k0;
      continue;
    }
    const float z0 = p.zita0[bns * p.L + l0 + jj];
    const float* src = p.part + ((size_t)bn * n_tiles * W2 + j0 + jj) * C + c;
    float acc = 0.f;
    for (int t0 = 0; t0 < n_tiles; t0 += kBatch) {
      float v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (t0 + k < n_tiles) v[k] = __ldcg(src + (size_t)(t0 + k) * W2 * C);
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (t0 + k < n_tiles) acc += v[k];
    }
    kap[i] = z0 * k0 + acc;  // divided by zita below
  }
  CHECKPOINT(5);
  if (zita_warp) {  // lane k holds tile t0 + k; added in order
    float acc = 0.f;
    for (int t0 = 0; t0 < n_tiles; t0 += 32) {
      float v = t0 == 0 ? zv0 : zv1;
      if (t0 >= 64) v = t0 + lane < n_tiles ? __ldcg(zsrc + (size_t)(t0 + lane) * W2) : 0.f;
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const float u = __shfl_sync(0xffffffffu, v, k);
        if (t0 + k < n_tiles) acc += u;
      }
    }
    if (lane == 0) {
      const float v = p.zita0[bns * p.L + l0 + warp] + acc;
      zt[warp] = v;
      if (mode == 2) p.zita[bns * p.L + l0 + warp] = v;
    }
  }
  __syncthreads();
  CHECKPOINT(6);
  for (int jj = warp; jj < kCols; jj += kWarps) {  // warp w: column w's kappa and its norm
    float ss = 0.f;
    for (int c = lane; c < C; c += 32) {
      float v = kap[jj * C + c];
      if (mode > 0) kap[jj * C + c] = v = v / zt[jj];
      ss = fmaf(v, v, ss);
    }
    ss = warp_sum(ss);
    if (lane == 0) invn[jj] = 1.f / (sqrtf(ss) + 1e-6f);
  }
  __syncthreads();
  CHECKPOINT(7);
  for (int i = threadIdx.x; i < kCols * C; i += kThreads) {
    const int jj = i / C, c = i - jj * C;
    if (mode == 2) {
      p.kappa[(bns * C + c) * p.L + l0 + jj] = kap[i];
    } else {  // khat[c][j] as element (k = c % 8, n = j % 8) of k-step c / 8's B fragment
      const int j = j0 + jj, kk = c % 8, ln = 4 * (j % 8) + kk % 4;
      const int slot = 2 * ((c / 8) % 2) + kk / 4;
      p.khat[((((size_t)bn * KP + c / 16) * NT + j / 8) * 32 + ln) * 4 + slot] = kap[i] * invn[jj];
    }
  }
  CHECKPOINT(8);
}

template <int kTile>
__global__ void __launch_bounds__(kThreads, 1) em_loop_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const Smem<kTile> sm{p.C, 2 * p.L};
  const int n_tiles = (p.P + kTile - 1) / kTile;
  const int tile_items = p.B * p.N * n_tiles, column_items = p.B * p.N * (2 * p.L / kCols);
#ifdef SWEM_EM_CYCLES
  if (threadIdx.x < 11) em_slots[threadIdx.x] = 0;
  if (threadIdx.x == 0) em_mark = clock64();
#endif
  // the x planes of this CTA's first tile item load during the prep phase
  int staged = -1;  // (b, tile) whose x planes are in shared memory
  if (blockIdx.x < tile_items) {
    staged = blockIdx.x / p.N;
    stage_x(p, smem, sm, staged / n_tiles, staged % n_tiles);
  }
  for (int item = blockIdx.x; item < column_items; item += gridDim.x)
    column_item(p, smem, sm, item, 0);
  grid_sync(p.bar);
  CHECKPOINT(0);
  for (int it = 0; it < p.n_iters; ++it) {
    const bool last = it == p.n_iters - 1;
    for (int item = blockIdx.x; item < tile_items; item += gridDim.x)
      tile_item(p, smem, sm, item, it, staged);
    grid_sync(p.bar);
    CHECKPOINT(9);
    for (int item = blockIdx.x; item < column_items; item += gridDim.x)
      column_item(p, smem, sm, item, last ? 2 : 1);
    if (!last) grid_sync(p.bar);
    CHECKPOINT(10);
  }
#ifdef SWEM_EM_CYCLES
  if (blockIdx.x == 0 && threadIdx.x < 11) em_cycles[threadIdx.x] = em_slots[threadIdx.x];
#endif
}

// CUDA keeps a kernel's attributes per device: each device sets each
// instantiation's shared-memory limit once (all of a block's shared memory
// but the static part, which only the cycle checkpoints use), and every call
// checks the result
constexpr int kMaxDevices = 64;
struct DeviceSetup {
  std::once_flag once;
  cudaError_t err = cudaSuccess;
  int static_smem = 0;
};

template <int kTile>
cudaError_t setup_device(int dev, int* static_smem) {
  static DeviceSetup device_setup[kMaxDevices];
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceSetup& s = device_setup[dev];
  std::call_once(s.once, [&s] {
    cudaFuncAttributes fa;
    s.err = cudaFuncGetAttributes(&fa, em_loop_kernel<kTile>);
    if (s.err != cudaSuccess) return;
    s.static_smem = (int)fa.sharedSizeBytes;
    s.err = cudaFuncSetAttribute(em_loop_kernel<kTile>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxSmem - s.static_smem);
  });
  *static_smem = s.static_smem;
  return s.err;
}

template <int kTile>
cudaError_t launch(const Params& params, cudaStream_t stream) {
  int dev, static_smem, coop, n_sm, per_sm;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = setup_device<kTile>(dev, &static_smem)) != cudaSuccess) return err;
  const size_t smem = Smem<kTile>{params.C, 2 * params.L}.bytes();
  if (smem + static_smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, em_loop_kernel<kTile>,
                                                           kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  const int BN = params.B * params.N;
  const int items = imax(BN * ((params.P + kTile - 1) / kTile), BN * (2 * params.L / kCols));
  const int grid = items < per_sm * n_sm ? items : per_sm * n_sm;
  Params p = params;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(em_loop_kernel<kTile>), dim3(grid),
                                    dim3(kThreads), args, smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace
}  // namespace swem

#ifdef SWEM_EM_CYCLES
extern "C" int swem_em_loop_cycles(long long* out) {
  return cudaMemcpyFromSymbol(out, swem::em_cycles, sizeof(swem::em_cycles));
}
#endif

extern "C" const char* swem_em_loop_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Runs the whole loop on `stream`, on the current device, as one cooperative
// launch in `tile`-pixel tiles (32 or 16). Shapes: x (B, P, C); masks (B, N,
// 2, P); kappa0 and kappa (B, N, 2, C, L); zita0 and zita (B, N, 2, L); z (B,
// N, 2, P, L); scratch khat (B N C 2L floats), part (B N ceil(P / tile) C 2L),
// zpart (B N ceil(P / tile) 2L); bar one word, 0 before the first call and
// left so by every call. The first Lr of the L bases are real (the rest
// padding). Returns the first CUDA error, or 0; cudaErrorNotSupported if the
// device cannot launch cooperatively, cudaErrorInvalidValue for a shape the
// kernel does not take.
extern "C" int swem_em_loop(const float* x, const float* masks, const float* kappa0,
                            const float* zita0, float* z, float* kappa, float* zita, float* khat,
                            float* part, float* zpart, unsigned int* bar, int B, int N, int P,
                            int C, int L, int Lr, int tile, int n_iters, float tau,
                            void* stream_ptr) {
  using namespace swem;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B < 1 || N < 1 || P < 1 || C < 16 || C % 16 || L < 8 || L % 8 || Lr < 1 || Lr > L ||
      n_iters < 1)
    return cudaErrorInvalidValue;
  const Params params{x, masks, kappa0, zita0, z, kappa, zita, khat, part, zpart, bar,
                      B, N, P, C, L, Lr, n_iters, tau};
  if (tile == 32) return launch<32>(params, stream);
  if (tile == 16) return launch<16>(params, stream);
  return cudaErrorInvalidValue;
}
