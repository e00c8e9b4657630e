// Nearest-neighbour kernels for Hopper (sm_90a): K4 and K5 of the port.
//
// Replaces the two Pallas TPU kernels of toyslam_tpu/ops/nn_pallas.py:
//   nearest_neighbor  <- nearest_neighbor / _make_kernel(mode) (nn_pallas.py:197/104)
//   neg_dist_bf16     <- neg_dist_bf16 / _neg_dist_kernel      (nn_pallas.py:152/141)
//
// Both rank by the partial squared distance |t|^2 - 2 s.t. Wherever a
// value is returned or written it is f32 computed on the CUDA cores with
// every step rounded on its own (__fmul_rn / __fadd_rn: no FMA
// contraction), in the order of the plain PyTorch versions in
// ops/nn_kernels.py, whose separate elementwise ops round the same way. So
// on the card each kernel agrees with its plain version bit for bit.
//
// K4, nearest_neighbor: per source row, min over target columns of the
// plain value d_c = tsq_c - 2 (sx tx + sy ty + sz tz) and the first column
// that reaches it. The [N, M] matrix is never written; the inputs are a
// few hundred KB. What bounds it: the pairs (1.07e9 at 32768 x 32768). An
// exact f32 value costs ~10 FP32-pipe instructions a pair (no FMA), which
// held the CUDA-core design to 0.43 ms on an H100, 29 % of its f32 bound.
// So the tensor cores screen every pair and the CUDA cores rescore only
// the few columns that can win. What bounds this design: pass 1, which
// must see every pair (one mma per 128 pairs, one fminf a pair, and the
// staging of each chunk's B fragments), takes most of the time; pass 2
// visits a small share of the chunks, and its time is set by the warps
// whose rows lie far from their nearest neighbours (PERF.md, section 6).
// Its bound is its tensor-core work, 2 x 16-deep mma a pair (0.0695 ms at
// 32768 x 32768 and 989 TFLOP/s).
//
// Design: two passes over the target, each one mma.sync m16n8k16 bf16 per
// 16 rows x 8 columns (csrc/mma_split.cuh). The A operand of a row is the
// x3 split of u = -2 s, [u_hi | u_hi | u_lo], then 1, 1, 1; the B operand
// of a column is [t_hi ; t_lo ; t_hi ; tsq_hi ; tsq_mid ; tsq_lo] (tsq in
// three exact bf16 parts), zero-padded to depth 16. So the product is the
// screen, screen_c ~ tsq_c - 2 s.t_c, in one instruction.
// - A block owns 128 rows: 8 warps, 2 row groups of 64 rows (4 m16 tiles,
//   their A fragments in registers for both passes) x 4 column warps.
//   Column warp w takes the chunks of 64 columns w, w + 4, ... Each warp
//   stages its own chunk (f32 x, y, z, tsq for the rescoring and the B
//   fragments in fragment order, two columns a lane) and loads the next
//   one into registers while it works: no block barrier inside a pass, so
//   the warps never wait for each other there.
// - Pass 1 keeps a running fminf of the screen per row; the row's minimum
//   m comes from the quad's shuffles and the 4 column warps. The block also
//   takes T_i = max_c |t_ci| while it stages (invalid columns are zeroed by
//   target_operands, so T may run over all of them), and each warp keeps,
//   per chunk, a lower bound of screen + |s|^2 over its rows (Skip).
// - Pass 2 recomputes the screen on the chunks whose bound says they can
//   hold a candidate and rescores a column c in exact f32 when screen_c <=
//   vmax (the row's limit, below). A thread keeps the
//   lexicographic (value, column) minimum of what it rescored; the quad
//   and the column warps merge the same way, which is jnp.argmin's first
//   index. A NaN never wins; a row with no finite value gives (inf, 0), as
//   the CUDA-core design did. No cross-block reduction: deterministic.
// - Ragged edges are cut by count: columns past M are NaN in the staged
//   chunk (a NaN screen neither lowers m nor passes the test), rows past N
//   read zeros and get a NaN limit.
//
// Why it is exact. Let S = sum_i |s_i| T_i and, for column c, P_c =
// sum_i |s_i| |t_ci| <= S, x_c = tsq_c - 2 s.t_c (exact), u = 2^-24.
// - The plain value: |d_c - x_c| <= u |tsq_c| + 8.01 u P_c (three products,
//   two sums and the subtract, each rounded once).
// - The split: |x - x_hi| <= 2^-8 |x|, |x_lo| <= 2^-8 |x|, and the rest
//   x - x_hi - x_lo <= 2^-16 |x|; x3 drops s_hi t_r + s_lo t_lo + s_lo t_r
//   + s_r t, at most 3.01 2^-16 |s||t| a term, so 6.02 2^-16 P_c for u. The
//   tsq parts are exact.
// - The tensor core's sum: the products are exact, but it aligns them to
//   the largest and does not round each add (the D1 diagnostic: a deep sum
//   is rounded about once). Assumed: at most 2^-17 of the sum of the
//   magnitudes of its 12 nonzero terms, <= 1.01 |tsq_c| + 2.1 P_c (16
//   terms truncated at 2^-23 of the largest, and one final rounding, stay
//   under 2^-17.8 of it). Measured on D1's concat9, the same mma over the
//   same split: tests/test_torch_gpu.py asserts <= 2^-18 at +-200 m and
//   with rows at 1e9, and chip_smoke.py phase 10 prints the largest share
//   and fails above 2^-17.
// So |screen_c - d_c| <= 1.01 2^-17 |tsq_c| + 2^-13.16 P_c, and with 2x of
// slack E_c = alpha |tsq_c| + beta P_c <= alpha |tsq_c| + beta S, alpha =
// 2^-16, beta = 2^-12. Since
// |tsq_c| <= |x_c| + 2 P_c <= |screen_c| + E_c + 2 S, E_c <= F(screen_c)
// with F(v) = alpha' |v| + beta' S + eps, alpha' = 2^-15 >= alpha / (1 -
// alpha), beta' = 1.25 2^-12 >= (2 alpha + beta) / (1 - alpha), and eps =
// 2^-96 for the bits that a subnormal part loses. Let c^ be the screen's
// argmin and m = screen_c^. A column c that reaches the plain minimum d*
// has screen_c - F(screen_c) <= d_c = d* <= d_c^ <= m + F(m); the
// limit is exactly that test, since g(v) = v - alpha' |v| is increasing:
// screen_c <= vmax = g^-1(m + alpha' |m| + 2 beta' S + eps), computed
// rounded up. A column that fails it has d_c >= g(screen_c) - beta' S - eps
// > m + F(m) >= d_c^ >= d*, so it cannot win or tie. Hence the rescored
// set holds every column of the minimum, and the lexicographic pick over
// it is min's first index. Only that is needed: the pick never has to
// know that a skipped column loses, which the tight limit below does not
// show for columns far from s.
// The tight limit. When every column has tsq_c >= (1 - 2^-21) fl(|t_c|^2)
// (target_operands gives tsq = fl(|t|^2) or a sentinel with t = 0; the
// kernel checks it in pass 1, else it keeps S), S can be replaced for the
// two columns of the argument by |s| R: the first limit vc (with S) holds
// both, so x_c <= X = vc + F(vc); and (1 - 2^-20) |t_c|^2 - 2 |s| |t_c| <=
// x_c gives |t_c| <= R = (|s| + sqrt(|s|^2 + (1 - 2^-20) X)) / (1 - 2^-20),
// so P_c <= |s| |t_c| <= |s| R (Cauchy-Schwarz). With S' = min(S, |s| R)
// the same chain gives vmax = g^-1(m + alpha' |m| + 2 beta' S' + eps).
// For a valid row |s| R ~ |s|^2 where S ~ |s| max|t|: a few times fewer
// rescored columns. Nothing here assumes valid rows: padded rows at
// 1e9 get S ~ 1e9 sum T and a limit that scales with it, and sentinel
// columns (coordinates 0, tsq 1e9 or 1e30) have P_c = 0 and an error
// relative to their own tsq, which alpha' |v| covers; when every column
// is a sentinel, every column is rescored. Valid for finite inputs whose
// products do not overflow. ops/nn_kernels.py screen_plain and
// screen_limit mirror the screen and the limit, and
// tests/test_torch_nn_screen.py holds them to this bound on the CPU.
//
// K5, neg_dist_bf16: the [N, M] bf16 operand of GICP's covariance top-k,
// bf16((2 s.t - tsq) - ssq). What bounds it: writing 2 bytes per pair (2.1
// GB at 32768 x 32768); it reads O(N + M) floats. Design: a block writes a
// tile of 32 rows x 256 columns; each thread holds its two adjacent
// columns in registers and writes them as one 4-byte __nv_bfloat162, so a
// warp writes 128 contiguous bytes per row. The block's 32 source rows are
// staged in shared memory. Odd M (rows not 4-byte aligned) takes 2-byte
// stores.
//
// Every entry point returns cudaGetLastError() so that the Python wrapper
// can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_split.cuh"

namespace {

// ---- K4 -------------------------------------------------------------------
constexpr int kNNWarps = 8;
constexpr int kNNThreads = 32 * kNNWarps;
constexpr int kColWarps = 4;                    // warps that share a row set
constexpr int kMTiles = 4;                      // m16 tiles a warp holds
constexpr int kWarpRows = 16 * kMTiles;         // 64
constexpr int kNNRows = kNNWarps / kColWarps * kWarpRows;  // 128 a block
constexpr int kChunk = 64;                      // target columns a warp step
constexpr int kChunkFrags = kChunk / 8;         // n8 fragments a chunk
constexpr int kSkipChunks = 192;                // a warp's chunks pass 2 may skip
// The candidate limit (see the note at the head of this file and
// ops/nn_kernels.py screen_limit): F(v) = kLimRel |v| + kLimDot S + kLimAbs.
constexpr float kLimRel = 0x1p-15f;             // alpha' >= alpha / (1 - alpha)
constexpr float kLimDot = 0x1.4p-12f;           // beta' >= (2 alpha + beta) / (1 - alpha)
constexpr float kLimAbs = 0x1p-96f;
constexpr float kNormSlack = 0x1.fffffcp-1f;    // 1 - 2^-21
constexpr float kNormTight = 0x1.fffff8p-1f;    // 1 - 2^-20

// g^-1(m + F(m) + kLimDot S): the largest screen value that can belong to
// the plain minimum when every column's screen is within
// F(v) = kLimRel |v| + kLimDot S + kLimAbs of its plain value. Rounded up.
__device__ __forceinline__ float candidate_limit(float mn, float S) {
  const float thr = __fadd_ru(
      __fadd_ru(mn, __fmul_ru(kLimRel, fabsf(mn))),
      __fadd_ru(__fmul_ru(2.0f * kLimDot, S), kLimAbs));
  return thr >= 0.0f ? __fdiv_ru(thr, 1.0f - kLimRel)
                     : __fdiv_ru(thr, 1.0f + kLimRel);
}

__device__ __forceinline__ float dot_rn(float sx, float sy, float sz,
                                        float tx, float ty, float tz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(sx, tx), __fmul_rn(sy, ty)),
                   __fmul_rn(sz, tz));
}

// Lexicographic minimum of (value, column): jnp.argmin's first index.
__device__ __forceinline__ void lex_min(float& b, int& a, float ob, int oa) {
  if (ob < b || (ob == b && oa < a)) {
    b = ob;
    a = oa;
  }
}

// Target column col as f32 (x, y, z, tsq); NaN past m (a NaN screen
// neither lowers a minimum nor passes the candidate test).
__device__ __forceinline__ float4 load_column(const float* __restrict__ tgt_t,
                                              const float* __restrict__ tsq,
                                              int m, int col) {
  if (col >= m) {
    return make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F,
                       CUDART_NAN_F);
  }
  const size_t mm = static_cast<size_t>(m);
  return make_float4(tgt_t[col], tgt_t[mm + col], tgt_t[2 * mm + col],
                     tsq[col]);
}

// Stages column c of a warp's chunk: v in f32 for the rescoring, and the
// screen's B fragment [t_hi ; t_lo ; t_hi ; tsq_hi ; tsq_mid ; tsq_lo] in
// fragment order, so that lane l reads fragment j as bfrag[j][l], 8
// contiguous bytes. With tmax (pass 1, valid columns), keeps the running
// max of |t| per axis in tmax[0..2] and clears tmax[3] unless tsq >= (1 -
// 2^-21) fl(|t|^2), which bounds |t| for the tight limit.
__device__ __forceinline__ void stage_column(float4 v, int c, bool valid,
                                             float4* tcol, uint2 (*bfrag)[32],
                                             float* tmax) {
  if (tmax != nullptr && valid) {
    tmax[0] = fmaxf(tmax[0], fabsf(v.x));
    tmax[1] = fmaxf(tmax[1], fabsf(v.y));
    tmax[2] = fmaxf(tmax[2], fabsf(v.z));
    const float q = dot_rn(v.x, v.y, v.z, v.x, v.y, v.z);
    if (!(v.w >= __fmul_ru(kNormSlack, q))) tmax[3] = 0.0f;
  }
  tcol[c] = v;
  Split3 p = split3(v.x, v.y, v.z);
  // |t|^2 in three exact bf16 parts: hi + mid + lo = tsq.
  const float hi = __bfloat162float(__float2bfloat16_rn(v.w));
  const float r = __fsub_rn(v.w, hi);
  const float mid = __bfloat162float(__float2bfloat16_rn(r));
  p.ext[0] = hi;
  p.ext[1] = mid;
  p.ext[2] = __bfloat162float(__float2bfloat16_rn(__fsub_rn(r, mid)));
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    uint32_t b[2];
    b_fragment<3, 0b010, 1>(b, t, p);
    bfrag[c / 8][4 * (c % 8) + t] = make_uint2(b[0], b[1]);
  }
}

// Per-warp state that pass 1 leaves for pass 2's skipping: chunk_min[f][u]
// is the minimum over the warp's rows r of class f and the columns of its
// u-th chunk of screen + off_r, rounded down; vw[f] = max_r (vmax_r +
// off_r), rounded up. off_r is any fixed f32 per row (see the kernel);
// +inf drops the row. When chunk_min[f][u] > vw[f] for both classes, every
// screen of the chunk exceeds its row's limit and the warp skips it.
// diag/k4_ablation.py times the kernel without the skip and without the
// far class.
struct Skip {
  float (*chunk_min)[kSkipChunks];
  float vw[2];
  bool mixed;  // the warp holds rows of both classes
  __device__ __forceinline__ bool needs(int u) const {
    return u >= kSkipChunks || !(chunk_min[0][u] > vw[0]) ||
           !(chunk_min[1][u] > vw[1]);
  }
};

// One pass of a warp over its share of the target: chunks cw, cw + 4, ...
// of kChunk columns, staged by the warp alone into its own buffers (two
// columns a lane), the next chunk's columns loaded into registers while it
// works on this one. No block barrier: the warps run on their own.
// - Pass 1 (RESCORE false) keeps the minimum of the screen per row in lo
//   and fills skip.chunk_min.
// - Pass 2 visits only the chunks that skip.needs; it rescores, in exact
//   f32, every column whose screen is at most the row's limit vmax, and
//   keeps the lexicographic (value, column) minimum and the count of
//   rescored columns.
template <bool RESCORE, bool COUNT>
__device__ __forceinline__ void sweep(
    const float* __restrict__ tgt_t, const float* __restrict__ tsq, int m,
    const uint32_t (&a)[kMTiles][4], const float (&off)[kMTiles][2],
    const bool (&far)[kMTiles][2], const float4* srow, float4* tcol,
    uint2 (*bfrag)[32], const Skip& skip, float* tmax,
    float (&lo)[kMTiles][2], const float (&vmax)[kMTiles][2],
    int (&arg)[kMTiles][2], int (&cnt)[kMTiles][2]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane >> 2, t = lane & 3;
  const int cw = warp % kColWarps;
  const int wrow0 = warp / kColWarps * kWarpRows;
  const int chunks = (m + kChunk - 1) / kChunk;
  const int mine = (chunks - cw + kColWarps - 1) / kColWarps;
  auto next_chunk = [&](int u) {
    if constexpr (RESCORE) {
      while (u < mine && !skip.needs(u)) ++u;
    }
    return u;
  };
  auto load = [&](int u, int c) {
    return load_column(tgt_t, tsq, m, (cw + kColWarps * u) * kChunk + c);
  };
  int u = next_chunk(0);
  float4 nx0 = load(u, lane), nx1 = load(u, lane + 32);
  while (u < mine) {
    const int base = (cw + kColWarps * u) * kChunk;
    stage_column(nx0, lane, base + lane < m, tcol, bfrag, tmax);
    stage_column(nx1, lane + 32, base + lane + 32 < m, tcol, bfrag, tmax);
    __syncwarp();
    const int after = next_chunk(u + 1);
    nx0 = load(after, lane);
    nx1 = load(after, lane + 32);
    const int frags = min(kChunkFrags, (m - base + 7) / 8);
    float tl[kMTiles][2];
#pragma unroll
    for (int i = 0; i < kMTiles; ++i) tl[i][0] = tl[i][1] = CUDART_INF_F;
#pragma unroll 8
    for (int j = 0; j < frags; ++j) {
      const uint2 bb = bfrag[j][lane];
      const uint32_t b[2] = {bb.x, bb.y};
      float d[kMTiles][4];
#pragma unroll
      for (int i = 0; i < kMTiles; ++i) mma_bf16(d[i], a[i], b);
      if constexpr (!RESCORE) {
#pragma unroll
        for (int i = 0; i < kMTiles; ++i) {
          tl[i][0] = fminf(tl[i][0], fminf(d[i][0], d[i][1]));
          tl[i][1] = fminf(tl[i][1], fminf(d[i][2], d[i][3]));
        }
      } else {
        // One branch a fragment; fminf skips a NaN, the test below does
        // not.
        bool any = false;
#pragma unroll
        for (int i = 0; i < kMTiles; ++i) {
          any |= fminf(d[i][0], d[i][1]) <= vmax[i][0];
          any |= fminf(d[i][2], d[i][3]) <= vmax[i][1];
        }
        if (any) {
#pragma unroll
          for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = 8 * j + 2 * t + (e & 1);
              if (!(d[i][e] <= vmax[i][e >> 1]) || base + c >= m) continue;
              const float4 s = srow[wrow0 + 16 * i + 8 * (e >> 1) + g];
              const float4 v = tcol[c];
              const float dd = __fsub_rn(
                  v.w, __fmul_rn(2.0f, dot_rn(s.x, s.y, s.z, v.x, v.y, v.z)));
              // A NaN never wins; the lexicographic pick keeps the first
              // column of the minimum.
              lex_min(lo[i][e >> 1], arg[i][e >> 1], dd, base + c);
              if constexpr (COUNT) ++cnt[i][e >> 1];
            }
          }
        }
      }
    }
    if constexpr (!RESCORE) {
      float w[2] = {CUDART_INF_F, CUDART_INF_F};
#pragma unroll
      for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          lo[i][h] = fminf(lo[i][h], tl[i][h]);
          const float v = __fadd_rd(tl[i][h], off[i][h]);
          if (far[i][h]) {
            w[1] = fminf(w[1], v);
          } else {
            w[0] = fminf(w[0], v);
          }
        }
      }
      if (u < kSkipChunks) {
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          if (f == 1 && !skip.mixed) break;  // no far row: w[1] is inf
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            w[f] = fminf(w[f], __shfl_xor_sync(0xffffffffu, w[f], o));
        }
        if (lane == 0) {
          skip.chunk_min[0][u] = w[0];
          skip.chunk_min[1][u] = w[1];
        }
      }
    }
    __syncwarp();  // the chunk is consumed before the next one is staged
    u = after;
  }
}

template <bool COUNT>
__global__ void __launch_bounds__(kNNThreads, 2)
nearest_kernel(const float* __restrict__ src, const float* __restrict__ tgt_t,
               const float* __restrict__ tsq, float* __restrict__ best_out,
               int* __restrict__ idx_out, int* __restrict__ cnt_out, int n,
               int m) {
  __shared__ uint2 bfrag[kNNWarps][kChunkFrags][32];
  __shared__ float4 tcol[kNNWarps][kChunk];
  __shared__ float4 srow[kNNRows];
  __shared__ float red_v[kColWarps][kNNRows];
  __shared__ int red_i[kColWarps][kNNRows];
  __shared__ int red_c[kColWarps][kNNRows];
  __shared__ float red_t[kNNWarps][3];
  __shared__ float chunk_min[kNNWarps][2][kSkipChunks];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane >> 2, t = lane & 3;
  const int cw = warp % kColWarps;
  const int wrow0 = warp / kColWarps * kWarpRows;
  const int row0 = blockIdx.x * kNNRows;

  if (threadIdx.x < kNNRows) {
    const int row = row0 + threadIdx.x;
    const size_t o = 3 * static_cast<size_t>(row);
    srow[threadIdx.x] = row < n ? make_float4(src[o], src[o + 1], src[o + 2],
                                              0.0f)
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();

  // A fragments of the warp's 64 rows, held for both passes: the x3 split
  // of u = -2 s, [u_hi | u_hi | u_lo], then 1, 1, 1 against |t|^2's parts.
  uint32_t a[kMTiles][4];
  float off[kMTiles][2];
#pragma unroll
  for (int i = 0; i < kMTiles; ++i) {
    const float4 s0 = srow[wrow0 + 16 * i + g];
    const float4 s1 = srow[wrow0 + 16 * i + g + 8];
    off[i][0] = dot_rn(s0.x, s0.y, s0.z, s0.x, s0.y, s0.z);
    off[i][1] = dot_rn(s1.x, s1.y, s1.z, s1.x, s1.y, s1.z);
    Split3 r0 = split3(-2.0f * s0.x, -2.0f * s0.y, -2.0f * s0.z);
    Split3 r1 = split3(-2.0f * s1.x, -2.0f * s1.y, -2.0f * s1.z);
#pragma unroll
    for (int k = 0; k < 3; ++k) r0.ext[k] = r1.ext[k] = 1.0f;
    a_fragment<3, 0b100, 1>(a[i], t, r0, r1);
  }
  // The skip offsets of pass 2 (see sweep): off_r = |s_r|^2 - the largest
  // |s|^2 of the row's class, so that screen + off is about a squared
  // distance, comparable across the rows of a class, and exact for a class
  // of equal rows. Far rows (|s|^2 > 2^24 (the warp's least + 1): the
  // padded rows of a warp that also holds valid ones) form a class of
  // their own, which keeps the near rows' sums from losing their digits.
  // Rows past n get +inf: they need nothing.
  bool far[kMTiles][2];
  bool mixed;  // some row of the warp is far (the least row is near)
  {
    float least = CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < kMTiles; ++i)
      least = fminf(least, fminf(off[i][0], off[i][1]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      least = fminf(least, __shfl_xor_sync(0xffffffffu, least, o));
    const float split = __fmul_rn(0x1p24f, __fadd_rn(least, 1.0f));
    float top[2] = {0.0f, 0.0f};
    bool any_far = false;
#pragma unroll
    for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        far[i][h] = off[i][h] > split;
        any_far |= far[i][h];
        if (far[i][h]) {
          top[1] = fmaxf(top[1], off[i][h]);
        } else {
          top[0] = fmaxf(top[0], off[i][h]);
        }
      }
    }
    mixed = __any_sync(0xffffffffu, any_far);
#pragma unroll
    for (int f = 0; f < 2; ++f) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        top[f] = fmaxf(top[f], __shfl_xor_sync(0xffffffffu, top[f], o));
    }
#pragma unroll
    for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        off[i][h] = row0 + wrow0 + 16 * i + 8 * h + g >= n
                        ? CUDART_INF_F
                        : __fsub_rn(off[i][h], far[i][h] ? top[1] : top[0]);
      }
    }
  }

  // Pass 1: the screen's minimum m per row, and T = max |t| per axis.
  float lo[kMTiles][2], vmax[kMTiles][2];
  int arg[kMTiles][2], cnt[kMTiles][2];
  float tmax[4] = {0.0f, 0.0f, 0.0f, 1.0f};
#pragma unroll
  for (int i = 0; i < kMTiles; ++i) {
    lo[i][0] = lo[i][1] = CUDART_INF_F;
    arg[i][0] = arg[i][1] = cnt[i][0] = cnt[i][1] = 0;
  }
  Skip skip{chunk_min[warp], {0.0f, 0.0f}, mixed};  // vw: after pass 1
  sweep<false, false>(tgt_t, tsq, m, a, off, far, srow, tcol[warp],
                      bfrag[warp], skip, tmax, lo, vmax, arg, cnt);
#pragma unroll
  for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = lo[i][h];
      v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      if (t == 0) red_v[cw][wrow0 + 16 * i + 8 * h + g] = v;
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float v = tmax[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red_t[warp][k] = v;
  }
  const bool tight = __syncthreads_and(tmax[3] != 0.0f);
  float T[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int w = 0; w < kNNWarps; ++w) {
#pragma unroll
    for (int k = 0; k < 3; ++k) T[k] = fmaxf(T[k], red_t[w][k]);
  }

  // The candidate limit of each row (the note at the head of this file),
  // with S = sum_i |s_i| T_i or, when every column passed the |t|^2 check,
  // the tighter min(S, |s| R). Rows past n get NaN: no candidate.
#pragma unroll
  for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wrow0 + 16 * i + 8 * h + g;
      float mn = red_v[0][r];
#pragma unroll
      for (int w = 1; w < kColWarps; ++w) mn = fminf(mn, red_v[w][r]);
      const float4 s = srow[r];
      float S = __fadd_ru(__fadd_ru(__fmul_ru(fabsf(s.x), T[0]),
                                    __fmul_ru(fabsf(s.y), T[1])),
                          __fmul_ru(fabsf(s.z), T[2]));
      if (tight) {
        // Both columns of the argument have x_c <= X, hence |t_c| <= R.
        const float vc = candidate_limit(mn, S);
        const float X = __fadd_ru(
            __fadd_ru(vc, __fmul_ru(kLimRel, fabsf(vc))),
            __fadd_ru(__fmul_ru(kLimDot, S), kLimAbs));
        const float s2 = __fadd_ru(__fadd_ru(__fmul_ru(s.x, s.x),
                                             __fmul_ru(s.y, s.y)),
                                   __fmul_ru(s.z, s.z));
        const float ns = __fsqrt_ru(s2);
        const float R = __fdiv_ru(
            __fadd_ru(ns, __fsqrt_ru(fmaxf(
                              __fadd_ru(s2, __fmul_ru(kNormTight, X)), 0.0f))),
            kNormTight);
        const float St = __fmul_ru(ns, R);
        if (St < S) S = St;
      }
      vmax[i][h] = row0 + r >= n ? CUDART_NAN_F : candidate_limit(mn, S);
      lo[i][h] = CUDART_INF_F;  // now the best rescored value
    }
  }

  // Pass 2: rescore the candidates in exact f32, on the tiles that can
  // hold one.
  float v[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (isnan(vmax[i][h])) continue;
      const float x = __fadd_ru(vmax[i][h], off[i][h]);
      if (far[i][h]) {
        v[1] = fmaxf(v[1], x);
      } else {
        v[0] = fmaxf(v[0], x);
      }
    }
  }
#pragma unroll
  for (int f = 0; f < 2; ++f) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v[f] = fmaxf(v[f], __shfl_xor_sync(0xffffffffu, v[f], o));
    skip.vw[f] = v[f];
  }
  __syncthreads();  // every warp has read red_v, which pass 2's merge reuses
  sweep<true, COUNT>(tgt_t, tsq, m, a, off, far, srow, tcol[warp],
                     bfrag[warp], skip, nullptr, lo, vmax, arg, cnt);
#pragma unroll
  for (int i = 0; i < kMTiles; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float b = lo[i][h];
      int ar = arg[i][h], c = cnt[i][h];
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        lex_min(b, ar, __shfl_xor_sync(0xffffffffu, b, o),
                __shfl_xor_sync(0xffffffffu, ar, o));
        c += __shfl_xor_sync(0xffffffffu, c, o);
      }
      if (t == 0) {
        const int r = wrow0 + 16 * i + 8 * h + g;
        red_v[cw][r] = b;
        red_i[cw][r] = ar;
        red_c[cw][r] = c;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < kNNRows) {
    const int r = threadIdx.x, row = row0 + r;
    float b = red_v[0][r];
    int ar = red_i[0][r], c = red_c[0][r];
#pragma unroll
    for (int w = 1; w < kColWarps; ++w) {
      lex_min(b, ar, red_v[w][r], red_i[w][r]);
      c += red_c[w][r];
    }
    if (row < n) {
      best_out[row] = b;
      idx_out[row] = ar;
      if constexpr (COUNT) cnt_out[row] = c;
    }
  }
}

// ---- K5 -------------------------------------------------------------------
constexpr int kNDThreads = 256;
constexpr int kNDColPairs = 128;                // threads across a row
constexpr int kNDCols = 2 * kNDColPairs;        // columns per block
constexpr int kNDRowSteps = kNDThreads / kNDColPairs;
constexpr int kNDRows = 32;                     // rows per block

__global__ void __launch_bounds__(kNDThreads)
neg_dist_kernel(const float* __restrict__ src, const float* __restrict__ ssq,
                const float* __restrict__ tgt_t, const float* __restrict__ tsq,
                __nv_bfloat16* __restrict__ out, int n, int m,
                long long col_blocks) {
  __shared__ float4 rows[kNDRows];
  const long long rb = blockIdx.x / col_blocks;
  const long long cb = blockIdx.x % col_blocks;
  const int row0 = static_cast<int>(rb) * kNDRows;
  if (threadIdx.x < kNDRows) {
    const int row = row0 + threadIdx.x;
    if (row < n) {
      const size_t o = 3 * static_cast<size_t>(row);
      rows[threadIdx.x] = make_float4(src[o], src[o + 1], src[o + 2], ssq[row]);
    }
  }
  __syncthreads();

  const int col = static_cast<int>(cb) * kNDCols + 2 * (threadIdx.x % kNDColPairs);
  if (col >= m) return;
  const bool two = col + 1 < m;
  const size_t mm = static_cast<size_t>(m);
  const float tx0 = tgt_t[col], ty0 = tgt_t[mm + col], tz0 = tgt_t[2 * mm + col];
  const float tw0 = tsq[col];
  const float tx1 = two ? tgt_t[col + 1] : 0.0f;
  const float ty1 = two ? tgt_t[mm + col + 1] : 0.0f;
  const float tz1 = two ? tgt_t[2 * mm + col + 1] : 0.0f;
  const float tw1 = two ? tsq[col + 1] : 0.0f;
  const bool paired = two && (m % 2 == 0);  // 4-byte aligned pair stores

  for (int r = threadIdx.x / kNDColPairs; r < kNDRows; r += kNDRowSteps) {
    const int row = row0 + r;
    if (row >= n) break;
    const float4 s = rows[r];
    const float v0 = __fsub_rn(
        __fsub_rn(__fmul_rn(2.0f, dot_rn(s.x, s.y, s.z, tx0, ty0, tz0)), tw0),
        s.w);
    const float v1 = __fsub_rn(
        __fsub_rn(__fmul_rn(2.0f, dot_rn(s.x, s.y, s.z, tx1, ty1, tz1)), tw1),
        s.w);
    __nv_bfloat16* o = out + static_cast<size_t>(row) * mm + col;
    if (paired) {
      *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
    } else {
      o[0] = __float2bfloat16_rn(v0);
      if (two) o[1] = __float2bfloat16_rn(v1);
    }
  }
}

}  // namespace

// counts: null, or [n] int32 that receives the rescored columns per row.
extern "C" int nearest_neighbor(const void* src, const void* tgt_t,
                                const void* tsq, void* best, void* idx,
                                void* counts, long long n, long long m,
                                void* stream) {
  const unsigned blocks = static_cast<unsigned>((n + kNNRows - 1) / kNNRows);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(src);
  const float* tt = static_cast<const float*>(tgt_t);
  const float* tq = static_cast<const float*>(tsq);
  float* b = static_cast<float*>(best);
  int* ix = static_cast<int*>(idx);
  int* ct = static_cast<int*>(counts);
  const int ni = static_cast<int>(n), mi = static_cast<int>(m);
  if (ct != nullptr) {
    nearest_kernel<true><<<blocks, kNNThreads, 0, st>>>(s, tt, tq, b, ix, ct,
                                                        ni, mi);
  } else {
    nearest_kernel<false><<<blocks, kNNThreads, 0, st>>>(s, tt, tq, b, ix, ct,
                                                         ni, mi);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int neg_dist_bf16(const void* src, const void* ssq,
                             const void* tgt_t, const void* tsq, void* out,
                             long long n, long long m, void* stream) {
  const long long col_blocks = (m + kNDCols - 1) / kNDCols;
  const long long row_blocks = (n + kNDRows - 1) / kNDRows;
  neg_dist_kernel<<<static_cast<unsigned>(row_blocks * col_blocks),
                    kNDThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const float*>(ssq),
      static_cast<const float*>(tgt_t), static_cast<const float*>(tsq),
      static_cast<__nv_bfloat16*>(out), static_cast<int>(n),
      static_cast<int>(m), col_blocks);
  return static_cast<int>(cudaGetLastError());
}
