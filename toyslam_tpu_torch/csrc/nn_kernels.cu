// Nearest-neighbour kernels for Hopper (sm_90a): K4 and K5 of the port.
//
// Replaces the two Pallas TPU kernels of toyslam_tpu/ops/nn_pallas.py:
//   nearest_neighbor  <- nearest_neighbor / _make_kernel(mode) (nn_pallas.py:197/104)
//   neg_dist_bf16     <- neg_dist_bf16 / _neg_dist_kernel      (nn_pallas.py:152/141)
//
// Both rank by the partial squared distance |t|^2 - 2 s.t. The TPU kernels
// compute s.t on the MXU under bf16 splits; here it is f32 on the CUDA
// cores, and every step is rounded on its own (__fmul_rn / __fadd_rn: no
// FMA contraction), in the order of the plain PyTorch versions in
// ops/nn_kernels.py, whose separate elementwise ops round the same way. So
// on the card each kernel agrees with its plain version bit for bit.
//
// K4, nearest_neighbor: per source row, min over target columns of
// d = tsq - 2 (sx tx + sy ty + sz tz) and the first column that reaches it.
// What bounds it: ~8 flops per (row, column) pair and nothing else; the
// inputs are a few hundred KB and the outputs [N]. The [N, M] matrix is
// never written. Design: a block owns 128 source rows (2 per thread, in
// registers) and stages the target in shared-memory tiles of 2048 columns
// as float4 (x, y, z, |t|^2). Each row's columns are split among 4 threads
// (column c goes to thread c % 4); a warp's 32 threads share one subset, so
// every shared-memory read is a broadcast. A thread scans its columns in
// increasing order with a strict <, so it keeps the first column of its
// minimum; the block then takes, per row, the lexicographic minimum of
// (value, column) over the 4 subsets, which is jnp.argmin's first-index
// tie-break. No cross-block reduction: the result is deterministic. The
// ragged edge of the last tile is cut by its column count, so any N and M
// work. A NaN distance never wins.
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

namespace {

// ---- K4 -------------------------------------------------------------------
constexpr int kNNThreads = 256;
constexpr int kSegs = 4;                        // column subsets per row
constexpr int kSlots = kNNThreads / kSegs;      // row slots per block
constexpr int kRowsPerThread = 2;
constexpr int kNNRows = kSlots * kRowsPerThread;  // rows per block
constexpr int kTile = 2048;                     // target columns per tile

__device__ __forceinline__ float dot_rn(float sx, float sy, float sz,
                                        float tx, float ty, float tz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(sx, tx), __fmul_rn(sy, ty)),
                   __fmul_rn(sz, tz));
}

__global__ void __launch_bounds__(kNNThreads)
nearest_kernel(const float* __restrict__ src, const float* __restrict__ tgt_t,
               const float* __restrict__ tsq, float* __restrict__ best_out,
               int* __restrict__ idx_out, int n, int m) {
  __shared__ float4 tile[kTile];
  __shared__ float red_best[kSegs][kNNRows];
  __shared__ int red_idx[kSegs][kNNRows];
  const int slot = threadIdx.x % kSlots;
  const int seg = threadIdx.x / kSlots;
  const int row0 = blockIdx.x * kNNRows;

  float sx[kRowsPerThread], sy[kRowsPerThread], sz[kRowsPerThread];
  float best[kRowsPerThread];
  int arg[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int row = row0 + slot + r * kSlots;
    const bool ok = row < n;
    sx[r] = ok ? src[3 * static_cast<size_t>(row)] : 0.0f;
    sy[r] = ok ? src[3 * static_cast<size_t>(row) + 1] : 0.0f;
    sz[r] = ok ? src[3 * static_cast<size_t>(row) + 2] : 0.0f;
    best[r] = CUDART_INF_F;
    arg[r] = seg;  // the first column of this thread's subset
  }

  for (int base = 0; base < m; base += kTile) {
    const int cols = min(kTile, m - base);
    __syncthreads();  // the previous tile is consumed
    for (int c = threadIdx.x; c < cols; c += kNNThreads) {
      const size_t j = static_cast<size_t>(base) + c;
      tile[c] = make_float4(tgt_t[j], tgt_t[static_cast<size_t>(m) + j],
                            tgt_t[2 * static_cast<size_t>(m) + j], tsq[j]);
    }
    __syncthreads();
    for (int c = seg; c < cols; c += kSegs) {
      const float4 t = tile[c];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const float d = __fsub_rn(
            t.w, __fmul_rn(2.0f, dot_rn(sx[r], sy[r], sz[r], t.x, t.y, t.z)));
        if (d < best[r]) {
          best[r] = d;
          arg[r] = base + c;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    red_best[seg][slot + r * kSlots] = best[r];
    red_idx[seg][slot + r * kSlots] = arg[r];
  }
  __syncthreads();
  if (seg == 0) {
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int j = slot + r * kSlots;
      float b = red_best[0][j];
      int a = red_idx[0][j];
#pragma unroll
      for (int s = 1; s < kSegs; ++s) {
        const float bs = red_best[s][j];
        const int as = red_idx[s][j];
        if (bs < b || (bs == b && as < a)) {
          b = bs;
          a = as;
        }
      }
      const int row = row0 + j;
      if (row < n) {
        best_out[row] = b;
        idx_out[row] = a;
      }
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

extern "C" int nearest_neighbor(const void* src, const void* tgt_t,
                                const void* tsq, void* best, void* idx,
                                long long n, long long m, void* stream) {
  const unsigned blocks = static_cast<unsigned>((n + kNNRows - 1) / kNNRows);
  nearest_kernel<<<blocks, kNNThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const float*>(tgt_t),
      static_cast<const float*>(tsq), static_cast<float*>(best),
      static_cast<int*>(idx), static_cast<int>(n), static_cast<int>(m));
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
