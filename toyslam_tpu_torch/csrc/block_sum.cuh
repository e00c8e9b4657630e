// Deterministic sums shared by the port's reduction kernels (K1, K3, K6).
//
// Blocks run in no order, so a kernel that sums over all its threads never
// adds floats across blocks with atomics: reruns stay bit-identical.
//
// grid_sum: one launch. Each warp adds its lanes' 32 slots by halving
// exchanges (31 shuffles), the block adds its warps in order, and the last
// block to finish adds the blocks' rows in a fixed order and writes the
// result. Only an integer counter is atomic; the last block resets it to 0,
// so a counter serves every launch of one stream (never two streams at
// once: the caller keeps one counter a stream).
//
// A grid of (blocks, L) runs L sums at once, one a grid row y = blockIdx.y:
// row y has its own counter, its own block of partial rows and its own
// output row, so that the rows' last-block tests never mix. Row y of such a
// launch adds exactly what a launch of (blocks, 1) adds for its inputs, in
// the same order.

#pragma once

#include <cuda_runtime.h>

// Sums slot s of v[] over the 32 lanes of the warp and returns it in lane
// s. At width w each lane keeps the w slots whose bit w matches its own and
// adds its partner's (lane ^ w) copy of them. For every slot this is the
// tree of a __shfl_down_sync reduction: lanes (l, l + 16), then (l, l + 8),
// and so on. v[] is overwritten. Every loop has a constant trip count, so
// that v[] stays in registers.
__device__ __forceinline__ float warp_sum_scatter(float (&v)[32]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int step = 0; step < 5; ++step) {
    const int w = 16 >> step;
    const bool upper = (lane & w) != 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (i < w) {
        const float send = upper ? v[i] : v[i + w];
        const float keep = upper ? v[i + w] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, w);
      }
    }
  }
  return v[0];
}

// Sum of slot (threadIdx.x & 31) over the block: the warps' sums added in
// warp order. Meaningful in threads 0..31. Every thread must call it.
template <int kThreads>
__device__ __forceinline__ float block_sum_scatter(float (&v)[32],
                                                   float (*red)[32]) {
  const int lane = threadIdx.x & 31;
  red[threadIdx.x >> 5][lane] = warp_sum_scatter(v);
  __syncthreads();
  float s = red[0][lane];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) s += red[w][lane];
  return s;
}

// Sums v[0..kSlots) over every thread of grid row y = blockIdx.y into
// out[y * kSlots .. + kSlots): block sums into row blockIdx.x of partials
// [gridDim.y, gridDim.x, kSlots]; the row's last block adds its rows b =
// tid, tid + kThreads, ... in order in each thread and then sums its
// threads as above. partials must be 16-byte aligned. counter[y] must be 0
// at the launch and is 0 again at its end. Every thread must call it; v[]
// is overwritten.
template <int kThreads, int kSlots>
__device__ __forceinline__ void grid_sum(float (&v)[32],
                                         float* __restrict__ partials,
                                         float* __restrict__ out,
                                         unsigned int* counter) {
  static_assert(kThreads % 32 == 0 && kSlots <= 32 && kSlots % 4 == 0,
                "grid_sum shape: whole warps, rows of whole float4s");
  __shared__ float red[kThreads / 32][32];
  __shared__ bool last;
  const int tid = threadIdx.x;
  partials += static_cast<size_t>(blockIdx.y) * gridDim.x * kSlots;
  out += static_cast<size_t>(blockIdx.y) * kSlots;
  counter += blockIdx.y;
  const float s = block_sum_scatter<kThreads>(v, red);
  if (tid < kSlots) {
    partials[static_cast<size_t>(blockIdx.x) * kSlots + tid] = s;
    __threadfence();  // the row is visible before this block counts itself
  }
  __syncthreads();
  if (tid == 0) last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int c = 0; c < 32; ++c) v[c] = 0.0f;
  const float4* rows = reinterpret_cast<const float4*>(partials);
  for (unsigned int b = tid; b < gridDim.x; b += kThreads) {
#pragma unroll
    for (int c = 0; c < kSlots / 4; ++c) {  // 16-byte loads: a short tail
      const float4 x = __ldcg(rows + static_cast<size_t>(b) * (kSlots / 4) + c);
      v[4 * c] += x.x;
      v[4 * c + 1] += x.y;
      v[4 * c + 2] += x.z;
      v[4 * c + 3] += x.w;
    }
  }
  const float total = block_sum_scatter<kThreads>(v, red);
  if (tid < kSlots) out[tid] = total;
  if (tid == 0) *counter = 0u;
}
