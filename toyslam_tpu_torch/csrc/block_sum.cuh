// Deterministic block sums shared by the port's reduction kernels.
//
// Blocks run in no order, so a kernel that sums over all its threads has
// each block reduce its terms by a fixed shared-memory tree and write one
// row of [num_blocks, kTerms] partials; the caller finishes with a torch.sum
// over blocks. No float atomics: reruns are bit-identical.

#pragma once

#include <cuda_runtime.h>

// Sums t[] over the kThreads threads of the block (a power of two) and
// writes row blockIdx.x of partials. Every thread of the block must call it.
template <int kTerms, int kThreads>
__device__ __forceinline__ void block_sum_store(const float (&t)[kTerms],
                                                float* __restrict__ partials) {
  static_assert((kThreads & (kThreads - 1)) == 0, "kThreads: a power of two");
  __shared__ float red[kTerms][kThreads];
  const int tid = threadIdx.x;
#pragma unroll
  for (int c = 0; c < kTerms; ++c) red[c][tid] = t[c];
  __syncthreads();
#pragma unroll
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
#pragma unroll
      for (int c = 0; c < kTerms; ++c) red[c][tid] += red[c][tid + stride];
    }
    __syncthreads();
  }
  if (tid < kTerms) partials[blockIdx.x * kTerms + tid] = red[tid][0];
}
