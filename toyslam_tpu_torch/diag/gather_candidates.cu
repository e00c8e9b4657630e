// On-chip designs of D2 (csrc/gather_kernels.cu, lane_row_sum), built and
// timed against it at the fleet's shape by diag/kernel_variants.py. No path
// of the port runs them: on the H100 none reads the rows faster than the
// shipped kernel reads them through L2 (PERF.md section 6).
//
// Each computes lane_row_sum's function bit for bit (the same id rule and
// the same __fadd_rn tree over a row's 16 floats), one lane's table held
// on chip as the TPU kernel held it in VMEM:
// - cluster_read: a thread block cluster of kCluster blocks holds the
//   table, block r rows [r * block_rows, (r + 1) * block_rows), copied in
//   with coalesced float4 loads; after cluster.sync() a thread takes its
//   ids (kIds at once) and reads each row from the block that holds it
//   through cluster.map_shared_rank, as four float4; a closing
//   cluster.sync() keeps every slice alive until the last read.
// - owner_filter: kGroup blocks hold the table the same way, each slice
//   brought in by one TMA bulk copy while the first ids are in flight; each
//   block reads every id of its lane (kGroupIds at once a thread, the next
//   ones in flight), a warp lists the ids whose rows its block holds in
//   shared memory, and its 32 lanes serve them from there: no row leaves
//   its SM.
// - four_lanes_a_row: the shipped kernel with lane 4k + c of a warp loading
//   float4 c of the row of id k, so that one load instruction asks for 8
//   whole rows, and shuffles in place of the per-thread tree.
//
// One cluster or group a lane (the fleet's 64 lanes fill the card). Every
// entry point returns cudaGetLastError() or the error of a launch call.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // four_lanes_a_row
constexpr int kCluster = 8;
constexpr int kClusterThreads = 512;
constexpr int kIds = 2;
constexpr int kGroup = 4;
constexpr int kGroupThreads = 1024;
constexpr int kGroupIds = 4;
constexpr int kMaxSmem = 232448 - kGroupThreads * kGroupIds * 4 - 1024;

__device__ __forceinline__ float sum4(float4 v) {
  return __fadd_rn(__fadd_rn(v.x, v.y), __fadd_rn(v.z, v.w));
}

__device__ __forceinline__ float row_sum(const float4* row) {
  const float4 q0 = row[0], q1 = row[1], q2 = row[2], q3 = row[3];
  return __fadd_rn(__fadd_rn(sum4(q0), sum4(q1)),
                   __fadd_rn(sum4(q2), sum4(q3)));
}

__device__ __forceinline__ int clamp_id(int id, int cap) {
  return min(max(id < 0 ? id + cap : id, 0), cap - 1);
}

__global__ void __launch_bounds__(kClusterThreads)
cluster_read_kernel(const int* __restrict__ ids,
                    const float4* __restrict__ table,
                    float* __restrict__ out, long long nk, int cap,
                    int block_rows) {
  extern __shared__ float4 slice[];  // [block_rows, 4]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t lane = blockIdx.y;
  const int first = rank * block_rows;
  const int rows = max(0, min(block_rows, cap - first));
  const float4* src = table + (lane * cap + first) * 4;
  for (int j = threadIdx.x; j < rows * 4; j += kClusterThreads)
    slice[j] = src[j];
  cluster.sync();
  const int* lane_ids = ids + lane * nk;
  float* lane_out = out + lane * nk;
  const long long stride = static_cast<long long>(gridDim.x) * kClusterThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kClusterThreads +
                     threadIdx.x;
       i < nk; i += kIds * stride) {
    int id[kIds];
#pragma unroll
    for (int u = 0; u < kIds; ++u)
      id[u] = i + u * stride < nk ? clamp_id(lane_ids[i + u * stride], cap)
                                  : 0;
    float sum[kIds];
#pragma unroll
    for (int u = 0; u < kIds; ++u) {
      const int owner = id[u] / block_rows;
      sum[u] = row_sum(cluster.map_shared_rank(slice, owner) +
                       (id[u] - owner * block_rows) * 4);
    }
#pragma unroll
    for (int u = 0; u < kIds; ++u)
      if (i + u * stride < nk) lane_out[i + u * stride] = sum[u];
  }
  cluster.sync();
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// True once the mbarrier at bar has completed its phase 0.
__device__ __forceinline__ bool phase0_done(unsigned bar) {
  unsigned done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(bar)
      : "memory");
  return done != 0;
}

__global__ void __launch_bounds__(kGroupThreads)
owner_filter_kernel(const int* __restrict__ ids,
                    const float4* __restrict__ table, float* __restrict__ out,
                    long long nk, int cap, int block_rows) {
  extern __shared__ __align__(16) float4 slice[];  // [block_rows, 4]
  __shared__ __align__(8) unsigned long long slice_in;  // mbarrier
  // A warp's owned ids: (row << 9) | (u << 5) | lane each.
  __shared__ unsigned queues[kGroupThreads / 32][32 * kGroupIds];
  const int rank = blockIdx.x;
  const size_t lane = blockIdx.y;
  const int first = rank * block_rows;
  const int rows = max(0, min(block_rows, cap - first));
  const unsigned bar = smem_addr(&slice_in);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (rows > 0) {
      const unsigned bytes = static_cast<unsigned>(rows) * 64u;
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
          "r"(bytes)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];" ::"r"(smem_addr(slice)),
          "l"(reinterpret_cast<unsigned long long>(table +
                                                   (lane * cap + first) * 4)),
          "r"(bytes), "r"(bar)
          : "memory");
    }
  }
  // Lane l of warp w takes ids i + u * kGroupThreads, u < kGroupIds, for
  // i = 32 w + l, then i + step, ...; the loop runs on i - l, the same in
  // every lane.
  const int l = threadIdx.x & 31;
  unsigned* queue = queues[threadIdx.x >> 5];
  const int* lane_ids = ids + lane * nk;
  float* lane_out = out + lane * nk;
  const long long stride = kGroupThreads;
  const long long step = kGroupIds * stride;
  long long i0 = threadIdx.x & ~31;
  int next[kGroupIds];
#pragma unroll
  for (int u = 0; u < kGroupIds; ++u)
    next[u] = i0 + l + u * stride < nk ? lane_ids[i0 + l + u * stride] : 0;
  __syncthreads();  // the mbarrier is initialised
  if (rows > 0)
    while (!phase0_done(bar)) {
    }
  for (; i0 < nk; i0 += step) {
    const long long i = i0 + l;
    int count = 0;
#pragma unroll
    for (int u = 0; u < kGroupIds; ++u) {
      const int local = clamp_id(next[u], cap) - first;
      next[u] = i + step + u * stride < nk ? lane_ids[i + step + u * stride]
                                           : 0;
      const bool mine = i + u * stride < nk &&
                        static_cast<unsigned>(local) <
                            static_cast<unsigned>(rows);
      const unsigned owned = __ballot_sync(0xffffffffu, mine);
      if (mine)
        queue[count + __popc(owned & ((1u << l) - 1u))] =
            (static_cast<unsigned>(local) << 9) | (u << 5) | l;
      count += __popc(owned);
    }
    __syncwarp();
    for (int j = l; j < count; j += 32) {
      const unsigned e = queue[j];
      lane_out[i0 + (e & 31u) + ((e >> 5) & 15u) * stride] =
          row_sum(slice + (e >> 9) * 4);
    }
    __syncwarp();  // the queue is read before the next ids are listed
  }
}

__global__ void __launch_bounds__(kThreads)
four_lanes_a_row_kernel(const int* __restrict__ ids,
                        const float4* __restrict__ table,
                        float* __restrict__ out, long long nk, int cap) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long i = t >> 2;
  const int c = threadIdx.x & 3;
  const size_t lane = blockIdx.y;
  float s = 0.0f;
  if (i < nk) {
    const int id = clamp_id(ids[lane * nk + i], cap);
    s = sum4(table[(lane * cap + id) * 4 + c]);
  }
  // ((q0 + q1) + (q2 + q3)): lanes c = 0, 2 add their right neighbours,
  // then lane 0 adds lane 2's pair.
  s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, 1));
  s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, 2));
  if (c == 0 && i < nk) out[lane * nk + i] = s;
}

}  // namespace

extern "C" int cluster_read(const void* ids, const void* table, void* out,
                            long long lanes, long long nk, long long cap,
                            void* stream) {
  const int block_rows = static_cast<int>((cap + kCluster - 1) / kCluster);
  const size_t smem = static_cast<size_t>(block_rows) * 64;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      cluster_read_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kCluster, static_cast<unsigned>(lanes), 1);
  config.blockDim = dim3(kClusterThreads, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, cluster_read_kernel,
                           static_cast<const int*>(ids),
                           static_cast<const float4*>(table),
                           static_cast<float*>(out), nk,
                           static_cast<int>(cap), block_rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int owner_filter(const void* ids, const void* table, void* out,
                            long long lanes, long long nk, long long cap,
                            void* stream) {
  const int block_rows = static_cast<int>((cap + kGroup - 1) / kGroup);
  const size_t smem = static_cast<size_t>(block_rows) * 64;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      owner_filter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  owner_filter_kernel<<<dim3(kGroup, static_cast<unsigned>(lanes)),
                        kGroupThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const float4*>(table),
      static_cast<float*>(out), nk, static_cast<int>(cap), block_rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int four_lanes_a_row(const void* ids, const void* table,
                                void* out, long long lanes, long long nk,
                                long long cap, void* stream) {
  const dim3 grid(static_cast<unsigned>((4 * nk + kThreads - 1) / kThreads),
                  static_cast<unsigned>(lanes));
  four_lanes_a_row_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const float4*>(table),
      static_cast<float*>(out), nk, static_cast<int>(cap));
  return static_cast<int>(cudaGetLastError());
}
