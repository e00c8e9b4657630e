// The per-lane row gather for Hopper (sm_90a): D2 of the port.
//
// Replaces the Pallas TPU kernel of benchmarks/profile_gather_modes.py:
//   lane_row_sum  <- pallas_gather / kern  (profile_gather_modes.py:144/136)
//
// Per lane b: out[b, i] = sum_c table[b, ids[b, i], c] over the 16 f32
// columns of a row, the fleet's stats fetch reduced to one float so that
// the gather cannot be skipped. Ids index as JAX's t[ids] does: a negative
// id counts from the end (id + cap), then any id is clamped into [0, cap).
//
// What bounds it: the ids read and the sums written once (8 bytes an id),
// and each lane's table read once: 62.9 MB at the fleet's shape (64 lanes,
// cap 8192, 57344 ids a lane), 0.019 ms at 3.35 TB/s. The gathered rows
// themselves are 64 bytes each, 235 MB at that shape, and they set the
// time: they come from L2, which holds the fleet's 32 MiB of tables (with
// the ids and sums alone the kernel takes a sixth of its time).
//
// Design: one grid row of blocks per lane (blockIdx.y); a thread owns one
// id, neighbouring threads neighbouring ids (coalesced id loads and sum
// stores), and reads its row as four 16-byte float4 loads. The 16 floats
// are summed in a fixed tree with __fadd_rn, the tree of the plain version
// (ops/gather_kernels.py), so the two agree bit for bit.
//
// The TPU kernel holds a lane's whole [cap, 16] table in VMEM. At cap 8192
// that is 512 KiB: more than a block's 227 KB of shared memory, but it fits
// in a thread block cluster or a group of blocks. Held there, the rows came
// no faster on the H100 (diag/gather_candidates.cu, timed by
// diag/kernel_variants.py): read from the owning block through the
// cluster, 7 of 8 of them remote, they took 3.8x as long; each block
// serving only the ids whose rows it holds tied this kernel, as every block
// then reads every id of its lane.
//
// Every entry point returns cudaGetLastError() so that the Python wrapper
// can raise on a refused launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float sum4(float4 v) {
  return __fadd_rn(__fadd_rn(v.x, v.y), __fadd_rn(v.z, v.w));
}

__global__ void __launch_bounds__(kThreads)
lane_row_sum_kernel(const int* __restrict__ ids,
                    const float4* __restrict__ table,
                    float* __restrict__ out, long long nk, int cap) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= nk) return;
  const size_t lane = blockIdx.y;
  int id = ids[lane * nk + i];
  id = min(max(id < 0 ? id + cap : id, 0), cap - 1);
  const float4* row = table + (lane * cap + id) * 4;
  const float4 q0 = row[0], q1 = row[1], q2 = row[2], q3 = row[3];
  out[lane * nk + i] =
      __fadd_rn(__fadd_rn(sum4(q0), sum4(q1)), __fadd_rn(sum4(q2), sum4(q3)));
}

}  // namespace

extern "C" int lane_row_sum(const void* ids, const void* table, void* out,
                            long long lanes, long long nk, long long cap,
                            void* stream) {
  const dim3 grid(static_cast<unsigned>((nk + kThreads - 1) / kThreads),
                  static_cast<unsigned>(lanes));
  lane_row_sum_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const float4*>(table),
      static_cast<float*>(out), nk, static_cast<int>(cap));
  return static_cast<int>(cudaGetLastError());
}
