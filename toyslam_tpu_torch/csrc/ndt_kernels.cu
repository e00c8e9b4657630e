// NDT derivative kernels for Hopper (sm_90a): K1, K2 and K3 of the port.
//
// Replaces the three Pallas TPU kernels of toyslam_tpu/ops/ndt_pallas.py:
//   ndt_terms_gathered  <- ndt_terms_raw / _kernel_raw  (ndt_pallas.py:271/145)
//   ndt_gather_repack   <- ndt_repack / _repack_kernel  (ndt_pallas.py:323/312)
//   ndt_terms_packed    <- ndt_terms / _kernel          (ndt_pallas.py:355/39)
//
// Mosaic cannot gather inside a kernel, so the TPU path hashed every
// (offset, point) pair in XLA and materialised a [K*N, 16] row-gather
// buffer in HBM before its kernels ran. Hopper gathers in-kernel:
// - K1 takes the pose, the source points and mask, and the map's hash
//   table, and hashes each pair itself (neighbor_of, bit-equal to the plain
//   ndt_neighbor_hash_plain).
// - K2 takes the hash slot h, the expected voxel id nvid and the
//   in-bounds & source-mask flag okm of every pair from that plain hash and
//   writes the compact [10, K*N] stats of the frozen line search.
// - K3 sums the terms from those stats.
//
// What bounds K1 and K3: per pair one random 48-byte read of a 64-byte
// table row (the table is 2-4 MB and stays in the 50 MB L2), or 40 bytes
// of stats, and ~283 flops for the 28 terms of a pair whose voxel gate is
// open; per point ~133 flops (the transform and the 23 angular products).
// Most gates are shut (70 % at the odometry shape), and a warp pays for a
// pair's terms whenever one of its lanes needs them, so the design keeps
// the lanes on open pairs:
// - Point-major gate pass: kLanes = 2 lanes share a point of their warp's
//   16, lane l testing offsets k = l % 2, + 2, ... (K3 reads the gate row
//   only; K1 hashes the point once a lane and reads only the third 16
//   bytes of each row it reaches). A masked point costs nothing. Two lanes
//   a point measured faster than 1, 4 or 8 for both kernels (PERF.md
//   section 6).
// - Warp compaction: the warp lists its open pairs in shared memory (lane
//   by lane, offsets in order), and its 32 lanes take them in turn (entry
//   j goes to lane j % 32), each computing the point's part and the pair's
//   terms into registers.
// - One launch: grid_sum (block_sum.cuh) adds the threads' terms in a fixed
//   order, warp shuffles, then warps, then the last block over the blocks'
//   rows. No float atomics: reruns are bit-identical. A grid-stride loop
//   over at most one wave of blocks (the wrapper caps them) keeps the last
//   block's rows few.
// - A lane axis (the fleet; JAX's vmap of the pallas_call gives its grid a
//   batch axis): a grid of (blocks, L) evaluates L lanes in one launch.
//   Grid row y reads lane lane_ids[y] (y itself without lane_ids) of the
//   lane-major inputs, its own params row, and writes output row y through
//   its own grid_sum counter and partial rows. Each row keeps the
//   single-lane launch's blocks, grid-stride split and fixed-order sum, so
//   lane b of a batched launch is bit-identical to a launch with L = 1 on
//   lane b's inputs; the single-lane wrappers launch L = 1.
//
// The hash must pick the voxel that the eager-torch plain hash picks, also
// for a point within an ulp of a voxel face. The transform is therefore
// rounded one operation at a time (__fmul_rn / __fadd_rn, no FMA
// contraction) in the plain version's order, and the index arithmetic is
// unsigned 32-bit so that it wraps as torch's int32 does. The terms keep
// FMAs inside a term: their sums are held to a tolerance, not to bits.
//
// Every entry point returns cudaGetLastError() so that the Python wrapper
// can raise on a refused launch.

#include <cuda_runtime.h>

#include "block_sum.cuh"

namespace {

constexpr int kThreads = 128;  // THREADS in toyslam_tpu_torch/ops/ndt_kernels.py
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 2;  // lanes a point in the gate pass; LANES in the wrapper
constexpr int kGroup = 32 / kLanes;  // points a warp takes at a time
constexpr int kRepackThreads = 256;  // K2, one thread a pair
constexpr int kTerms = 28;     // 1 score + 6 gradient + 21 Hessian upper
constexpr int kMaxK = 27;      // DIRECT27; MAX_OFFSETS in the wrapper
// A warp's open pairs, (point slot << 5) | offset each: at most 32 x kMaxK.
constexpr int kQueue = 32 * kMaxK;
// params layout (83 floats), as ndt_pallas.py:29-36:
//   0: d1, 1: d2, 2..13: T[:3, :] row-major, 14..37: j_tab [8, 3],
//   38..82: h_tab [15, 3]
constexpr int kPT = 2;
constexpr int kPJ = 14;
constexpr int kPH = 38;
constexpr int kParams = 83;

// The exactly-one-voxel, id-verified gate (ndt.py:782-795) of a row whose
// third 16 bytes are c: valid flag 1 and the voxel-id halves of nvid.
__device__ __forceinline__ bool row_open(float4 c, int nvid) {
  return c.z == static_cast<float>(nvid & 0xFFFF)
      && c.w == static_cast<float>(nvid >> 16) && c.y > 0.5f && c.y < 1.5f;
}

// One hash-table row -> 9 stats channels + the gate. Only loads, compares
// and stores, so K2 is bit-identical to the plain version.
__device__ __forceinline__ void gather_row(const float4* __restrict__ table,
                                           int h, int nvid, unsigned char okm,
                                           float s[10]) {
  const float4* row = table + static_cast<size_t>(h) * 4;
  const float4 a = __ldg(row);
  const float4 b = __ldg(row + 1);
  const float4 c = __ldg(row + 2);
  s[0] = a.x; s[1] = a.y; s[2] = a.z;
  s[3] = a.w; s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w; s[8] = c.x;
  s[9] = (okm != 0 && row_open(c, nvid)) ? 1.0f : 0.0f;
}

// ((T0 x + T1 y) + T2 z) + T3, each operation rounded on its own.
__device__ __forceinline__ float affine_row_rn(const float* T, float x,
                                               float y, float z) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(T[0], x), __fmul_rn(T[1], y)),
                             __fmul_rn(T[2], z)),
                   T[3]);
}

// Voxel cell floor(t / leaf) - min_b of a transformed point, int32 bits.
struct Cell {
  unsigned int i[3];
};

__device__ __forceinline__ Cell cell_of(const float t[3], float inv_leaf,
                                        const int* min_b) {
  Cell c;
#pragma unroll
  for (int a = 0; a < 3; ++a)
    c.i[a] = static_cast<unsigned int>(
                 static_cast<int>(floorf(__fmul_rn(t[a], inv_leaf))))
             - static_cast<unsigned int>(min_b[a]);
  return c;
}

// The DIRECT neighbour at offset off of a cell: slot, expected voxel id and
// the in-bounds flag, as ndt_neighbor_hash_plain computes them.
struct Neighbor {
  int h;
  int nvid;
  bool ok;
};

__device__ __forceinline__ Neighbor neighbor_of(const Cell& c, const int* off,
                                                const int* div,
                                                unsigned int cap_mask) {
  const unsigned int n0 = c.i[0] + static_cast<unsigned int>(off[0]);
  const unsigned int n1 = c.i[1] + static_cast<unsigned int>(off[1]);
  const unsigned int n2 = c.i[2] + static_cast<unsigned int>(off[2]);
  const unsigned int d0 = static_cast<unsigned int>(div[0]);
  const unsigned int d1 = static_cast<unsigned int>(div[1]);
  const bool in_b = static_cast<int>(n0) >= 0 && static_cast<int>(n0) < div[0]
      && static_cast<int>(n1) >= 0 && static_cast<int>(n1) < div[1]
      && static_cast<int>(n2) >= 0 && static_cast<int>(n2) < div[2];
  Neighbor nb;
  nb.nvid = static_cast<int>(n0 + n1 * d0 + n2 * (d0 * d1));
  nb.ok = in_b && nb.nvid >= 0;
  nb.h = nb.ok ? static_cast<int>(static_cast<unsigned int>(nb.nvid) & cap_mask)
               : 0;
  return nb;
}

// The voxel cell of a source point: the hash's rounded transform.
__device__ __forceinline__ Cell cell_of_point(const float* P, float x,
                                              float y, float z,
                                              float inv_leaf,
                                              const int* min_b) {
  float t[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) t[r] = affine_row_rn(P + kPT + 4 * r, x, y, z);
  return cell_of(t, inv_leaf, min_b);
}

// The per-point part of the terms: the transformed point, rounded as the
// plain version rounds it, and the angular products x.j_r, x.h_r (eqs.
// 6.19, 6.21).
struct Point {
  float t[3];
  float xj[8];
  float xh[15];
};

__device__ __forceinline__ Point point_part(const float* P, float x, float y,
                                            float z) {
  Point q;
#pragma unroll
  for (int r = 0; r < 3; ++r) q.t[r] = affine_row_rn(P + kPT + 4 * r, x, y, z);
#pragma unroll
  for (int r = 0; r < 8; ++r)
    q.xj[r] = P[kPJ + 3 * r] * x + P[kPJ + 3 * r + 1] * y + P[kPJ + 3 * r + 2] * z;
#pragma unroll
  for (int r = 0; r < 15; ++r)
    q.xh[r] = P[kPH + 3 * r] * x + P[kPH + 3 * r + 1] * y + P[kPH + 3 * r + 2] * z;
  return q;
}

// Adds the 28 NDT terms of one pair whose voxel gate is open (Magnusson
// 2009 eqs. 6.9-6.13, 6.19, 6.21; the JAX jnp path, ndt.py:885-998) to
// acc[0..28). s: mean(3), icov sym(6).
__device__ __forceinline__ void add_pair_terms(const float* P, const Point& q,
                                               const float s[9],
                                               float (&acc)[32]) {
  const float d1 = P[0];
  const float d2 = P[1];
  const float C[3][3] = {{s[3], s[4], s[5]}, {s[4], s[6], s[7]},
                         {s[5], s[7], s[8]}};
  const float qx = q.t[0] - s[0];
  const float qy = q.t[1] - s[1];
  const float qz = q.t[2] - s[2];
  const float Cqx = C[0][0] * qx + C[0][1] * qy + C[0][2] * qz;
  const float Cqy = C[1][0] * qx + C[1][1] * qy + C[1][2] * qz;
  const float Cqz = C[2][0] * qx + C[2][1] * qy + C[2][2] * qz;
  const float qCq = qx * Cqx + qy * Cqy + qz * Cqz;

  const float e = expf(-0.5f * d2 * qCq);
  const float exc = d2 * e;
  // exc <= 1 && exc >= 0 also rejects NaN and inf (ndt_omp_impl.hpp:506).
  const float gate = (exc <= 1.0f && exc >= 0.0f) ? 1.0f : 0.0f;
  const float factor = d1 * d2 * e * gate;
  const float* xj = q.xj;
  const float* xh = q.xh;

  // u = q^T C J over the 6 chart dims; Jr columns: roll = (0, xj0, xj1),
  // pitch = (xj2, xj3, xj4), yaw = (xj5, xj6, xj7).
  const float u[6] = {Cqx, Cqy, Cqz,
                      Cqy * xj[0] + Cqz * xj[1],
                      Cqx * xj[2] + Cqy * xj[3] + Cqz * xj[4],
                      Cqx * xj[5] + Cqy * xj[6] + Cqz * xj[7]};
  float CJ[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    CJ[r][0] = C[r][1] * xj[0] + C[r][2] * xj[1];
    CJ[r][1] = C[r][0] * xj[2] + C[r][1] * xj[3] + C[r][2] * xj[4];
    CJ[r][2] = C[r][0] * xj[5] + C[r][1] * xj[6] + C[r][2] * xj[7];
  }
  // Second-derivative vectors contracted with Cq, (a, b) upper triangle:
  // (0,0) (0,1) (0,2) (1,1) (1,2) (2,2).
  const float Hv[6] = {Cqy * xh[0] + Cqz * xh[1],
                       Cqy * xh[2] + Cqz * xh[3],
                       Cqy * xh[4] + Cqz * xh[5],
                       Cqx * xh[6] + Cqy * xh[7] + Cqz * xh[8],
                       Cqx * xh[9] + Cqy * xh[10] + Cqz * xh[11],
                       Cqx * xh[12] + Cqy * xh[13] + Cqz * xh[14]};

  // Each term is rounded before it is added, as the plain version sums
  // them: an FMA into the accumulator would shift every gradient sum, and
  // one scan of the odometry cell turns on such a shift (PERF.md section 6).
  acc[0] += -d1 * e * gate;
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[1 + i] += __fmul_rn(factor, u[i]);
  int k = 7;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int b = 0; b < 6; ++b) {  // constant trip counts: acc[] in registers
      if (b < a) continue;
      float c = -d2 * factor * u[a] * u[b];
      if (a < 3 && b < 3) {
        c = c + factor * C[a][b];
      } else if (a < 3) {
        c = c + factor * CJ[a][b - 3];
      } else {
        const int ra = a - 3;
        const int rb = b - 3;
        float col;  // column ra of Jr dotted with column rb of C Jr
        if (ra == 0) {
          col = xj[0] * CJ[1][rb] + xj[1] * CJ[2][rb];
        } else if (ra == 1) {
          col = xj[2] * CJ[0][rb] + xj[3] * CJ[1][rb] + xj[4] * CJ[2][rb];
        } else {
          col = xj[5] * CJ[0][rb] + xj[6] * CJ[1][rb] + xj[7] * CJ[2][rb];
        }
        const int hv = ra == 0 ? rb : (ra == 1 ? 2 + rb : 5);
        c = c + factor * (col + Hv[hv]);
      }
      acc[k++] += c;
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[32]) {
#pragma unroll
  for (int c = 0; c < 32; ++c) acc[c] = 0.0f;
}

// Where this lane's open pairs go in its warp's queue: the count of the
// lanes below it (a shuffle scan); *total gets the warp's count.
__device__ __forceinline__ int queue_start(unsigned int open, int* total) {
  const int lane = threadIdx.x & 31;
  const int count = __popc(open);
  int x = count;
#pragma unroll
  for (int step = 0; step < 5; ++step) {
    const int d = 1 << step;
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  *total = __shfl_sync(0xffffffffu, x, 31);
  return x - count;
}

// Writes this lane's open offsets (bits of open, in order) to the queue,
// tagged with its point's slot in the warp, and returns the warp's count;
// the queue is ready for the whole warp.
__device__ __forceinline__ int enqueue(unsigned int open, int slot,
                                       unsigned short* queue) {
  int total;
  int at = queue_start(open, &total);
  const unsigned short tag = static_cast<unsigned short>(slot << 5);
  while (open) {
    queue[at++] = tag | static_cast<unsigned short>(__ffs(open) - 1);
    open &= open - 1;
  }
  __syncwarp();
  return total;
}

// The grid-stride loop of K1 and K3 walks groups of kGroup points, one a
// warp; lane l tests the gates of point l / kLanes at offsets
// k = l % kLanes, + kLanes, ...
__device__ __forceinline__ long long first_group() {
  return static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
}

__device__ __forceinline__ long long group_stride() {
  return static_cast<long long>(gridDim.x) * kWarps;
}

// K1: hash + gather + gate + terms for fresh (exact-mode) evaluations.
__global__ void __launch_bounds__(kThreads)
terms_gathered_kernel(const float* __restrict__ params,
                      const float* __restrict__ xyz,
                      const unsigned char* __restrict__ mask,
                      const float4* __restrict__ table,
                      const int* __restrict__ min_b,
                      const int* __restrict__ div,
                      const int* __restrict__ offsets,
                      const int* __restrict__ lane_ids, float* partials,
                      float* out, unsigned int* counter, int n, int K,
                      float inv_leaf, unsigned int cap_mask) {
  // Grid row y evaluates lane b: params row y, lane b's points, mask, table
  // [cap, 16] and grid.
  const size_t b = lane_ids ? lane_ids[blockIdx.y] : blockIdx.y;
  params += blockIdx.y * kParams;
  xyz += b * 3 * n;
  mask += b * n;
  table += b * (static_cast<size_t>(cap_mask) + 1) * 4;
  min_b += 3 * b;
  div += 3 * b;
  __shared__ float P[kParams];
  __shared__ int box[6];  // the map's min_b, div
  __shared__ int off[3 * kMaxK];
  __shared__ unsigned short queues[kWarps][kQueue];
  for (int j = threadIdx.x; j < kParams; j += kThreads) P[j] = params[j];
  if (threadIdx.x < 3) {
    box[threadIdx.x] = min_b[threadIdx.x];
    box[3 + threadIdx.x] = div[threadIdx.x];
  }
  for (int j = threadIdx.x; j < 3 * K; j += kThreads) off[j] = offsets[j];
  __syncthreads();
  unsigned short* queue = queues[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;

  float acc[32];
  zero(acc);
  for (long long g = first_group(); g * kGroup < n; g += group_stride()) {
    const int base = static_cast<int>(g * kGroup);
    const int p = base + lane / kLanes;
    unsigned int open = 0;
    if (p < n && mask[p]) {
      const Cell cell = cell_of_point(P, xyz[p], xyz[n + p], xyz[2 * n + p],
                                      inv_leaf, box);
      for (int k = lane % kLanes; k < K; k += kLanes) {
        const Neighbor nb = neighbor_of(cell, off + 3 * k, box + 3, cap_mask);
        if (nb.ok && row_open(__ldg(table + static_cast<size_t>(nb.h) * 4 + 2),
                              nb.nvid))
          open |= 1u << k;
      }
    }
    const int total = enqueue(open, lane / kLanes, queue);
    for (int j = lane; j < total; j += 32) {
      const int q = base + (queue[j] >> 5);
      const int k = queue[j] & 31;
      const Point pt = point_part(P, xyz[q], xyz[n + q], xyz[2 * n + q]);
      const Neighbor nb = neighbor_of(cell_of(pt.t, inv_leaf, box),
                                      off + 3 * k, box + 3, cap_mask);
      float s[10];
      gather_row(table, nb.h, nb.nvid, 1, s);
      add_pair_terms(P, pt, s, acc);
    }
    __syncwarp();  // the queue is read before the next group writes it
  }
  grid_sum<kThreads, kTerms>(acc, partials, out, counter);
}

// K2: gather + gate -> compact [10, K*N] stats (offset-major).
__global__ void __launch_bounds__(kRepackThreads)
gather_repack_kernel(const float4* __restrict__ table,
                     const int* __restrict__ h, const int* __restrict__ nvid,
                     const unsigned char* __restrict__ okm,
                     float* __restrict__ out, int kn) {
  const int i = blockIdx.x * kRepackThreads + threadIdx.x;
  if (i >= kn) return;
  float s[10];
  gather_row(table, h[i], nvid[i], okm[i], s);
#pragma unroll
  for (int c = 0; c < 10; ++c) out[static_cast<size_t>(c) * kn + i] = s[c];
}

// K3: terms from compact stats (frozen-neighbourhood evaluations). The
// gate row is read for every pair, the other nine only for open ones.
__global__ void __launch_bounds__(kThreads)
terms_packed_kernel(const float* __restrict__ params,
                    const float* __restrict__ xyz,
                    const float* __restrict__ st,
                    const int* __restrict__ lane_ids, float* partials,
                    float* out, unsigned int* counter, int n, int K) {
  // Grid row y evaluates lane b: params row y, lane b's points and stats.
  const size_t b = lane_ids ? lane_ids[blockIdx.y] : blockIdx.y;
  params += blockIdx.y * kParams;
  xyz += b * 3 * n;
  st += b * 10 * static_cast<size_t>(K) * n;
  __shared__ float P[kParams];
  __shared__ unsigned short queues[kWarps][kQueue];
  for (int j = threadIdx.x; j < kParams; j += kThreads) P[j] = params[j];
  __syncthreads();
  unsigned short* queue = queues[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;

  const size_t kn = static_cast<size_t>(K) * n;
  const float* gate = st + 9 * kn;
  float acc[32];
  zero(acc);
  for (long long g = first_group(); g * kGroup < n; g += group_stride()) {
    const int base = static_cast<int>(g * kGroup);
    const int p = base + lane / kLanes;
    unsigned int open = 0;
    if (p < n) {
      for (int k = lane % kLanes; k < K; k += kLanes)
        if (__ldg(gate + static_cast<size_t>(k) * n + p) > 0.5f) open |= 1u << k;
    }
    const int total = enqueue(open, lane / kLanes, queue);
    for (int j = lane; j < total; j += 32) {
      const int q = base + (queue[j] >> 5);
      const int k = queue[j] & 31;
      const Point pt = point_part(P, xyz[q], xyz[n + q], xyz[2 * n + q]);
      const float* pair = st + static_cast<size_t>(k) * n + q;
      float s[9];
#pragma unroll
      for (int c = 0; c < 9; ++c) s[c] = __ldg(pair + c * kn);
      add_pair_terms(P, pt, s, acc);
    }
    __syncwarp();  // the queue is read before the next group writes it
  }
  grid_sum<kThreads, kTerms>(acc, partials, out, counter);
}

inline cudaStream_t as_stream(void* stream) {
  return static_cast<cudaStream_t>(stream);
}

}  // namespace

// K1 over L lanes (lane_ids may be null: grid row y is lane y).
extern "C" int ndt_terms_gathered(const void* params, const void* xyz,
                                  const void* mask, const void* table,
                                  const void* min_b, const void* div,
                                  const void* offsets, const void* lane_ids,
                                  void* partials, void* out, void* counter,
                                  long long n, long long K, float inv_leaf,
                                  long long cap_mask, long long blocks,
                                  long long lanes, void* stream) {
  const dim3 grid(static_cast<unsigned int>(blocks),
                  static_cast<unsigned int>(lanes));
  terms_gathered_kernel<<<grid, kThreads, 0, as_stream(stream)>>>(
      static_cast<const float*>(params), static_cast<const float*>(xyz),
      static_cast<const unsigned char*>(mask),
      static_cast<const float4*>(table), static_cast<const int*>(min_b),
      static_cast<const int*>(div), static_cast<const int*>(offsets),
      static_cast<const int*>(lane_ids),
      static_cast<float*>(partials), static_cast<float*>(out),
      static_cast<unsigned int*>(counter), static_cast<int>(n),
      static_cast<int>(K), inv_leaf, static_cast<unsigned int>(cap_mask));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ndt_gather_repack(const void* table, const void* h,
                                 const void* nvid, const void* okm, void* out,
                                 long long kn, void* stream) {
  gather_repack_kernel<<<static_cast<int>((kn + kRepackThreads - 1) /
                                          kRepackThreads),
                         kRepackThreads, 0, as_stream(stream)>>>(
      static_cast<const float4*>(table), static_cast<const int*>(h),
      static_cast<const int*>(nvid), static_cast<const unsigned char*>(okm),
      static_cast<float*>(out), static_cast<int>(kn));
  return static_cast<int>(cudaGetLastError());
}

// K3 over L lanes (lane_ids may be null: grid row y is lane y).
extern "C" int ndt_terms_packed(const void* params, const void* xyz,
                                const void* st, const void* lane_ids,
                                void* partials, void* out, void* counter,
                                long long n, long long K, long long blocks,
                                long long lanes, void* stream) {
  const dim3 grid(static_cast<unsigned int>(blocks),
                  static_cast<unsigned int>(lanes));
  terms_packed_kernel<<<grid, kThreads, 0, as_stream(stream)>>>(
      static_cast<const float*>(params), static_cast<const float*>(xyz),
      static_cast<const float*>(st), static_cast<const int*>(lane_ids),
      static_cast<float*>(partials),
      static_cast<float*>(out), static_cast<unsigned int*>(counter),
      static_cast<int>(n), static_cast<int>(K));
  return static_cast<int>(cudaGetLastError());
}
