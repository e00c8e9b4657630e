// NDT derivative kernels for Hopper (sm_90a): K1, K2 and K3 of the port.
//
// Replaces the three Pallas TPU kernels of toyslam_tpu/ops/ndt_pallas.py:
//   ndt_terms_gathered  <- ndt_terms_raw / _kernel_raw  (ndt_pallas.py:271/145)
//   ndt_gather_repack   <- ndt_repack / _repack_kernel  (ndt_pallas.py:323/312)
//   ndt_terms_packed    <- ndt_terms / _kernel          (ndt_pallas.py:355/39)
//
// Mosaic cannot gather inside a kernel, so the TPU path materialised a
// [K*N, 16] row-gather buffer in HBM before its kernels ran. Hopper can
// gather in-kernel, so K1 and K2 take the hash table itself plus the hash
// slot h, the expected voxel id nvid and the in-bounds & source-mask flag
// okm of every (offset, point) pair (computed by the plain-torch
// _neighbor_hash), and load each pair's 64-byte row directly.
//
// What bounds them: one random 48-byte read of a 64-byte table row per pair
// (the table is 2-4 MB and stays in the 50 MB L2) plus about 300 flops per
// pair for the 28 terms. The design is simple on purpose: one thread per
// (offset, point) pair, offset-major like the JAX layout. Vectorised
// per-point loops over K and warp-level reductions are later work.
//
// Sums are deterministic: each block reduces its 28 terms by the fixed
// shared-memory tree of block_sum.cuh into one row of [num_blocks, 28]
// partials; the caller finishes with a torch.sum over blocks.
//
// Every entry point returns cudaGetLastError() so that the Python wrapper
// can raise on a refused launch.

#include <cuda_runtime.h>

#include "block_sum.cuh"

namespace {

constexpr int kThreads = 256;  // THREADS in toyslam_tpu_torch/ops/ndt_kernels.py
constexpr int kTerms = 28;     // 1 score + 6 gradient + 21 Hessian upper
// params layout (83 floats), as ndt_pallas.py:29-36:
//   0: d1, 1: d2, 2..13: T[:3, :] row-major, 14..37: j_tab [8, 3],
//   38..82: h_tab [15, 3]
constexpr int kPT = 2;
constexpr int kPJ = 14;
constexpr int kPH = 38;
constexpr int kParams = 83;

// One hash-table row -> 9 stats channels + the exactly-one-voxel,
// id-verified gate (ndt.py:782-795). Only loads, compares and stores, so
// K2 is bit-identical to the plain version.
__device__ __forceinline__ void gather_row(const float4* __restrict__ table,
                                           int h, int nvid, unsigned char okm,
                                           float s[10]) {
  const float4* row = table + static_cast<size_t>(h) * 4;
  const float4 a = __ldg(row);
  const float4 b = __ldg(row + 1);
  const float4 c = __ldg(row + 2);
  s[0] = a.x; s[1] = a.y; s[2] = a.z;
  s[3] = a.w; s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w; s[8] = c.x;
  const float vox = c.y;
  const bool ok = okm != 0
      && c.z == static_cast<float>(nvid & 0xFFFF)
      && c.w == static_cast<float>(nvid >> 16)
      && vox > 0.5f && vox < 1.5f;
  s[9] = ok ? 1.0f : 0.0f;
}

// The 28 NDT terms of one (offset, point) pair (Magnusson 2009 eqs.
// 6.9-6.13, 6.19, 6.21), written as the JAX jnp path (ndt.py:885-998).
__device__ __forceinline__ void pair_terms(const float* P, float x, float y,
                                           float z, const float s[10],
                                           float t[kTerms]) {
  const float d1 = P[0];
  const float d2 = P[1];
  const float tx = P[kPT + 0] * x + P[kPT + 1] * y + P[kPT + 2] * z + P[kPT + 3];
  const float ty = P[kPT + 4] * x + P[kPT + 5] * y + P[kPT + 6] * z + P[kPT + 7];
  const float tz = P[kPT + 8] * x + P[kPT + 9] * y + P[kPT + 10] * z + P[kPT + 11];

  const float C[3][3] = {{s[3], s[4], s[5]}, {s[4], s[6], s[7]},
                         {s[5], s[7], s[8]}};
  const float qx = tx - s[0];
  const float qy = ty - s[1];
  const float qz = tz - s[2];
  const float Cqx = C[0][0] * qx + C[0][1] * qy + C[0][2] * qz;
  const float Cqy = C[1][0] * qx + C[1][1] * qy + C[1][2] * qz;
  const float Cqz = C[2][0] * qx + C[2][1] * qy + C[2][2] * qz;
  const float qCq = qx * Cqx + qy * Cqy + qz * Cqz;

  const float e = expf(-0.5f * d2 * qCq);
  const float exc = d2 * e;
  // exc <= 1 && exc >= 0 also rejects NaN and inf (ndt_omp_impl.hpp:506).
  const float gate = (exc <= 1.0f && exc >= 0.0f && s[9] > 0.5f) ? 1.0f : 0.0f;
  const float factor = d1 * d2 * e * gate;

  float xj[8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
    xj[r] = P[kPJ + 3 * r] * x + P[kPJ + 3 * r + 1] * y + P[kPJ + 3 * r + 2] * z;
  float xh[15];
#pragma unroll
  for (int r = 0; r < 15; ++r)
    xh[r] = P[kPH + 3 * r] * x + P[kPH + 3 * r + 1] * y + P[kPH + 3 * r + 2] * z;

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

  t[0] = -d1 * e * gate;
#pragma unroll
  for (int i = 0; i < 6; ++i) t[1 + i] = factor * u[i];
  int k = 7;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int b = a; b < 6; ++b) {
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
      t[k++] = c;
    }
  }
}

__device__ __forceinline__ void load_params(const float* __restrict__ params,
                                            float* P) {
  for (int j = threadIdx.x; j < kParams; j += blockDim.x) P[j] = params[j];
  __syncthreads();
}

// K1: gather + gate + terms for fresh (exact-mode) evaluations.
__global__ void __launch_bounds__(kThreads)
terms_gathered_kernel(const float* __restrict__ params,
                      const float* __restrict__ xyz,
                      const float4* __restrict__ table,
                      const int* __restrict__ h, const int* __restrict__ nvid,
                      const unsigned char* __restrict__ okm,
                      float* __restrict__ partials, int n, int kn) {
  __shared__ float P[kParams];
  load_params(params, P);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float t[kTerms];
  if (i < kn) {
    const int p = i % n;
    float s[10];
    gather_row(table, h[i], nvid[i], okm[i], s);
    pair_terms(P, xyz[p], xyz[n + p], xyz[2 * n + p], s, t);
  } else {
#pragma unroll
    for (int c = 0; c < kTerms; ++c) t[c] = 0.0f;
  }
  block_sum_store<kTerms, kThreads>(t, partials);
}

// K2: gather + gate -> compact [10, K*N] stats (offset-major).
__global__ void __launch_bounds__(kThreads)
gather_repack_kernel(const float4* __restrict__ table,
                     const int* __restrict__ h, const int* __restrict__ nvid,
                     const unsigned char* __restrict__ okm,
                     float* __restrict__ out, int kn) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= kn) return;
  float s[10];
  gather_row(table, h[i], nvid[i], okm[i], s);
#pragma unroll
  for (int c = 0; c < 10; ++c) out[static_cast<size_t>(c) * kn + i] = s[c];
}

// K3: terms from compact stats (frozen-neighbourhood evaluations).
__global__ void __launch_bounds__(kThreads)
terms_packed_kernel(const float* __restrict__ params,
                    const float* __restrict__ xyz,
                    const float* __restrict__ st,
                    float* __restrict__ partials, int n, int kn) {
  __shared__ float P[kParams];
  load_params(params, P);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float t[kTerms];
  if (i < kn) {
    const int p = i % n;
    float s[10];
#pragma unroll
    for (int c = 0; c < 10; ++c) s[c] = st[static_cast<size_t>(c) * kn + i];
    pair_terms(P, xyz[p], xyz[n + p], xyz[2 * n + p], s, t);
  } else {
#pragma unroll
    for (int c = 0; c < kTerms; ++c) t[c] = 0.0f;
  }
  block_sum_store<kTerms, kThreads>(t, partials);
}

inline int num_blocks(long long kn) {
  return static_cast<int>((kn + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int ndt_terms_gathered(const void* params, const void* xyz,
                                  const void* table, const void* h,
                                  const void* nvid, const void* okm,
                                  void* partials, long long n, long long kn,
                                  void* stream) {
  terms_gathered_kernel<<<num_blocks(kn), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(params), static_cast<const float*>(xyz),
      static_cast<const float4*>(table), static_cast<const int*>(h),
      static_cast<const int*>(nvid), static_cast<const unsigned char*>(okm),
      static_cast<float*>(partials), static_cast<int>(n),
      static_cast<int>(kn));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ndt_gather_repack(const void* table, const void* h,
                                 const void* nvid, const void* okm, void* out,
                                 long long kn, void* stream) {
  gather_repack_kernel<<<num_blocks(kn), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(table), static_cast<const int*>(h),
      static_cast<const int*>(nvid), static_cast<const unsigned char*>(okm),
      static_cast<float*>(out), static_cast<int>(kn));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ndt_terms_packed(const void* params, const void* xyz,
                                const void* st, void* partials, long long n,
                                long long kn, void* stream) {
  terms_packed_kernel<<<num_blocks(kn), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(params), static_cast<const float*>(xyz),
      static_cast<const float*>(st), static_cast<float*>(partials),
      static_cast<int>(n), static_cast<int>(kn));
  return static_cast<int>(cudaGetLastError());
}
