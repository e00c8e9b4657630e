// GICP Gauss-Newton sums for Hopper (sm_90a): K6 of the port.
//
// Replaces the Pallas TPU kernel of toyslam_tpu/ops/gicp_pallas.py:
//   gicp_terms  <- gicp_terms / _kernel  (gicp_pallas.py:104/35)
//
// Per correspondence (source point s, matched target q, symmetric
// Mahalanobis M, weight w) at the pose (R, t): a = R s, r = a + t - q,
// M r, B = M S^T and S B with S = skew(a); and the 27 weighted sums of
// gicp_pallas.py:87-94: gradient [w M r, w a x M r] (6), A_tt = w M upper
// (6), A_tr = w B row-major (9), A_rr = w S B upper (6).
//
// What bounds it: reading 52 bytes per correspondence (1.7 MB at N =
// 32768) against ~130 flops; at that size a launch costs more than either,
// so the design is about latency: enough warps in flight, a short sum, and
// one device operation a call.
// - kThreads threads a block, each taking kPer correspondences, i =
//   (block * kPer + j) * kThreads + thread for j = 0 .. kPer - 1 in order
//   (coalesced structure-of-arrays loads, all of a thread's loads issued
//   before its arithmetic). At N = 32768 that is 128 blocks of 128 threads,
//   about one block an SM; 64 x 4, 128 x 1, 256 x 1 and 256 x 2 were timed
//   against it (diag/kernel_variants.py).
// - Each term is rounded as the plain products round it and then added to
//   the thread's running sums with __fadd_rn, so no FMA contracts a product
//   into a sum.
// - One launch: grid_sum (block_sum.cuh) adds the threads' sums by warp
//   halving exchanges, the warps in order, and the blocks' rows in order in
//   the last block to finish, which writes the 27 sums. No float atomics:
//   reruns are bit-identical. Any N works: threads past N add nothing.
//
// gicp_update: the rest of a Gauss-Newton step after K6, in one launch. It
// replaces no TPU kernel: the JAX package solves and updates in jnp
// (toyslam_tpu/registration/gicp.py:326-330), which XLA fuses into its loop
// on the TPU, while each PyTorch op of it is a launch of its own (about 53
// a step around K6's one). One thread reads K6's 27 sums, the step's pose
// params [12] and the damping, and writes the next pose params [12]:
//   A = the sums in the row-major 6x6 layout + damping I, g = sums 0-5;
//   dx = -A^-1 g by an LU with partial pivoting (the first largest pivot,
//   as getrf's isamax picks it), forward and back substitution;
//   R' = so3_exp(dx[3:6]) R (Rodrigues with the Taylor terms below 1e-7
//   rad, precise sinf/cosf), t' = t + dx[:3].
// What bounds it: ~250 f32 operations, most of them dependent, in one
// thread, and a launch; the 204 bytes it moves are nothing. The design is
// about launches: the step's ops become one, and its output is K6's next
// params, so nothing sits between two steps on the device or the host.
//
// gicp_empty launches an empty kernel on K6's grid, so that a check can set
// K6's device time beside the cost of a launch of that shape.
//
// The entry points return cudaGetLastError() so that the Python wrapper can
// raise on a refused launch.

#include <cuda_runtime.h>

#include "block_sum.cuh"

namespace {

constexpr int kThreads = 128;  // THREADS in toyslam_tpu_torch/ops/gicp_kernels.py
constexpr int kPer = 2;        // PER_THREAD there: correspondences a thread
constexpr int kTerms = 27;     // 6 gradient + 6 A_tt + 9 A_tr + 6 A_rr
constexpr int kSlots = 28;     // the terms padded to rows of whole float4s
constexpr int kParams = 12;    // R row-major (9), t (3)

__device__ __forceinline__ void pair_terms(const float* P, float x, float y,
                                           float z, float qx, float qy,
                                           float qz, const float m[6], float w,
                                           float t[kTerms]) {
  const float m00 = m[0], m01 = m[1], m02 = m[2];
  const float m11 = m[3], m12 = m[4], m22 = m[5];
  const float ax = P[0] * x + P[1] * y + P[2] * z;
  const float ay = P[3] * x + P[4] * y + P[5] * z;
  const float az = P[6] * x + P[7] * y + P[8] * z;
  const float rx = ax + P[9] - qx;
  const float ry = ay + P[10] - qy;
  const float rz = az + P[11] - qz;

  const float mrx = m00 * rx + m01 * ry + m02 * rz;
  const float mry = m01 * rx + m11 * ry + m12 * rz;
  const float mrz = m02 * rx + m12 * ry + m22 * rz;

  // B = M S^T = -(M S)
  const float b00 = -(m01 * az - m02 * ay);
  const float b01 = -(-m00 * az + m02 * ax);
  const float b02 = -(m00 * ay - m01 * ax);
  const float b10 = -(m11 * az - m12 * ay);
  const float b11 = -(-m01 * az + m12 * ax);
  const float b12 = -(m01 * ay - m11 * ax);
  const float b20 = -(m12 * az - m22 * ay);
  const float b21 = -(-m02 * az + m22 * ax);
  const float b22 = -(m02 * ay - m12 * ax);

  // S B, upper triangle
  const float c00 = -az * b10 + ay * b20;
  const float c01 = -az * b11 + ay * b21;
  const float c02 = -az * b12 + ay * b22;
  const float c11 = az * b01 - ax * b21;
  const float c12 = az * b02 - ax * b22;
  const float c22 = -ay * b02 + ax * b12;

  t[0] = w * mrx;
  t[1] = w * mry;
  t[2] = w * mrz;
  t[3] = w * (ay * mrz - az * mry);
  t[4] = w * (az * mrx - ax * mrz);
  t[5] = w * (ax * mry - ay * mrx);
  t[6] = w * m00;
  t[7] = w * m01;
  t[8] = w * m02;
  t[9] = w * m11;
  t[10] = w * m12;
  t[11] = w * m22;
  t[12] = w * b00;
  t[13] = w * b01;
  t[14] = w * b02;
  t[15] = w * b10;
  t[16] = w * b11;
  t[17] = w * b12;
  t[18] = w * b20;
  t[19] = w * b21;
  t[20] = w * b22;
  t[21] = w * c00;
  t[22] = w * c01;
  t[23] = w * c02;
  t[24] = w * c11;
  t[25] = w * c12;
  t[26] = w * c22;
}

__global__ void __launch_bounds__(kThreads)
gicp_terms_kernel(const float* __restrict__ params,
                  const float* __restrict__ xyz, const float* __restrict__ q,
                  const float* __restrict__ m6, const float* __restrict__ w,
                  float* partials, float* out, unsigned int* counter, int n) {
  __shared__ float P[kParams];
  if (threadIdx.x < kParams) P[threadIdx.x] = params[threadIdx.x];
  const size_t nn = static_cast<size_t>(n);
  // The thread's correspondences, loaded before any arithmetic (w = 0 and
  // zeros past N: their terms are exact zeros and are not added).
  float in[kPer][16];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const size_t i = (static_cast<size_t>(blockIdx.x) * kPer + j) * kThreads +
                     threadIdx.x;
    const bool ok = i < nn;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      in[j][c] = ok ? xyz[c * nn + i] : 0.0f;
      in[j][3 + c] = ok ? q[c * nn + i] : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) in[j][6 + c] = ok ? m6[c * nn + i] : 0.0f;
    in[j][12] = ok ? w[i] : 0.0f;
  }
  __syncthreads();  // P
  float acc[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) acc[c] = 0.0f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const size_t i = (static_cast<size_t>(blockIdx.x) * kPer + j) * kThreads +
                     threadIdx.x;
    if (i < nn) {
      float t[kTerms];
      pair_terms(P, in[j][0], in[j][1], in[j][2], in[j][3], in[j][4],
                 in[j][5], in[j] + 6, in[j][12], t);
#pragma unroll
      for (int c = 0; c < kTerms; ++c) acc[c] = __fadd_rn(acc[c], t[c]);
    }
  }
  grid_sum<kThreads, kSlots>(acc, partials, out, counter);
}

constexpr int kDim = 6;  // the GN step's unknowns: dt (3), dtheta (3)

// Index into the 27 sums of the row-major 6x6 normal matrix's entry
// (i, j): [[A_tt, A_tr], [A_tr^T, A_rr]] (A_INDEX in
// toyslam_tpu_torch/ops/gicp_kernels.py).
__device__ constexpr int upper3(int a, int b) {
  return a <= b ? 3 * a - a * (a - 1) / 2 + (b - a) : upper3(b, a);
}

__device__ constexpr int a_index(int i, int j) {
  return i < 3 && j < 3 ? 6 + upper3(i, j)
         : i < 3        ? 12 + 3 * i + (j - 3)
         : j < 3        ? 12 + 3 * j + (i - 3)
                        : 21 + upper3(i - 3, j - 3);
}

__global__ void __launch_bounds__(1)
gicp_update_kernel(const float* __restrict__ s27,
                   const float* __restrict__ params, float damping,
                   float* __restrict__ out) {
  // Every loop has a constant trip count and is unrolled, so that the
  // arrays stay in registers; the row swap is a select on each row.
  float A[kDim][kDim], b[kDim], P[kParams];
#pragma unroll
  for (int i = 0; i < kDim; ++i) {
#pragma unroll
    for (int j = 0; j < kDim; ++j) A[i][j] = s27[a_index(i, j)];
    b[i] = s27[i];
    A[i][i] += damping;
  }
#pragma unroll
  for (int c = 0; c < kParams; ++c) P[c] = params[c];

  // LU with partial pivoting, the multipliers applied to b as they come.
#pragma unroll
  for (int k = 0; k < kDim; ++k) {
    int p = k;
    float best = fabsf(A[k][k]);
#pragma unroll
    for (int r = k + 1; r < kDim; ++r) {
      if (fabsf(A[r][k]) > best) {
        best = fabsf(A[r][k]);
        p = r;
      }
    }
#pragma unroll
    for (int r = k + 1; r < kDim; ++r) {
      if (r == p) {
#pragma unroll
        for (int c = k; c < kDim; ++c) {
          const float x = A[k][c];
          A[k][c] = A[r][c];
          A[r][c] = x;
        }
        const float x = b[k];
        b[k] = b[r];
        b[r] = x;
      }
    }
#pragma unroll
    for (int r = k + 1; r < kDim; ++r) {
      const float l = A[r][k] / A[k][k];
#pragma unroll
      for (int c = k + 1; c < kDim; ++c) A[r][c] -= l * A[k][c];
      b[r] -= l * b[k];
    }
  }
  float dx[kDim];
#pragma unroll
  for (int k = kDim - 1; k >= 0; --k) {
    float s = b[k];
#pragma unroll
    for (int c = k + 1; c < kDim; ++c) s -= A[k][c] * dx[c];
    dx[k] = s / A[k][k];
  }
#pragma unroll
  for (int k = 0; k < kDim; ++k) dx[k] = -dx[k];

  // so3_exp(w) = I + a K + b K K, K = skew(w), as core/se3.so3_exp has it.
  const float wx = dx[3], wy = dx[4], wz = dx[5];
  const float theta = sqrtf(wx * wx + wy * wy + wz * wz);
  const bool small = theta < 1e-7f;
  const float ca = small ? 1.0f - theta * theta / 6.0f : sinf(theta) / theta;
  const float cb = small ? 0.5f - theta * theta / 24.0f
                         : (1.0f - cosf(theta)) / (theta * theta);
  const float K[3][3] = {{0.0f, -wz, wy}, {wz, 0.0f, -wx}, {-wy, wx, 0.0f}};
  float E[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float kk = K[i][0] * K[0][j] + K[i][1] * K[1][j] +
                       K[i][2] * K[2][j];
      E[i][j] = (i == j ? 1.0f : 0.0f) + ca * K[i][j] + cb * kk;
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      out[3 * i + j] = E[i][0] * P[j] + E[i][1] * P[3 + j] +
                       E[i][2] * P[6 + j];
    }
    out[9 + i] = P[9 + i] + dx[i];
  }
}

__global__ void gicp_empty_kernel() {}

inline cudaStream_t as_stream(void* stream) {
  return static_cast<cudaStream_t>(stream);
}

}  // namespace

extern "C" int gicp_terms(const void* params, const void* xyz, const void* q,
                          const void* m6, const void* w, void* partials,
                          void* out, void* counter, long long n,
                          long long blocks, void* stream) {
  gicp_terms_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      as_stream(stream)>>>(
      static_cast<const float*>(params), static_cast<const float*>(xyz),
      static_cast<const float*>(q), static_cast<const float*>(m6),
      static_cast<const float*>(w), static_cast<float*>(partials),
      static_cast<float*>(out), static_cast<unsigned int*>(counter),
      static_cast<int>(n));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gicp_update(const void* s27, const void* params,
                           float damping, void* out, void* stream) {
  gicp_update_kernel<<<1, 1, 0, as_stream(stream)>>>(
      static_cast<const float*>(s27), static_cast<const float*>(params),
      damping, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gicp_empty(long long blocks, void* stream) {
  gicp_empty_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      as_stream(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
