// Batched symmetric 3x3 eigensolver for Hopper (sm_90a): ops/eigh3's
// eigh3_soa in one launch.
//
// It replaces no TPU kernel: toyslam_tpu/ops/eigh3.py is plain jnp, which
// XLA fuses into a few loops on the TPU, while each PyTorch op of the plain
// version (eigh3_soa_plain) is a launch of its own, ~1041 a call. Its
// callers are LOAM's line and plane fits (20 calls a scan), GICP's
// covariances (2 an align) and the NDT map build (1 a map).
//
// One thread a matrix: it reads the six components (00 01 02 11 12 22),
// each at its own element stride, so the callers' views (a [N, 3, 3]
// tensor's entries at stride 9, a [B, V, 6] tensor's at stride 6) need no
// copy; scales them by their largest magnitude; runs `sweeps` cyclic Jacobi
// sweeps over the (0,1), (0,2), (1,2) pairs with the symmetric entries and
// the nine eigenvector entries in registers; undoes the scale and sorts the
// eigenpairs ascending by a 3-element network; and writes out [12, N]: the
// three eigenvalues, then v[i][j] (component i of eigenvector j) in
// row-major order.
//
// Bit-identical to the plain version on the card, NaN and inf included:
// every plain op is one rounded torch kernel, so each step here is one
// rounded operation in the plain order (the Rn<T> intrinsics: no FMA
// contraction, true division and square root). Where torch's definitions
// matter: amax propagates NaN, clamp(min=) keeps NaN, `1.0 / x` is
// x.reciprocal() * 1.0 (the product is exact), `2.0 * s` is exact, and
// torch.sign's value at 0 and NaN never reaches an output (tau == 0 is
// replaced by the where, and a NaN tau makes t NaN whatever its sign).
//
// What bounds it: not the bytes (24 read and 48 written a matrix in f32,
// 0.7 us at N = 32768 at 3.35 TB/s) but each thread's dependent chain of
// ~760 rounded operations, 45 of them divisions and 30 square roots at
// IEEE precision: on an H100 (700 W) a launch takes 14.6 us at N = 768
// and 15.4 us at N = 32768, against the plain version's 1.3-1.4 ms of
// device time in ~1041 launches. The design is about launches, which set
// the callers' pace: one device operation a call.
//
// Entry points return cudaGetLastError() so that the Python wrapper can
// raise on a refused launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // THREADS in toyslam_tpu_torch/ops/eigh3_kernels.py

template <typename T>
struct Rn;

template <>
struct Rn<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float sqrt(float a) { return __fsqrt_rn(a); }
};

template <>
struct Rn<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double sqrt(double a) { return __dsqrt_rn(a); }
};

// torch.amax's pairwise step: NaN wins.
template <typename T>
__device__ __forceinline__ T max_nan(T m, T a) {
  return (a != a || a > m) ? a : m;
}

// One Jacobi rotation zeroing (p, q); r is the untouched index.
// _rot_coeffs then the update of eigh3_soa_plain, op for op.
template <typename T, int p, int q>
__device__ __forceinline__ void rotate(T A[3][3], T V[3][3]) {
  using R = Rn<T>;
  constexpr int r = 3 - p - q;
  const T one = T(1), zero = T(0), two = T(2);
  const T app = A[p][p], aqq = A[q][q], apq = A[p][q];
  const T tau = R::div(R::sub(aqq, app), R::mul(two, apq == zero ? one : apq));
  const T sgn = T((zero < tau) - (tau < zero));
  T t = R::div(sgn, R::add(fabs(tau), R::sqrt(R::add(R::mul(tau, tau), one))));
  t = apq == zero ? zero : (tau == zero ? one : t);
  const T c = R::div(one, R::sqrt(R::add(R::mul(t, t), one)));
  const T s = R::mul(t, c);

  const T cc = R::mul(c, c), ss = R::mul(s, s);
  const T sc2 = R::mul(R::mul(R::mul(two, s), c), apq);
  const T new_pp = R::add(R::sub(R::mul(cc, app), sc2), R::mul(ss, aqq));
  const T new_qq = R::add(R::add(R::mul(ss, app), sc2), R::mul(cc, aqq));
  const T arp = R::sub(R::mul(c, A[r][p]), R::mul(s, A[r][q]));
  const T arq = R::add(R::mul(s, A[r][p]), R::mul(c, A[r][q]));
  A[p][p] = new_pp;
  A[q][q] = new_qq;
  A[p][q] = A[q][p] = zero;
  A[r][p] = A[p][r] = arp;
  A[r][q] = A[q][r] = arq;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T vip = R::sub(R::mul(c, V[i][p]), R::mul(s, V[i][q]));
    const T viq = R::add(R::mul(s, V[i][p]), R::mul(c, V[i][q]));
    V[i][p] = vip;
    V[i][q] = viq;
  }
}

// The sort network's compare-exchange: where(ev[i] > ev[j], swap).
template <typename T, int i, int j>
__device__ __forceinline__ void cswap(T ev[3], T V[3][3]) {
  if (ev[i] > ev[j]) {
    const T e = ev[i];
    ev[i] = ev[j];
    ev[j] = e;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const T v = V[k][i];
      V[k][i] = V[k][j];
      V[k][j] = v;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
eigh3_kernel(const T* __restrict__ a00, const T* __restrict__ a01,
             const T* __restrict__ a02, const T* __restrict__ a11,
             const T* __restrict__ a12, const T* __restrict__ a22,
             long long s00, long long s01, long long s02, long long s11,
             long long s12, long long s22, T* __restrict__ out, int n,
             int sweeps) {
  using R = Rn<T>;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long k = i;
  const T x00 = a00[k * s00], x01 = a01[k * s01], x02 = a02[k * s02];
  const T x11 = a11[k * s11], x12 = a12[k * s12], x22 = a22[k * s22];

  // stack([|a00|, |a11|, |a22|, |a01|, |a02|, |a12|]).amax(0).clamp(min=1e-30)
  T scale = fabs(x00);
  scale = max_nan(scale, fabs(x11));
  scale = max_nan(scale, fabs(x22));
  scale = max_nan(scale, fabs(x01));
  scale = max_nan(scale, fabs(x02));
  scale = max_nan(scale, fabs(x12));
  const T floor_ = T(1e-30);
  scale = (scale != scale || scale >= floor_) ? scale : floor_;

  T A[3][3], V[3][3];
  A[0][0] = R::div(x00, scale);
  A[0][1] = A[1][0] = R::div(x01, scale);
  A[0][2] = A[2][0] = R::div(x02, scale);
  A[1][1] = R::div(x11, scale);
  A[1][2] = A[2][1] = R::div(x12, scale);
  A[2][2] = R::div(x22, scale);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) V[r][c] = T(r == c ? 1 : 0);
  }

#pragma unroll 5
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    rotate<T, 0, 1>(A, V);
    rotate<T, 0, 2>(A, V);
    rotate<T, 1, 2>(A, V);
  }

  T ev[3] = {R::mul(A[0][0], scale), R::mul(A[1][1], scale),
             R::mul(A[2][2], scale)};
  cswap<T, 0, 1>(ev, V);
  cswap<T, 1, 2>(ev, V);
  cswap<T, 0, 1>(ev, V);

#pragma unroll
  for (int e = 0; e < 3; ++e) out[e * static_cast<long long>(n) + k] = ev[e];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      out[(3 + 3 * r + c) * static_cast<long long>(n) + k] = V[r][c];
  }
}

template <typename T>
int launch(const void* a00, const void* a01, const void* a02,
           const void* a11, const void* a12, const void* a22, long long s00,
           long long s01, long long s02, long long s11, long long s12,
           long long s22, void* out, long long n, int sweeps, void* stream) {
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  eigh3_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a00), static_cast<const T*>(a01),
      static_cast<const T*>(a02), static_cast<const T*>(a11),
      static_cast<const T*>(a12), static_cast<const T*>(a22), s00, s01, s02,
      s11, s12, s22, static_cast<T*>(out), static_cast<int>(n), sweeps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int eigh3_f32(const void* a00, const void* a01, const void* a02,
                         const void* a11, const void* a12, const void* a22,
                         long long s00, long long s01, long long s02,
                         long long s11, long long s12, long long s22,
                         void* out, long long n, int sweeps, void* stream) {
  return launch<float>(a00, a01, a02, a11, a12, a22, s00, s01, s02, s11, s12,
                       s22, out, n, sweeps, stream);
}

extern "C" int eigh3_f64(const void* a00, const void* a01, const void* a02,
                         const void* a11, const void* a12, const void* a22,
                         long long s00, long long s01, long long s02,
                         long long s11, long long s12, long long s22,
                         void* out, long long n, int sweeps, void* stream) {
  return launch<double>(a00, a01, a02, a11, a12, a22, s00, s01, s02, s11,
                        s12, s22, out, n, sweeps, stream);
}
