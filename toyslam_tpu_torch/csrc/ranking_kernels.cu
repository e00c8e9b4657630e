// The bf16-split ranking product for Hopper (sm_90a): D1 of the port.
//
// Replaces the Pallas TPU kernel of benchmarks/diag_bf16_concat.py:
//   split_dot  <- run_variant / _variant_kernel(mode)  (diag_bf16_concat.py:78/37)
//
// Computes st = s . t_t, [N, M] f32, from s [N, 3] and t_t [3, M] f32, in
// one of five ways. hi = bf16(x) and lo = bf16(x - f32(hi)), formed in
// registers from the f32 inputs (diag_bf16_concat.py:44-47):
//   highest  f32 on the CUDA cores, each product and sum rounded on its own
//            (__fmul_rn / __fadd_rn) in the order of the plain version
//            (ops/ranking_kernels.py), so the two agree bit for bit;
//   bf16     s_hi . t_hi, one tensor-core product of depth 3;
//   3pass    s_hi . t_hi, s_hi . t_lo, s_lo . t_hi: three tensor-core
//            products, each from a zero accumulator, then two f32 adds in
//            JAX's order ((p1 + p2) + p3). Chaining them through the
//            accumulator would be another sum;
//   concat6  [s_hi | s_lo] . [t_hi ; t_hi], one product of depth 6 (drops
//            every t_lo term, as the TPU variant does);
//   concat9  [s_hi | s_hi | s_lo] . [t_hi ; t_lo ; t_hi], one product of
//            depth 9.
// The tensor-core modes use mma.sync.aligned.m16n8k16.row.col.f32.bf16.
// bf16.f32 with the depth zero-padded to 16: how the tensor core sums the
// exact bf16 x bf16 products in f32 is what the diagnostic measures.
//
// What bounds it: writing the [N, M] f32 result (1 GiB at 16384 x 16384,
// 0.32 ms at 3.35 TB/s); it reads O(N + M) floats and the products are a
// few percent of the tensor cores' rate. So the design serves the stores.
//
// Tensor-core modes: a warp owns 64 columns and holds their t operand as
// eight m16n8 B fragments in registers for its whole row range. The
// column that each B fragment's n-index stands for is permuted so that
// thread (g, t) of the warp finds its accumulators of n-tiles 2q and 2q+1
// at four adjacent output columns 16q + 4t .. 16q + 4t + 3: one float4
// store each, a warp writing 64 contiguous bytes on each of 8 rows per
// instruction. A block is 4 warps (256 columns) over 256 rows, walked one
// m16 tile at a time; the A fragment is rebuilt per tile from 2 rows of s.
//
// highest: a thread owns 4 adjacent columns (held in registers) and walks
// 64 rows, one float4 store a row; a warp writes 512 contiguous bytes.
//
// Ragged tiles are cut by count: rows past N read zeros and store nothing,
// columns past M likewise; when M % 4 != 0 the rows are not 16-byte
// aligned and the stores go one float at a time. Any N and M work.
//
// Every entry point returns cudaGetLastError() so that the Python wrapper
// can raise on a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode { kHighest = 0, kBf16 = 1, k3Pass = 2, kConcat6 = 3, kConcat9 = 4 };

struct Split3 {  // hi and lo parts of (x, y, z), each an exact bf16 value
  float hi[3], lo[3];
};

__device__ __forceinline__ Split3 split3(float x, float y, float z) {
  Split3 p;
  const float v[3] = {x, y, z};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat16 h = __float2bfloat16_rn(v[i]);
    p.hi[i] = __bfloat162float(h);
    p.lo[i] = __bfloat162float(
        __float2bfloat16_rn(__fsub_rn(v[i], p.hi[i])));
  }
  return p;
}

// The operand's entry at depth K: groups of 3 (x, y, z) that each take the
// hi or the lo part (bit g of LO_MASK set: group g takes lo); depth past
// 3 * GROUPS is zero padding. K is a compile-time constant, so the entry is
// a register or zero.
template <int GROUPS, int LO_MASK, int K>
__device__ __forceinline__ float depth_entry(const Split3& p) {
  if constexpr (K >= 3 * GROUPS) {
    return 0.0f;
  } else {
    return ((LO_MASK >> (K / 3)) & 1) ? p.lo[K % 3] : p.hi[K % 3];
  }
}

// Thread t of a quad holds depths 2t + E (+ 8 when HIGH) of a fragment
// row or column (PTX ISA, mma.m16n8k16 fragment layout for .bf16): the
// entry of depth 2t + E + 8 HIGH, picked by selects from the four
// compile-time candidates.
template <int GROUPS, int LO_MASK, int E, int HIGH>
__device__ __forceinline__ float quad_entry(int t, const Split3& p) {
  constexpr int k = 8 * HIGH + E;
  const float v0 = depth_entry<GROUPS, LO_MASK, k>(p);
  const float v1 = depth_entry<GROUPS, LO_MASK, k + 2>(p);
  const float v2 = depth_entry<GROUPS, LO_MASK, k + 4>(p);
  const float v3 = depth_entry<GROUPS, LO_MASK, k + 6>(p);
  return t == 0 ? v0 : (t == 1 ? v1 : (t == 2 ? v2 : v3));
}

__device__ __forceinline__ uint32_t pack2(float lo_k, float hi_k) {
  // The lower depth index goes in the lower half. Exact: both are bf16.
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_k, hi_k);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int GROUPS, int LO_MASK, int HIGH>
__device__ __forceinline__ uint32_t quad_pair(int t, const Split3& p) {
  return pack2(quad_entry<GROUPS, LO_MASK, 0, HIGH>(t, p),
               quad_entry<GROUPS, LO_MASK, 1, HIGH>(t, p));
}

// Thread (g, t) of a warp holds A rows g and g + 8 at depths 2t, 2t+1,
// 2t+8, 2t+9.
template <int GROUPS, int LO_MASK>
__device__ __forceinline__ void a_fragment(uint32_t a[4], int t,
                                           const Split3& r0,
                                           const Split3& r1) {
  a[0] = quad_pair<GROUPS, LO_MASK, 0>(t, r0);
  a[1] = quad_pair<GROUPS, LO_MASK, 0>(t, r1);
  a[2] = quad_pair<GROUPS, LO_MASK, 1>(t, r0);
  a[3] = quad_pair<GROUPS, LO_MASK, 1>(t, r1);
}

// Thread (g, t) holds B column g at depths 2t, 2t+1 and 2t+8, 2t+9.
template <int GROUPS, int LO_MASK>
__device__ __forceinline__ void b_fragment(uint32_t b[2], int t,
                                           const Split3& c) {
  b[0] = quad_pair<GROUPS, LO_MASK, 0>(t, c);
  b[1] = quad_pair<GROUPS, LO_MASK, 1>(t, c);
}

__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.0f), "f"(0.0f), "f"(0.0f), "f"(0.0f));
}

// 3pass: three products, each from a zero accumulator, added in JAX's
// order (diag_bf16_concat.py:54-56).
__device__ __forceinline__ void mma_3pass(float d[4], const uint32_t ah[4],
                                          const uint32_t al[4],
                                          const uint32_t bh[2],
                                          const uint32_t bl[2]) {
  float p2[4], p3[4];
  mma_bf16(d, ah, bh);   // s_hi . t_hi
  mma_bf16(p2, ah, bl);  // s_hi . t_lo
  mma_bf16(p3, al, bh);  // s_lo . t_hi
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = __fadd_rn(__fadd_rn(d[i], p2[i]), p3[i]);
}

// Operand layouts of the one-product modes: (groups, lo mask) of A and B.
template <int MODE> struct Layout;
template <> struct Layout<kBf16> {
  static constexpr int kGroups = 1, kALo = 0b000, kBLo = 0b000;
};
template <> struct Layout<kConcat6> {
  static constexpr int kGroups = 2, kALo = 0b010, kBLo = 0b000;
};
template <> struct Layout<kConcat9> {
  static constexpr int kGroups = 3, kALo = 0b100, kBLo = 0b010;
};

constexpr int kWarps = 4;
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kWarpCols = 64;                       // 8 n-tiles of 8
constexpr int kNTiles = kWarpCols / 8;
constexpr int kMmaCols = kWarps * kWarpCols;        // columns per block
constexpr int kMmaRows = 256;                       // rows per block

__device__ __forceinline__ void store4(float* __restrict__ out, int row,
                                       int col, int n, int m, bool vec,
                                       float v0, float v1, float v2,
                                       float v3) {
  if (row >= n || col >= m) return;
  float* o = out + static_cast<size_t>(row) * m + col;
  if (vec && col + 3 < m) {
    *reinterpret_cast<float4*>(o) = make_float4(v0, v1, v2, v3);
  } else {
    o[0] = v0;
    if (col + 1 < m) o[1] = v1;
    if (col + 2 < m) o[2] = v2;
    if (col + 3 < m) o[3] = v3;
  }
}

template <int MODE>
__global__ void __launch_bounds__(kMmaThreads)
split_mma_kernel(const float* __restrict__ src, const float* __restrict__ tt,
                 float* __restrict__ out, int n, int m, long long col_blocks) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane >> 2, t = lane & 3;
  const long long rb = blockIdx.x / col_blocks, cb = blockIdx.x % col_blocks;
  const int col0 = static_cast<int>(cb) * kMmaCols + warp * kWarpCols;
  const int row0 = static_cast<int>(rb) * kMmaRows;
  const bool vec = m % 4 == 0;
  const size_t mm = static_cast<size_t>(m);

  // B fragments: n-index g of n-tile j stands for output column
  // col0 + 16 (j / 2) + 4 (g / 2) + 2 (j % 2) + g % 2.
  uint32_t bh[kNTiles][2], bl[kNTiles][2];
#pragma unroll
  for (int j = 0; j < kNTiles; ++j) {
    const int c = col0 + 16 * (j >> 1) + 4 * (g >> 1) + 2 * (j & 1) + (g & 1);
    const bool ok = c < m;
    const Split3 p = split3(ok ? tt[c] : 0.0f, ok ? tt[mm + c] : 0.0f,
                            ok ? tt[2 * mm + c] : 0.0f);
    if constexpr (MODE == k3Pass) {
      b_fragment<1, 0>(bh[j], t, p);
      b_fragment<1, 1>(bl[j], t, p);
    } else {
      b_fragment<Layout<MODE>::kGroups, Layout<MODE>::kBLo>(bh[j], t, p);
    }
  }

  for (int r = row0; r < min(row0 + kMmaRows, n); r += 16) {
    const int ra = r + g, rc = r + g + 8;
    const Split3 sa = split3(ra < n ? src[3 * static_cast<size_t>(ra)] : 0.0f,
                             ra < n ? src[3 * static_cast<size_t>(ra) + 1] : 0.0f,
                             ra < n ? src[3 * static_cast<size_t>(ra) + 2] : 0.0f);
    const Split3 sc = split3(rc < n ? src[3 * static_cast<size_t>(rc)] : 0.0f,
                             rc < n ? src[3 * static_cast<size_t>(rc) + 1] : 0.0f,
                             rc < n ? src[3 * static_cast<size_t>(rc) + 2] : 0.0f);
    uint32_t ah[4], al[4];
    if constexpr (MODE == k3Pass) {
      a_fragment<1, 0>(ah, t, sa, sc);
      a_fragment<1, 1>(al, t, sa, sc);
    } else {
      a_fragment<Layout<MODE>::kGroups, Layout<MODE>::kALo>(ah, t, sa, sc);
    }
#pragma unroll
    for (int q = 0; q < kNTiles / 2; ++q) {
      float d0[4], d1[4];
      if constexpr (MODE == k3Pass) {
        mma_3pass(d0, ah, al, bh[2 * q], bl[2 * q]);
        mma_3pass(d1, ah, al, bh[2 * q + 1], bl[2 * q + 1]);
      } else {
        mma_bf16(d0, ah, bh[2 * q]);
        mma_bf16(d1, ah, bh[2 * q + 1]);
      }
      const int c = col0 + 16 * q + 4 * t;
      store4(out, ra, c, n, m, vec, d0[0], d0[1], d1[0], d1[1]);
      store4(out, rc, c, n, m, vec, d0[2], d0[3], d1[2], d1[3]);
    }
  }
}

constexpr int kHThreads = 256;
constexpr int kHCols = 4 * kHThreads;  // columns per block
constexpr int kHRows = 64;             // rows per block

__global__ void __launch_bounds__(kHThreads)
highest_kernel(const float* __restrict__ src, const float* __restrict__ tt,
               float* __restrict__ out, int n, int m, long long col_blocks) {
  const long long rb = blockIdx.x / col_blocks, cb = blockIdx.x % col_blocks;
  const int c = static_cast<int>(cb) * kHCols + 4 * threadIdx.x;
  if (c >= m) return;
  const size_t mm = static_cast<size_t>(m);
  float tx[4], ty[4], tz[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const bool ok = c + e < m;
    tx[e] = ok ? tt[c + e] : 0.0f;
    ty[e] = ok ? tt[mm + c + e] : 0.0f;
    tz[e] = ok ? tt[2 * mm + c + e] : 0.0f;
  }
  const bool vec = m % 4 == 0;
  const int row0 = static_cast<int>(rb) * kHRows;
  for (int r = row0; r < min(row0 + kHRows, n); ++r) {
    const float sx = src[3 * static_cast<size_t>(r)];
    const float sy = src[3 * static_cast<size_t>(r) + 1];
    const float sz = src[3 * static_cast<size_t>(r) + 2];
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = __fadd_rn(__fadd_rn(__fmul_rn(sx, tx[e]), __fmul_rn(sy, ty[e])),
                       __fmul_rn(sz, tz[e]));
    }
    store4(out, r, c, n, m, vec, v[0], v[1], v[2], v[3]);
  }
}

template <int MODE>
void launch_mma(const float* src, const float* tt, float* out, int n, int m,
                cudaStream_t stream) {
  const long long col_blocks = (m + kMmaCols - 1) / kMmaCols;
  const long long row_blocks = (n + kMmaRows - 1) / kMmaRows;
  split_mma_kernel<MODE><<<static_cast<unsigned>(row_blocks * col_blocks),
                           kMmaThreads, 0, stream>>>(src, tt, out, n, m,
                                                     col_blocks);
}

}  // namespace

// mode: 0 highest, 1 bf16, 2 3pass, 3 concat6, 4 concat9 (MODES in
// ops/ranking_kernels.py). Returns cudaErrorInvalidValue for another mode.
extern "C" int split_dot(const void* src, const void* tt, void* out,
                         long long n, long long m, int mode, void* stream) {
  const float* s = static_cast<const float*>(src);
  const float* t = static_cast<const float*>(tt);
  float* o = static_cast<float*>(out);
  const int ni = static_cast<int>(n), mi = static_cast<int>(m);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kHighest: {
      const long long col_blocks = (m + kHCols - 1) / kHCols;
      const long long row_blocks = (n + kHRows - 1) / kHRows;
      highest_kernel<<<static_cast<unsigned>(row_blocks * col_blocks),
                       kHThreads, 0, st>>>(s, t, o, ni, mi, col_blocks);
      break;
    }
    case kBf16: launch_mma<kBf16>(s, t, o, ni, mi, st); break;
    case k3Pass: launch_mma<k3Pass>(s, t, o, ni, mi, st); break;
    case kConcat6: launch_mma<kConcat6>(s, t, o, ni, mi, st); break;
    case kConcat9: launch_mma<kConcat9>(s, t, o, ni, mi, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
