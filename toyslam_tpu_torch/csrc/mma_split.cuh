// bf16 split operands of mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32,
// shared by the tensor-core kernels (csrc/ranking_kernels.cu D1,
// csrc/nn_kernels.cu K4).
//
// An f32 value x is split into hi = bf16(x) and lo = bf16(x - f32(hi));
// both are exact bf16 values, so the tensor core forms their products
// exactly. An operand row (A) or column (B) of depth 16 is built from
// GROUPS groups of 3 entries (x, y, z), each group taking the hi or the lo
// parts (bit g of LO_MASK set: group g takes lo), then EXT groups (0 or 1)
// of three free entries (Split3::ext), then zero padding.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

struct Split3 {  // hi and lo parts of (x, y, z); ext: a free fourth group
  float hi[3], lo[3], ext[3];
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
    p.ext[i] = 0.0f;
  }
  return p;
}

// The operand's entry at depth K. K is a compile-time constant, so the
// entry is a register or zero.
template <int GROUPS, int LO_MASK, int K, int EXT = 0>
__device__ __forceinline__ float depth_entry(const Split3& p) {
  if constexpr (K < 3 * GROUPS) {
    return ((LO_MASK >> (K / 3)) & 1) ? p.lo[K % 3] : p.hi[K % 3];
  } else if constexpr (K < 3 * (GROUPS + EXT)) {
    return p.ext[K - 3 * GROUPS];
  } else {
    return 0.0f;
  }
}

// Thread t of a quad holds depths 2t + E (+ 8 when HIGH) of a fragment
// row or column (PTX ISA, mma.m16n8k16 fragment layout for .bf16): the
// entry of depth 2t + E + 8 HIGH, picked by selects from the four
// compile-time candidates.
template <int GROUPS, int LO_MASK, int E, int HIGH, int EXT = 0>
__device__ __forceinline__ float quad_entry(int t, const Split3& p) {
  constexpr int k = 8 * HIGH + E;
  const float v0 = depth_entry<GROUPS, LO_MASK, k, EXT>(p);
  const float v1 = depth_entry<GROUPS, LO_MASK, k + 2, EXT>(p);
  const float v2 = depth_entry<GROUPS, LO_MASK, k + 4, EXT>(p);
  const float v3 = depth_entry<GROUPS, LO_MASK, k + 6, EXT>(p);
  return t == 0 ? v0 : (t == 1 ? v1 : (t == 2 ? v2 : v3));
}

__device__ __forceinline__ uint32_t pack2(float lo_k, float hi_k) {
  // The lower depth index goes in the lower half. Exact: both are bf16.
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_k, hi_k);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int GROUPS, int LO_MASK, int HIGH, int EXT = 0>
__device__ __forceinline__ uint32_t quad_pair(int t, const Split3& p) {
  return pack2(quad_entry<GROUPS, LO_MASK, 0, HIGH, EXT>(t, p),
               quad_entry<GROUPS, LO_MASK, 1, HIGH, EXT>(t, p));
}

// Thread (g, t) of a warp holds A rows g and g + 8 at depths 2t, 2t+1,
// 2t+8, 2t+9.
template <int GROUPS, int LO_MASK, int EXT = 0>
__device__ __forceinline__ void a_fragment(uint32_t a[4], int t,
                                           const Split3& r0,
                                           const Split3& r1) {
  a[0] = quad_pair<GROUPS, LO_MASK, 0, EXT>(t, r0);
  a[1] = quad_pair<GROUPS, LO_MASK, 0, EXT>(t, r1);
  a[2] = quad_pair<GROUPS, LO_MASK, 1, EXT>(t, r0);
  a[3] = quad_pair<GROUPS, LO_MASK, 1, EXT>(t, r1);
}

// Thread (g, t) holds B column g at depths 2t, 2t+1 and 2t+8, 2t+9.
template <int GROUPS, int LO_MASK, int EXT = 0>
__device__ __forceinline__ void b_fragment(uint32_t b[2], int t,
                                           const Split3& c) {
  b[0] = quad_pair<GROUPS, LO_MASK, 0, EXT>(t, c);
  b[1] = quad_pair<GROUPS, LO_MASK, 1, EXT>(t, c);
}

// d = a . b from a zero accumulator.
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
