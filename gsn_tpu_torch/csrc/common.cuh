// Shared pieces of the port's hand-written Hopper kernels.
//
// Every kernel here is a row walk: one warp owns one output row (a node,
// a graph or a segment) and its 32 lanes stride across the feature
// width, V floats per lane (float4 when the width and the pointers
// allow it, so a warp moves 512 contiguous bytes per access).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace gsn {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;

template <int V>
struct Frag {
  float v[V];

  __device__ __forceinline__ static Frag zero() {
    Frag f;
#pragma unroll
    for (int i = 0; i < V; ++i) f.v[i] = 0.f;
    return f;
  }

  __device__ __forceinline__ static Frag load(const float* __restrict__ p) {
    Frag f;
    if constexpr (V == 4) {
      const float4 t = *reinterpret_cast<const float4*>(p);
      f.v[0] = t.x; f.v[1] = t.y; f.v[2] = t.z; f.v[3] = t.w;
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) f.v[i] = p[i];
    }
    return f;
  }

  __device__ __forceinline__ void store(float* __restrict__ p) const {
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) p[i] = v[i];
    }
  }
};

// float4 access needs a width divisible by 4 and 16-byte aligned rows.
inline int vec_width(int d, const void* const* ptrs, int n) {
  if (d % 4 != 0) return 1;
  for (int i = 0; i < n; ++i)
    if (ptrs[i] != nullptr && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0)
      return 1;
  return 4;
}

inline int row_blocks(int n_rows) {
  return (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
}

}  // namespace gsn

// Run a body with a runtime bool (or float4/scalar choice) bound to a
// compile-time constant of the given name.
#define GSN_BOOL_SWITCH(COND, NAME, ...)   \
  [&] {                                    \
    if (COND) {                            \
      constexpr bool NAME = true;          \
      return __VA_ARGS__();                \
    } else {                               \
      constexpr bool NAME = false;         \
      return __VA_ARGS__();                \
    }                                      \
  }()

#define GSN_VEC_SWITCH(VEC, NAME, ...)     \
  [&] {                                    \
    if ((VEC) == 4) {                      \
      constexpr int NAME = 4;              \
      return __VA_ARGS__();                \
    } else {                               \
      constexpr int NAME = 1;              \
      return __VA_ARGS__();                \
    }                                      \
  }()
