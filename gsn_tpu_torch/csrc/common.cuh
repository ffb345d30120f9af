// Shared pieces of the port's hand-written Hopper kernels.
//
// Every kernel here is a row walk: one warp owns one output row (a node,
// a graph or a segment) and its 32 lanes stride across the feature
// width, V elements per lane in one access of up to 16 bytes (a float4
// of f32, or 8 bf16, when the width and the pointers allow it, so a warp
// moves 512 contiguous bytes per access).  A bf16 row of at most 128
// elements is one access of 16 lanes: there a half warp owns a row, and
// a warp walks two rows at once.  Data of either element type is
// converted to f32 in registers: every sum accumulates in f32, and a
// bf16 store rounds to nearest even once.
#pragma once

#include <cstdint>
#include <initializer_list>
#include <type_traits>
#include <utility>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gsn {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x) {
  if constexpr (std::is_same_v<T, bf16>) {
    return __float2bfloat16_rn(x);
  } else {
    return x;
  }
}

// x as a T would hold it (round to nearest even for bf16), back in f32
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// V elements of T moved by one access (aligned to its size, at most 16
// bytes: wider packs take several 16-byte accesses)
template <typename T, int V>
struct alignas(sizeof(T) * V < 16 ? sizeof(T) * V : 16) Pack {
  T v[V];
};

template <int V>
struct Frag {
  float v[V];

  __device__ __forceinline__ static Frag zero() {
    Frag f;
#pragma unroll
    for (int i = 0; i < V; ++i) f.v[i] = 0.f;
    return f;
  }

  template <typename T>
  __device__ __forceinline__ static Frag load(const T* __restrict__ p) {
    const Pack<T, V> raw = *reinterpret_cast<const Pack<T, V>*>(p);
    Frag f;
#pragma unroll
    for (int i = 0; i < V; ++i) f.v[i] = to_f32(raw.v[i]);
    return f;
  }

  template <typename T>
  __device__ __forceinline__ void store(T* __restrict__ p) const {
    Pack<T, V> raw;
#pragma unroll
    for (int i = 0; i < V; ++i) raw.v[i] = from_f32<T>(v[i]);
    *reinterpret_cast<Pack<T, V>*>(p) = raw;
  }
};

// Elements a lane moves per access over rows of d elements of T: 16
// bytes of T (a float4 of f32), else (bf16 only) 8 bytes, else one
// element, the widest that divides d and that every operand allows.
// An operand is (address, its element bytes): V of its elements need an
// address aligned to min(V * bytes, 16).  A d=300 bf16 row is 600 bytes,
// so only 8-byte aligned: 4 elements a lane.
template <typename T>
inline int vec_width(int d,
                     std::initializer_list<std::pair<const void*, int>> ops) {
  auto fits = [&](int V) {
    if (d % V != 0) return false;
    for (const auto& op : ops) {
      const int align = V * op.second < 16 ? V * op.second : 16;
      if (op.first != nullptr
          && reinterpret_cast<uintptr_t>(op.first) % align != 0)
        return false;
    }
    return true;
  };
  constexpr int wide = 16 / static_cast<int>(sizeof(T));
  if (fits(wide)) return wide;
  if (sizeof(T) == 2 && fits(4)) return 4;
  return 1;
}

// Run f with the vector width vec_width<T> chose, as a compile-time
// constant (std::integral_constant): 4 or 1 for f32, 8, 4 or 1 for bf16.
template <typename T, typename F>
inline void vec_switch(int vec, F&& f) {
  if constexpr (sizeof(T) == 2) {
    if (vec == 8) return f(std::integral_constant<int, 8>());
  }
  if (vec == 4) return f(std::integral_constant<int, 4>());
  return f(std::integral_constant<int, 1>());
}

// Run f with the lanes that own a row (std::integral_constant): 16 when
// V = 8 elements a lane cover the row in one pass of 16 lanes, else 32.
template <int V, typename F>
inline void lanes_switch(int d, F&& f) {
  if constexpr (V == 8) {
    if (d <= 16 * V) return f(std::integral_constant<int, 16>());
  }
  return f(std::integral_constant<int, kWarp>());
}

// Blocks of kThreads threads for n_rows rows of `lanes` lanes each.
inline int row_blocks(int n_rows, int lanes = kWarp) {
  const int rows = kThreads / lanes;
  return (n_rows + rows - 1) / rows;
}

}  // namespace gsn

// Run a body with a runtime bool bound to a compile-time constant of the
// given name.
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
