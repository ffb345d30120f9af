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
