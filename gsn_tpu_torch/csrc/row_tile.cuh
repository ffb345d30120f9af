// The register tile of K1 and K2 (edge_message_fwd, edge_message_bwd_recv)
// and K3 (segment_sum_sorted): a group of LANES lanes (a warp, or a half
// warp) walks each of its rows once, and a lane holds its columns of the
// whole walk in registers.
//
// A lane owns NG groups of V columns of a column tile: group g covers
// the V columns from (lane + LANES g) V, so one access of a group moves
// LANES * V contiguous elements of a row.  V is the widest access that d
// and every operand's alignment allow: 16 bytes (a float4, 8 bf16), 8
// bytes for bf16, and 2 elements (a float2, a bf16x2) where those do
// not fit: a d=150 row is 600 bytes of f32 (8-byte aligned) or 300 of
// bf16 (4-byte aligned).  NG is 1 when one access covers d, else kTileNG,
// so the paths' widths (128, 150, 300) take one tile; a width beyond the
// tile takes several, each of which walks the rows again: K3 loops over
// them, K1 and K2 give each its own blocks (the grid's y extent).  The
// sums keep each element's row order, so a tile gives the same bits as
// a walk over one column at a time.  Loads go through Words, raw 32-bit
// words converted to f32 only after a window's loads have all issued.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace gsn {

constexpr int kTileNG = 3;        // column groups a lane owns when d needs
                                  // more than one access of the group's lanes
constexpr int kTileInFlight = 4;  // rows K3 loads before any is added
constexpr unsigned kAllLanes = 0xffffffffu;

template <int N>
using TileC = std::integral_constant<int, N>;

// The lanes of the calling thread's group of LANES lanes.
template <int LANES>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (LANES == kWarp) {
    return kAllLanes;
  } else {
    static_assert(LANES == 16, "a group is a warp or a half warp");
    return 0xffffu << (threadIdx.x & 16);
  }
}

// The raw 32-bit words of V elements of T: what one access loads.  A
// load is kept apart from the words' conversion to f32, so that loads
// guarded by a condition (a row of the window, a column of the tile)
// issue back to back: a conversion inside the same branch would wait
// for its load before the next load issues.
template <typename T, int V>
struct Words {
  static constexpr int kBytes = V * static_cast<int>(sizeof(T));
  static constexpr int N = kBytes < 4 ? 1 : kBytes / 4;
  uint32_t w[N];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < N; ++i) w[i] = 0u;
  }

  // one access at p (aligned to min(kBytes, 16))
  __device__ __forceinline__ void load(const T* __restrict__ p) {
    if constexpr (kBytes >= 16) {
#pragma unroll
      for (int k = 0; k < kBytes / 16; ++k) {
        const uint4 t = reinterpret_cast<const uint4*>(p)[k];
        w[4 * k] = t.x; w[4 * k + 1] = t.y;
        w[4 * k + 2] = t.z; w[4 * k + 3] = t.w;
      }
    } else if constexpr (kBytes == 8) {
      const uint2 t = *reinterpret_cast<const uint2*>(p);
      w[0] = t.x; w[1] = t.y;
    } else if constexpr (kBytes == 4) {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      static_assert(kBytes == 2, "one bf16");
      w[0] = *reinterpret_cast<const unsigned short*>(p);
    }
  }

  // the V values as f32 (a bf16 is the high half of the f32 of the same
  // value; a word holds two, the first in its low half)
  __device__ __forceinline__ void unpack(float* x) const {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if constexpr (sizeof(T) == 4) {
        x[i] = __uint_as_float(w[i]);
      } else {
        const uint32_t h = i % 2 ? w[i / 2] & 0xffff0000u : w[i / 2] << 16;
        x[i] = __uint_as_float(h);
      }
    }
  }
};

// The lane's words of one row of a column tile: group g covers the V
// columns from (lane + LANES g) V; columns at or past tc (a multiple of
// V) read as 0.  Only loads: see Words.
template <int V, int NG, int LANES, typename T>
__device__ __forceinline__ void tile_load_words(const T* __restrict__ p,
                                                int tc, int lane,
                                                Words<T, V> (&r)[NG]) {
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const int c = (lane + LANES * g) * V;
    r[g].zero();
    if (c < tc) r[g].load(p + c);
  }
}

template <int V, int NG, typename T>
__device__ __forceinline__ void tile_unpack(const Words<T, V> (&r)[NG],
                                            float (&x)[NG * V]) {
#pragma unroll
  for (int g = 0; g < NG; ++g) r[g].unpack(x + g * V);
}

// The lane's columns of one row of a column tile, as f32.
template <int V, int NG, int LANES, typename T>
__device__ __forceinline__ void tile_load(const T* __restrict__ p, int tc,
                                          int lane, float (&x)[NG * V]) {
  Words<T, V> r[NG];
  tile_load_words<V, NG, LANES>(p, tc, lane, r);
  tile_unpack(r, x);
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo)))
         | (static_cast<uint32_t>(
                __bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// Store V f32 values at p, rounded to the element type, by one vector
// store (bf16: round to nearest even, two to a 32-bit word).
template <int V>
__device__ __forceinline__ void vec_store(float* __restrict__ p,
                                          const float* x) {
  if constexpr (V == 8) {
    vec_store<4>(p, x);
    vec_store<4>(p + 4, x + 4);
  } else if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    static_assert(V == 1, "f32 accesses are of 8, 4, 2 or 1 elements");
    *p = x[0];
  }
}

template <int V>
__device__ __forceinline__ void vec_store(bf16* __restrict__ p,
                                          const float* x) {
  if constexpr (V == 8) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(bf16_pair(x[0], x[1]), bf16_pair(x[2], x[3]),
                   bf16_pair(x[4], x[5]), bf16_pair(x[6], x[7]));
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(bf16_pair(x[0], x[1]), bf16_pair(x[2], x[3]));
  } else if constexpr (V == 2) {
    *reinterpret_cast<uint32_t*>(p) = bf16_pair(x[0], x[1]);
  } else {
    static_assert(V == 1, "bf16 accesses are of 8, 4, 2 or 1 elements");
    *p = __float2bfloat16_rn(x[0]);
  }
}

// Store the lane's columns (those before tc) of one row, rounded to T.
template <int V, int NG, int LANES, typename T>
__device__ __forceinline__ void tile_store(T* __restrict__ p, int tc,
                                           int lane,
                                           const float (&x)[NG * V]) {
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const int c = (lane + LANES * g) * V;
    if (c < tc) vec_store<V>(p + c, x + g * V);
  }
}

template <int P>
__device__ __forceinline__ void tile_zero(float (&x)[P]) {
#pragma unroll
  for (int i = 0; i < P; ++i) x[i] = 0.f;
}

// Elements a lane moves per access over rows of d elements of T: 16 bytes
// of T, else (bf16) 8 bytes, else 2 elements, else 1; the widest that
// divides d and that every operand allows (an operand is (address, its
// element bytes): V of its elements need an address aligned to min(V *
// bytes, 16)).  It is vec_width (common.cuh) with a 2-element step
// added; the other kernels keep vec_width's answer.
template <typename T>
inline int tile_vec_width(
    int d, std::initializer_list<std::pair<const void*, int>> ops) {
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
  if (fits(2)) return 2;
  return 1;
}

// Run f with the tile layout <V, NG, LANES> (std::integral_constant each)
// for rows of d elements of T at the vector width tile_vec_width chose.
// With HALF_OK false the group is always a warp (K3's block form).  A
// bf16 row of at most 128 elements at 8 a lane is one access of a half
// warp; else a warp, with NG = 1 when one access covers d and kTileNG
// otherwise (V = 8 stays at NG = 1: its lanes already hold 8 each).
template <typename T, bool HALF_OK = true, typename F>
inline void tile_switch(int vec, int d, F&& f) {
  auto groups = [&](auto v, auto lanes) {
    constexpr int V = decltype(v)::value, L = decltype(lanes)::value;
    if (d <= L * V) return f(v, TileC<1>{}, lanes);
    return f(v, TileC<kTileNG>{}, lanes);
  };
  if constexpr (sizeof(T) == 2) {
    if (vec == 8) {
      if (HALF_OK && d <= 16 * 8)
        return f(TileC<8>{}, TileC<1>{}, TileC<16>{});
      return f(TileC<8>{}, TileC<1>{}, TileC<kWarp>{});
    }
  }
  if (vec == 4) return groups(TileC<4>{}, TileC<kWarp>{});
  if (vec == 2) return groups(TileC<2>{}, TileC<kWarp>{});
  return groups(TileC<1>{}, TileC<kWarp>{});
}

}  // namespace gsn
