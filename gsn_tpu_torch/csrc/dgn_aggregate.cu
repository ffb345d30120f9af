// K5 dgn_aggregate_fwd and K6 dgn_aggregate_bwd: the DGN aggregators'
// receiver walk, in three instantiations.
//
// Replaces, by the template flags <WEIGHTED, MINMAX>:
// - <true, false>: gsn_tpu/ops/pallas/slab_weighted.py:
//   slab_weighted_gather (forward _fwd_kernel, backward _bwd_kernel);
// - <false, true>: gsn_tpu/ops/pallas/slab_minmax.py: slab_segment_minmax
//   (forward _fwd_kernel, backward _bwd_kernel) together with its chunk
//   combine gsn_tpu/ops/pallas/slab_combine.py: slab_combine_minmax_cnt;
// - <true, true>: gsn_tpu/ops/pallas/slab_weighted.py: slab_dgn_fused
//   (_dgn_fwd_kernel, _dgn_bwd_kernel), the DGN main path.
// The TPU kernels resolved gathers and scatters as one-hot matrix
// products over per-chunk slabs, ran a segmented tree scan for the max,
// and combined the chunks' maxima and tie counts in a second pass.  Here
// one warp owns one receiver row v and walks its edges
// [recv_ptr[v], recv_ptr[v+1]) in the batch's receiver-sorted order, so
// the row's global max and its tie count are known when the walk ends:
// there are no slabs and no combine pass.
//
//   forward   out[v, k*d + c] = sum_e W[e, k] * B[send[e], c]   (k < K)
//             mm[v, c]        = max_e  B[send[e], c]
//             mm[v, d + c]    = max_e -B[send[e], c]            (= -min)
//             cnt[v, .]       = number of edges attaining mm[v, .]
//             (rows with no edges: out = mm = cnt = 0)
//   backward  dh[e, c] = sum_k W[e, k] * g_w[v, k*d + c]
//                      + [B == mm_max] g_mm[v, c] / max(cnt, 1)
//                      - [-B == mm_negmin] g_mm[v, d + c] / max(cnt, 1)
//             dW[e, k] = <B[send[e]], g_w[v, k*d : (k+1)*d]>   (optional)
// for every edge e of receiver v.  The max's cotangent is split evenly
// over tied edges, as jax.ops.segment_max's is.  The sender-side sum of
// dh (dB) is K3 over the sender-sorted permutation: no float atomics.
//
// Bound: bytes.  Per element the forward does K multiply-adds and two
// compare-selects, far below the card's f32 rate; what it must move is
// B's rows (once per sender with edges), W, and the outputs (K*d + 4d
// floats a node row, most of the forward's bytes).  The backward reads
// B, W and the node-level cotangents and writes dh (one row per edge).
// A receiver row has few edges (2.3 on average on the DGN batch), so the
// work per row is short and mostly latency: the design keeps many bytes
// in flight and few instructions per row.
//
// - One walk per row, and kRows consecutive rows per warp.  A lane owns
//   NG column groups of V values for the whole walk: one float4 group
//   when the width is a multiple of 4 and the rows are aligned, else
//   three single columns (d=70 needs all three).  A width beyond the
//   32*NG*V columns of that register tile (128 or 96) loops over column
//   tiles, each of which walks the edges again.  The warp's rows own one
//   contiguous edge range, so one recv_ptr load and one index chunk
//   serve all of them.
// - Each edge's index and weights load once.  Lane i loads send[c+i] and
//   W[c+i, :] for a chunk of 32 edges of the warp's range, and
//   __shfl_sync hands them to the other lanes.  The sender rows of
//   kInFlight edges are gathered before any is consumed.  The sums still
//   run in edge order, column by column, so they give the same bits as a
//   walk that takes one edge at a time.
// - Outputs leave straight from registers, each store instruction a
//   contiguous 128-byte strip of a row (512 bytes with float4 groups).
//   Staging rows in shared memory for wider stores was measured slower
//   at d=70 in every instantiation: the copy's instructions cost more
//   than the wider stores saved.
// - K6 loads the receiver's node-level operands (g_w, mm, cnt, g_mm) once
//   per row and column tile and precomputes g_mm / max(cnt, 1) once,
//   then walks the edges, writing one dh row each.  dW stays a per-edge
//   warp sum.
// - The number of weight columns is a template parameter for the value
//   the DGN paths launch (kPathK) and generic up to kMaxK otherwise.
//
// Element types.  The row type T of B, the weighted cotangent g_w and
// dh is f32, or bf16 in the reference's data_dtype="bfloat16"
// (slab_weighted.py:89-94, 117-128, 300-303, 327-344; slab_minmax.py:
// 71-76).  W, out, mm, cnt, g_mm and dW are f32 in both: sums, maxima
// and counts are f32 throughout.  In bf16 each W[e, k] is rounded to bf16
// inside the forward's weighted product (and not in the backward's dh),
// the maxima compare bf16 values exactly (mm holds them in f32), dW is an
// f32 sum of the bf16 values, and dh is summed in f32 from f32 W, the
// bf16 g_w and g_mm / max(cnt, 1) in f32, then rounded once.  bf16
// rows take f32's layout of three single columns a lane at every width
// (a d=70 bf16 row is 140 bytes, only 4-byte aligned).  A layout of two
// pairs a lane (4-byte loads) was measured slower in five of the six
// functions at d=70: its extra registers spilled in the fused forward.
#include <algorithm>
#include <climits>
#include <type_traits>

#include "common.cuh"

namespace gsn {

constexpr int kMaxK = 16;       // most weight columns one launch takes
constexpr int kPathK = 5;       // the DGN paths' K, with its own registers
constexpr int kInFlight = 4;    // sender rows gathered before any is used
constexpr int kGroups = 3;      // single columns a lane owns in one tile
constexpr int kRows = 4;        // consecutive receiver rows a warp walks
constexpr int kMinBlocks = 3;   // resident blocks per SM the path's
                                // instantiations are compiled for
constexpr unsigned kFull = 0xffffffffu;

template <int N>
using IntC = std::integral_constant<int, N>;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// The lane's columns of one row of a column tile: group g covers the V
// columns from (lane + 32 g) V; columns at or past tc read as 0.
template <int V, int NG, typename T>
__device__ __forceinline__ void load_cols(const T* __restrict__ p, int tc,
                                          int lane, float (&x)[NG * V]) {
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const int c = (lane + kWarp * g) * V;
    if (c < tc) {
      if constexpr (V == 4) {
        static_assert(std::is_same<T, float>::value,
                      "float4 groups are f32 only");
        const float4 t = *reinterpret_cast<const float4*>(p + c);
        x[g * 4 + 0] = t.x; x[g * 4 + 1] = t.y;
        x[g * 4 + 2] = t.z; x[g * 4 + 3] = t.w;
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) x[g * V + i] = to_f32(p[c + i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) x[g * V + i] = 0.f;
    }
  }
}

// Store the lane's columns (those before tc) of one row, rounded to T.
template <int V, int NG, typename T>
__device__ __forceinline__ void store_cols(T* __restrict__ p, int tc,
                                           int lane,
                                           const float (&x)[NG * V]) {
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const int c = (lane + kWarp * g) * V;
    if (c < tc) {
      if constexpr (V == 4) {
        *reinterpret_cast<float4*>(p + c) =
            make_float4(x[g * 4], x[g * 4 + 1], x[g * 4 + 2], x[g * 4 + 3]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) p[c + i] = from_f32<T>(x[g * V + i]);
      }
    }
  }
}

// The path's instantiations (K = kPathK, or no weighted sums) are held to
// kMinBlocks resident blocks per SM: the few bytes some of them spill
// cost less than the occupancy they buy.  The generic-K ones, whose sums
// need more registers, are not held.
template <int KT, bool WEIGHTED>
constexpr int min_blocks() {
  return KT > 0 || !WEIGHTED ? kMinBlocks : 1;
}

// The warp's rows [row0, row0 + nr) and the edge chunk its lanes hold:
// lane i holds the first edge of row row0 + i (i <= nr) in `ptr`, and
// send and the K weights of edge cb + i in `s` and `w`.
template <int KM>
struct Walk {
  int nr, ptr, e_end, cb, s;
  float w[KM];

  __device__ __forceinline__ Walk(const int32_t* __restrict__ recv_ptr,
                                  int row0, int n_rows, int lane)
      : nr(min(kRows, n_rows - row0)),
        ptr(lane <= nr ? recv_ptr[row0 + lane] : 0),
        e_end(__shfl_sync(kFull, ptr, nr)), cb(INT_MIN / 2), s(0) {}

  __device__ __forceinline__ int first(int r) const {
    return __shfl_sync(kFull, ptr, r);
  }

  // Make edge e one the lanes hold: load the chunk of 32 edges from e
  // when e is past the held one; each weight is held as a TW would hold
  // it (the bf16 forward rounds W, f32 keeps it).
  template <bool SEND, bool WEIGHTED, typename TW>
  __device__ __forceinline__ void hold(int e,
                                       const int32_t* __restrict__ send,
                                       const float* __restrict__ W, int K,
                                       int lane) {
    if (e < cb + kWarp) return;
    cb = e;
    const int i = cb + lane;
    if constexpr (SEND) s = i < e_end ? send[i] : 0;
    if constexpr (WEIGHTED) {
#pragma unroll
      for (int k = 0; k < KM; ++k)
        w[k] = i < e_end && k < K
                   ? round_to<TW>(W[static_cast<size_t>(i) * K + k])
                   : 0.f;
    }
  }
};

// Gather the lane's columns of B's rows for the window's edges
// [e, e + nu), all issued before any is used; a window shorter than
// kInFlight re-reads its last edge's row.
template <int V, int NG, int KM, typename T>
__device__ __forceinline__ void gather(const Walk<KM>& walk, int e, int nu,
                                       const T* __restrict__ B, int d,
                                       int t0, int tc, int lane,
                                       float (&h)[kInFlight][NG * V]) {
#pragma unroll
  for (int u = 0; u < kInFlight; ++u) {
    const int s = __shfl_sync(kFull, walk.s, e - walk.cb + min(u, nu - 1));
    load_cols<V, NG>(B + static_cast<size_t>(s) * d + t0, tc, lane, h[u]);
  }
}

template <int V, int NG, int KT, bool WEIGHTED, bool MINMAX, typename T>
__global__ void __launch_bounds__(kThreads, (min_blocks<KT, WEIGHTED>()))
dgn_aggregate_fwd_kernel(const T* __restrict__ B,
                         const float* __restrict__ W,
                         const int32_t* __restrict__ recv_ptr,
                         const int32_t* __restrict__ send,
                         float* __restrict__ out, float* __restrict__ mm,
                         float* __restrict__ cnt, int n_rows, int d,
                         int k_arg) {
  constexpr int P = NG * V;            // columns a lane holds
  constexpr int TW = kWarp * P;        // columns a tile spans
  constexpr int KM = WEIGHTED ? (KT > 0 ? KT : kMaxK) : 1;
  const int K = WEIGHTED ? (KT > 0 ? KT : k_arg) : 0;
  const int lane = threadIdx.x % kWarp;
  const int row0 = (blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp)
                   * kRows;
  if (row0 >= n_rows) return;
  Walk<KM> walk(recv_ptr, row0, n_rows, lane);
  const float neg_inf = __int_as_float(0xff800000);

  for (int t0 = 0; t0 < d; t0 += TW) {
    const int tc = min(TW, d - t0);
    walk.cb = INT_MIN / 2;
    for (int r = 0; r < walk.nr; ++r) {
      const int row = row0 + r;
      const int e0 = walk.first(r), e1 = walk.first(r + 1);
      float acc[KM][P];
      float mx[P], nmn[P], cmx[P], cmn[P];
#pragma unroll
      for (int i = 0; i < P; ++i) {
#pragma unroll
        for (int k = 0; k < KM; ++k) acc[k][i] = 0.f;
        mx[i] = neg_inf; nmn[i] = neg_inf;
        cmx[i] = 0.f; cmn[i] = 0.f;
      }
      for (int e = e0; e < e1;) {
        walk.template hold<true, WEIGHTED, T>(e, send, W, K, lane);
        const int nu = min(kInFlight, min(e1 - e, walk.cb + kWarp - e));
        float h[kInFlight][P];
        gather<V, NG>(walk, e, nu, B, d, t0, tc, lane, h);
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          if (u < nu) {
            if constexpr (WEIGHTED) {
#pragma unroll
              for (int k = 0; k < KM; ++k) {
                if (k < K) {
                  const float wk =
                      __shfl_sync(kFull, walk.w[k], e - walk.cb + u);
#pragma unroll
                  for (int i = 0; i < P; ++i) acc[k][i] += wk * h[u][i];
                }
              }
            }
            if constexpr (MINMAX) {
#pragma unroll
              for (int i = 0; i < P; ++i) {
                const float x = h[u][i];
                if (x > mx[i]) { mx[i] = x; cmx[i] = 1.f; }
                else if (x == mx[i]) cmx[i] += 1.f;
                const float y = -x;
                if (y > nmn[i]) { nmn[i] = y; cmn[i] = 1.f; }
                else if (y == nmn[i]) cmn[i] += 1.f;
              }
            }
          }
        }
        e += nu;
      }

      if constexpr (WEIGHTED) {
        float* o = out + static_cast<size_t>(row) * K * d + t0;
#pragma unroll
        for (int k = 0; k < KM; ++k)
          if (k < K) store_cols<V, NG>(o + k * d, tc, lane, acc[k]);
      }
      if constexpr (MINMAX) {
        if (e0 == e1) {  // no edges: the DGL max fill 0, no ties
#pragma unroll
          for (int i = 0; i < P; ++i) { mx[i] = 0.f; nmn[i] = 0.f; }
        }
        const size_t o = static_cast<size_t>(row) * 2 * d + t0;
        store_cols<V, NG>(mm + o, tc, lane, mx);
        store_cols<V, NG>(mm + o + d, tc, lane, nmn);
        store_cols<V, NG>(cnt + o, tc, lane, cmx);
        store_cols<V, NG>(cnt + o + d, tc, lane, cmn);
      }
    }
  }
}

template <int V, int NG, int KT, bool WEIGHTED, bool MINMAX, bool DW,
          typename T>
__global__ void __launch_bounds__(kThreads, (min_blocks<KT, WEIGHTED>()))
dgn_aggregate_bwd_kernel(const T* __restrict__ B,
                         const float* __restrict__ W,
                         const T* __restrict__ g_w,
                         const float* __restrict__ mm,
                         const float* __restrict__ cnt,
                         const float* __restrict__ g_mm,
                         const int32_t* __restrict__ recv_ptr,
                         const int32_t* __restrict__ send,
                         T* __restrict__ dh, float* __restrict__ dW,
                         int n_rows, int d, int k_arg) {
  constexpr int P = NG * V;
  constexpr int TW = kWarp * P;
  constexpr int KM = WEIGHTED ? (KT > 0 ? KT : kMaxK) : 1;
  constexpr bool GATHER = MINMAX || DW;   // does the walk read B at all
  const int K = WEIGHTED ? (KT > 0 ? KT : k_arg) : 0;
  const int lane = threadIdx.x % kWarp;
  const int row0 = (blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp)
                   * kRows;
  if (row0 >= n_rows) return;
  Walk<KM> walk(recv_ptr, row0, n_rows, lane);

  for (int t0 = 0; t0 < d; t0 += TW) {
    const int tc = min(TW, d - t0);
    walk.cb = INT_MIN / 2;
    for (int r = 0; r < walk.nr; ++r) {
      const int row = row0 + r;
      const int e0 = walk.first(r), e1 = walk.first(r + 1);
      if (e0 == e1) continue;
      // the receiver's operands, once per row and tile
      float gw[KM][P];
      float mx[P], nmn[P], pmx[P], pmn[P];
      if constexpr (WEIGHTED) {
        const T* o = g_w + static_cast<size_t>(row) * K * d + t0;
#pragma unroll
        for (int k = 0; k < KM; ++k) {
          if (k < K) {
            load_cols<V, NG>(o + k * d, tc, lane, gw[k]);
          } else {
#pragma unroll
            for (int i = 0; i < P; ++i) gw[k][i] = 0.f;
          }
        }
      }
      if constexpr (MINMAX) {
        const size_t o = static_cast<size_t>(row) * 2 * d + t0;
        float cmx[P], cmn[P];
        load_cols<V, NG>(mm + o, tc, lane, mx);
        load_cols<V, NG>(mm + o + d, tc, lane, nmn);
        load_cols<V, NG>(cnt + o, tc, lane, cmx);
        load_cols<V, NG>(cnt + o + d, tc, lane, cmn);
        load_cols<V, NG>(g_mm + o, tc, lane, pmx);
        load_cols<V, NG>(g_mm + o + d, tc, lane, pmn);
#pragma unroll
        for (int i = 0; i < P; ++i) {
          pmx[i] = pmx[i] / fmaxf(cmx[i], 1.f);
          pmn[i] = pmn[i] / fmaxf(cmn[i], 1.f);
        }
      }

      for (int e = e0; e < e1;) {
        walk.template hold<GATHER, WEIGHTED, float>(e, send, W, K, lane);
        const int nu = min(kInFlight, min(e1 - e, walk.cb + kWarp - e));
        float h[kInFlight][P];
        if constexpr (GATHER)
          gather<V, NG>(walk, e, nu, B, d, t0, tc, lane, h);
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          if (u < nu) {
            float g[P];
#pragma unroll
            for (int i = 0; i < P; ++i) g[i] = 0.f;
            if constexpr (WEIGHTED) {
#pragma unroll
              for (int k = 0; k < KM; ++k) {
                if (k < K) {
                  const float wk =
                      __shfl_sync(kFull, walk.w[k], e - walk.cb + u);
#pragma unroll
                  for (int i = 0; i < P; ++i) g[i] += wk * gw[k][i];
                }
              }
            }
            if constexpr (MINMAX) {
#pragma unroll
              for (int i = 0; i < P; ++i) {
                const float up = h[u][i] == mx[i] ? pmx[i] : 0.f;
                const float dn = -h[u][i] == nmn[i] ? pmn[i] : 0.f;
                g[i] += up - dn;
              }
            }
            store_cols<V, NG>(dh + static_cast<size_t>(e + u) * d + t0, tc,
                              lane, g);
            if constexpr (DW) {
#pragma unroll
              for (int k = 0; k < KM; ++k) {
                if (k < K) {
                  float part = 0.f;
#pragma unroll
                  for (int i = 0; i < P; ++i) part += h[u][i] * gw[k][i];
                  const float s = warp_sum(part);
                  if (lane == 0) {
                    float* p = dW + static_cast<size_t>(e + u) * K + k;
                    // later tiles add to the first tile's partial sum
                    *p = t0 == 0 ? s : *p + s;
                  }
                }
              }
            }
          }
        }
        e += nu;
      }
    }
  }
}

// Run f with the column layout <V, NG> of a launch: for f32 one float4
// group when the width and pointers allow it, else kGroups single columns
// a lane; for bf16 always kGroups single columns (other widths loop over
// or leave part of the column tile).
template <typename T, typename F>
void with_layout(int vec, F&& f) {
  if constexpr (std::is_same<T, float>::value) {
    if (vec == 4) return f(IntC<4>{}, IntC<1>{});
  }
  f(IntC<1>{}, IntC<kGroups>{});
}

// Run f with the <WEIGHTED, MINMAX> flags of one of the three
// instantiations and KT = kPathK when a weighted launch has that many
// columns, else the generic KT = 0.
template <typename F>
void with_flags(int weighted, int minmax, int K, F&& f) {
  using Y = std::true_type;
  using N = std::false_type;
  if (weighted && K == kPathK) {
    if (minmax) f(Y{}, Y{}, IntC<kPathK>{});
    else f(Y{}, N{}, IntC<kPathK>{});
  } else if (weighted) {
    if (minmax) f(Y{}, Y{}, IntC<0>{});
    else f(Y{}, N{}, IntC<0>{});
  } else {
    f(N{}, Y{}, IntC<0>{});
  }
}

// The instantiation of K5 (BACKWARD false) or K6 (true) over rows of T
// for these arguments, passed to f.
template <bool BACKWARD, typename T, typename F>
void with_kernel(int K, int weighted, int minmax, int need_dw, int vec,
                 F&& f) {
  with_layout<T>(vec, [&](auto v, auto ng) {
    constexpr int V = decltype(v)::value, NG = decltype(ng)::value;
    with_flags(weighted, minmax, K, [&](auto wt, auto mmx, auto kt) {
      constexpr bool WT = decltype(wt)::value, MM = decltype(mmx)::value;
      constexpr int KT = decltype(kt)::value;
      if constexpr (!BACKWARD) {
        f(dgn_aggregate_fwd_kernel<V, NG, KT, WT, MM, T>);
      } else if (WT && need_dw) {
        f(dgn_aggregate_bwd_kernel<V, NG, KT, WT, MM, WT, T>);
      } else {
        f(dgn_aggregate_bwd_kernel<V, NG, KT, WT, MM, false, T>);
      }
    });
  });
}

template <typename... KArgs, typename... Args>
int launch_rows(void (*kernel)(KArgs...), int n_rows, cudaStream_t st,
                Args... args) {
  constexpr int rows = kWarpsPerBlock * kRows;
  kernel<<<(n_rows + rows - 1) / rows, kThreads, 0, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// Arguments no instantiation takes.
inline bool bad_args(int K, int weighted, int minmax, int need_dw) {
  return (!weighted && !minmax) || (weighted && (K < 1 || K > kMaxK))
         || (need_dw && !weighted);
}

template <typename T>
int launch_fwd(const T* B, const float* W, const int32_t* recv_ptr,
               const int32_t* send, float* out, float* mm, float* cnt,
               int n_rows, int d, int K, int weighted, int minmax, int vec,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = 0;
  with_kernel<false, T>(K, weighted, minmax, 0, vec, [&](auto kernel) {
    rc = launch_rows(kernel, n_rows, st, B, W, recv_ptr, send, out, mm, cnt,
                     n_rows, d, K);
  });
  return rc;
}

template <typename T>
int launch_bwd(const T* B, const float* W, const T* g_w, const float* mm,
               const float* cnt, const float* g_mm, const int32_t* recv_ptr,
               const int32_t* send, T* dh, float* dW, int n_rows, int d,
               int K, int weighted, int minmax, int need_dw, int vec,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = 0;
  with_kernel<true, T>(K, weighted, minmax, need_dw, vec, [&](auto kernel) {
    rc = launch_rows(kernel, n_rows, st, B, W, g_w, mm, cnt, g_mm, recv_ptr,
                     send, dh, dW, n_rows, d, K);
  });
  return rc;
}

// Resident blocks per SM of the instantiation over rows of T that a
// launch with these arguments takes, or a negative error.
template <typename T>
int occupancy(int backward, int d, int K, int weighted, int minmax,
              int need_dw, int vec) {
  int blocks = -1;
  auto query = [&](auto kernel) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, kernel, kThreads, 0) != cudaSuccess)
      blocks = -1;
  };
  if (backward)
    with_kernel<true, T>(K, weighted, minmax, need_dw, vec, query);
  else
    with_kernel<false, T>(K, weighted, minmax, 0, vec, query);
  return blocks;
}

}  // namespace gsn

// f32 rows: B, g_w and dh f32 (as every other operand)
extern "C" int gsn_dgn_aggregate_fwd(const float* B, const float* W,
                                     const int32_t* recv_ptr,
                                     const int32_t* send, float* out,
                                     float* mm, float* cnt, int n_rows,
                                     int d, int K, int weighted, int minmax,
                                     void* stream) {
  if (gsn::bad_args(K, weighted, minmax, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = gsn::vec_width<float>(d, {{B, 4}, {out, 4}, {mm, 4},
                                           {cnt, 4}});
  return gsn::launch_fwd(B, W, recv_ptr, send, out, mm, cnt, n_rows, d, K,
                         weighted, minmax, vec, stream);
}

extern "C" int gsn_dgn_aggregate_bwd(const float* B, const float* W,
                                     const float* g_w, const float* mm,
                                     const float* cnt, const float* g_mm,
                                     const int32_t* recv_ptr,
                                     const int32_t* send, float* dh,
                                     float* dW, int n_rows, int d, int K,
                                     int weighted, int minmax, int need_dw,
                                     void* stream) {
  if (gsn::bad_args(K, weighted, minmax, need_dw))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = gsn::vec_width<float>(
      d, {{B, 4}, {g_w, 4}, {mm, 4}, {cnt, 4}, {g_mm, 4}, {dh, 4}});
  return gsn::launch_bwd(B, W, g_w, mm, cnt, g_mm, recv_ptr, send, dh, dW,
                         n_rows, d, K, weighted, minmax, need_dw, vec,
                         stream);
}

// bf16 rows B (W, out, mm and cnt f32), same arguments otherwise
extern "C" int gsn_dgn_aggregate_fwd_bf16(const void* B, const float* W,
                                          const int32_t* recv_ptr,
                                          const int32_t* send, float* out,
                                          float* mm, float* cnt, int n_rows,
                                          int d, int K, int weighted,
                                          int minmax, void* stream) {
  if (gsn::bad_args(K, weighted, minmax, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  return gsn::launch_fwd(static_cast<const gsn::bf16*>(B), W, recv_ptr, send,
                         out, mm, cnt, n_rows, d, K, weighted, minmax, 1,
                         stream);
}

// bf16 B, g_w and dh (W, mm, cnt, g_mm and dW f32), same arguments
// otherwise
extern "C" int gsn_dgn_aggregate_bwd_bf16(const void* B, const float* W,
                                          const void* g_w, const float* mm,
                                          const float* cnt,
                                          const float* g_mm,
                                          const int32_t* recv_ptr,
                                          const int32_t* send, void* dh,
                                          float* dW, int n_rows, int d,
                                          int K, int weighted, int minmax,
                                          int need_dw, void* stream) {
  if (gsn::bad_args(K, weighted, minmax, need_dw))
    return static_cast<int>(cudaErrorInvalidValue);
  using gsn::bf16;
  return gsn::launch_bwd(static_cast<const bf16*>(B), W,
                         static_cast<const bf16*>(g_w), mm, cnt, g_mm,
                         recv_ptr, send, static_cast<bf16*>(dh), dW, n_rows,
                         d, K, weighted, minmax, need_dw, 1, stream);
}

// Resident blocks per SM of the instantiation a launch with these
// arguments takes, or a negative error; vec is 4 for float4 rows, else 1.
extern "C" int gsn_dgn_aggregate_occupancy(int backward, int d, int K,
                                           int weighted, int minmax,
                                           int need_dw, int vec) {
  if (gsn::bad_args(K, weighted, minmax, need_dw) || d < 1
      || (vec == 4 && d % 4 != 0))
    return -static_cast<int>(cudaErrorInvalidValue);
  return gsn::occupancy<float>(backward, d, K, weighted, minmax, need_dw,
                               vec);
}

// The same for bf16 rows (one layout).
extern "C" int gsn_dgn_aggregate_occupancy_bf16(int backward, int d, int K,
                                                int weighted, int minmax,
                                                int need_dw) {
  if (gsn::bad_args(K, weighted, minmax, need_dw) || d < 1)
    return -static_cast<int>(cudaErrorInvalidValue);
  return gsn::occupancy<gsn::bf16>(backward, d, K, weighted, minmax,
                                   need_dw, 1);
}
