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
//             (rows with no edges: mm = cnt = 0)
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
// floats a node row).  The backward reads B, W and the node-level
// cotangents and writes dh (one row per edge).  The per-row operands
// (g_w, mm, cnt, g_mm) are re-read for every edge of the row and stay
// in L1; B's rows are shared by a sender's few receivers and stay in L2.
#include "common.cuh"

namespace gsn {

// most weight columns one launch takes (registers: kMaxK x V sums)
constexpr int kMaxK = 16;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int V, bool WEIGHTED, bool MINMAX>
__global__ void __launch_bounds__(kThreads)
dgn_aggregate_fwd_kernel(const float* __restrict__ B,
                         const float* __restrict__ W,
                         const int32_t* __restrict__ recv_ptr,
                         const int32_t* __restrict__ send,
                         float* __restrict__ out, float* __restrict__ mm,
                         float* __restrict__ cnt, int n_rows, int d,
                         int K) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & (kWarp - 1);
  if (row >= n_rows) return;
  const int e0 = recv_ptr[row];
  const int e1 = recv_ptr[row + 1];
  const float neg_inf = __int_as_float(0xff800000);
  for (int c = lane * V; c < d; c += kWarp * V) {
    Frag<V> acc[WEIGHTED ? kMaxK : 1];
#pragma unroll
    for (int k = 0; k < (WEIGHTED ? kMaxK : 1); ++k) acc[k] = Frag<V>::zero();
    Frag<V> mx, nmn, cmx, cmn;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      mx.v[i] = neg_inf; nmn.v[i] = neg_inf;
      cmx.v[i] = 0.f; cmn.v[i] = 0.f;
    }
    for (int e = e0; e < e1; ++e) {
      const Frag<V> h = Frag<V>::load(B + (size_t)send[e] * d + c);
      if constexpr (WEIGHTED) {
        const float* w = W + (size_t)e * K;
#pragma unroll
        for (int k = 0; k < kMaxK; ++k) {
          if (k < K) {
            const float wk = w[k];
#pragma unroll
            for (int i = 0; i < V; ++i) acc[k].v[i] += wk * h.v[i];
          }
        }
      }
      if constexpr (MINMAX) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float x = h.v[i];
          if (x > mx.v[i]) { mx.v[i] = x; cmx.v[i] = 1.f; }
          else if (x == mx.v[i]) cmx.v[i] += 1.f;
          const float y = -x;
          if (y > nmn.v[i]) { nmn.v[i] = y; cmn.v[i] = 1.f; }
          else if (y == nmn.v[i]) cmn.v[i] += 1.f;
        }
      }
    }
    if constexpr (WEIGHTED) {
      float* o = out + (size_t)row * K * d + c;
#pragma unroll
      for (int k = 0; k < kMaxK; ++k)
        if (k < K) acc[k].store(o + (size_t)k * d);
    }
    if constexpr (MINMAX) {
      if (e0 == e1) {  // no edges: the DGL max fill 0, no ties
        mx = Frag<V>::zero(); nmn = Frag<V>::zero();
      }
      float* m = mm + (size_t)row * 2 * d + c;
      float* n = cnt + (size_t)row * 2 * d + c;
      mx.store(m);
      nmn.store(m + d);
      cmx.store(n);
      cmn.store(n + d);
    }
  }
}

template <int V, bool WEIGHTED, bool MINMAX, bool DW>
__global__ void __launch_bounds__(kThreads)
dgn_aggregate_bwd_kernel(const float* __restrict__ B,
                         const float* __restrict__ W,
                         const float* __restrict__ g_w,
                         const float* __restrict__ mm,
                         const float* __restrict__ cnt,
                         const float* __restrict__ g_mm,
                         const int32_t* __restrict__ recv_ptr,
                         const int32_t* __restrict__ send,
                         float* __restrict__ dh, float* __restrict__ dW,
                         int n_rows, int d, int K) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & (kWarp - 1);
  if (row >= n_rows) return;
  const int e0 = recv_ptr[row];
  const int e1 = recv_ptr[row + 1];
  const float* gw_row = g_w + (size_t)row * K * d;
  const float* mm_row = mm + (size_t)row * 2 * d;
  const float* cnt_row = cnt + (size_t)row * 2 * d;
  const float* gmm_row = g_mm + (size_t)row * 2 * d;
  for (int e = e0; e < e1; ++e) {
    const float* h_row = B + (size_t)send[e] * d;
    const float* w = W + (size_t)e * K;
    float part[DW ? kMaxK : 1];
#pragma unroll
    for (int k = 0; k < (DW ? kMaxK : 1); ++k) part[k] = 0.f;
    for (int c = lane * V; c < d; c += kWarp * V) {
      Frag<V> g = Frag<V>::zero();
      Frag<V> h;
      if constexpr (MINMAX || DW) h = Frag<V>::load(h_row + c);
      if constexpr (WEIGHTED) {
#pragma unroll
        for (int k = 0; k < kMaxK; ++k) {
          if (k < K) {
            const float wk = w[k];
            const Frag<V> gk = Frag<V>::load(gw_row + (size_t)k * d + c);
#pragma unroll
            for (int i = 0; i < V; ++i) {
              g.v[i] += wk * gk.v[i];
              if constexpr (DW) part[k] += h.v[i] * gk.v[i];
            }
          }
        }
      }
      if constexpr (MINMAX) {
        const Frag<V> mx = Frag<V>::load(mm_row + c);
        const Frag<V> nmn = Frag<V>::load(mm_row + d + c);
        const Frag<V> cmx = Frag<V>::load(cnt_row + c);
        const Frag<V> cmn = Frag<V>::load(cnt_row + d + c);
        const Frag<V> gmx = Frag<V>::load(gmm_row + c);
        const Frag<V> gmn = Frag<V>::load(gmm_row + d + c);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float up = h.v[i] == mx.v[i]
                               ? gmx.v[i] / fmaxf(cmx.v[i], 1.f) : 0.f;
          const float dn = -h.v[i] == nmn.v[i]
                               ? gmn.v[i] / fmaxf(cmn.v[i], 1.f) : 0.f;
          g.v[i] += up - dn;
        }
      }
      g.store(dh + (size_t)e * d + c);
    }
    if constexpr (DW) {
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (k < K) {
          const float s = warp_sum(part[k]);
          if (lane == 0) dW[(size_t)e * K + k] = s;
        }
      }
    }
  }
}

}  // namespace gsn

extern "C" int gsn_dgn_aggregate_fwd(const float* B, const float* W,
                                     const int32_t* recv_ptr,
                                     const int32_t* send, float* out,
                                     float* mm, float* cnt, int n_rows,
                                     int d, int K, int weighted, int minmax,
                                     void* stream) {
  if ((!weighted && !minmax) || (weighted && (K < 1 || K > gsn::kMaxK)))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {B, out, mm, cnt};
  const int vec = gsn::vec_width(d, ptrs, 4);
  const dim3 grid(gsn::row_blocks(n_rows));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  GSN_VEC_SWITCH(vec, V, [&] {
    GSN_BOOL_SWITCH(weighted, WT, [&] {
      GSN_BOOL_SWITCH(minmax, MM, [&] {
        gsn::dgn_aggregate_fwd_kernel<V, WT, MM>
            <<<grid, gsn::kThreads, 0, st>>>(B, W, recv_ptr, send, out, mm,
                                             cnt, n_rows, d, K);
      });
    });
  });
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gsn_dgn_aggregate_bwd(const float* B, const float* W,
                                     const float* g_w, const float* mm,
                                     const float* cnt, const float* g_mm,
                                     const int32_t* recv_ptr,
                                     const int32_t* send, float* dh,
                                     float* dW, int n_rows, int d, int K,
                                     int weighted, int minmax, int need_dw,
                                     void* stream) {
  if ((!weighted && !minmax) || (weighted && (K < 1 || K > gsn::kMaxK))
      || (need_dw && !weighted))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {B, g_w, mm, cnt, g_mm, dh};
  const int vec = gsn::vec_width(d, ptrs, 6);
  const dim3 grid(gsn::row_blocks(n_rows));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  GSN_VEC_SWITCH(vec, V, [&] {
    GSN_BOOL_SWITCH(weighted, WT, [&] {
      GSN_BOOL_SWITCH(minmax, MM, [&] {
        GSN_BOOL_SWITCH(need_dw, DWG, [&] {
          gsn::dgn_aggregate_bwd_kernel<V, WT, MM, DWG>
              <<<grid, gsn::kThreads, 0, st>>>(B, W, g_w, mm, cnt, g_mm,
                                               recv_ptr, send, dh, dW,
                                               n_rows, d, K);
        });
      });
    });
  });
  return static_cast<int>(cudaGetLastError());
}
