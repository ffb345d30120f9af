// K3 segment_sum_sorted: out[k] = sum_{i in ptr[k]..ptr[k+1]} rows[perm[i]]
// (perm optional: identity when absent), accumulated in f32.
//
// Replaces gsn_tpu/ops/pallas/slab_combine.py: slab_combine_sum (the
// keyed block-row sum of per-chunk slabs) and the forward of
// gsn_tpu/ops/pallas/slab_pool.py: slab_add_pool (_pool_fwd_kernel and
// its one-hot combine).  Both compute a sum of rows into sorted
// segments; on Hopper the rows of each segment are walked directly.  It
// serves the sender-side dB of the edge message backward (rows = dH,
// segments = senders through the host-built sender-sorted permutation),
// the per-edge message sum at the receivers (rows = messages, segments
// = recv_ptr), the graph readout (rows = node rows, segments = graphs)
// and B4's backward.  No float atomics: every sum has a fixed order.
//
// Rows and output are f32 -> f32, or in the reference's bf16 mode bf16
// -> f32 (the pools: slab_pool.py:123-142 keeps bf16 rows and pools them
// in f32), bf16 -> bf16 (dB, and the virtual node's broadcast backward:
// an f32 sum rounded once on its store) and f32 -> bf16 (dB of the
// fused-BN moments pass, whose dH is f32: slab_message.py:682-684).
//
// Bound: bytes (one read of every summed row, one write of every output
// row; one add per element).  At the paths' sizes every call is a few
// microseconds, so what costs is latency: the chain ptr -> perm -> rows
// -> store, and how many rows one lane waits on in turn.  The design
// (row_tile.cuh) walks each segment once with the lane's whole column
// tile in registers, 2-element accesses where 4 or 8 do not fit (d=150),
// and kTileInFlight rows loaded before any is added.  Each lane loads
// the window's perm entries itself (one address for the whole group, so
// one transaction): a chunk of 32 loaded by the lanes and handed out by
// __shfl_sync was measured slower at every path shape (PERF.md, section 6).
// Two forms, picked by the caller from the shape
// (gsn_tpu_torch/ops/cuda/slab_combine.py: segment_sum_form):
//
// - warp (form 0), for many short segments (the message sums and dB: 2.3
//   and 1.3 rows a segment at zinc-cli): a group of lanes (a warp, or a
//   half warp for a bf16 row of at most 128 elements) owns a segment and
//   adds its rows in their order, so each element's sum is the one of a
//   walk over the segment one row at a time.
// - block (form 1), for few long segments (the pools: 128 graphs of ~25
//   rows at zinc-cli): one warp a segment would leave most of the card
//   idle and make each lane wait on ~25 rows in turn.  A block owns a
//   segment, and warp w adds the w-th of kWarpsPerBlock equal runs of
//   its rows, in order; the warps' partial sums meet in shared memory
//   and are added in warp order.  So the order is fixed and the result
//   the same bits on every call, but it is not the row-order sum.
#include "row_tile.cuh"

namespace gsn {

constexpr int kFormWarp = 0, kFormBlock = 1;

// The rows at positions [i0, i1) of the segment walk, added into acc
// (the tile of columns [t0, t0 + tc)) in their order; kTileInFlight
// rows (their perm entries first) are loaded before any is converted or
// added.
template <int V, int NG, int LANES, bool HAS_PERM, typename Tin>
__device__ __forceinline__ void add_rows(const Tin* __restrict__ rows,
                                         const int32_t* __restrict__ perm,
                                         int i0, int i1, int d, int t0,
                                         int tc, int lane,
                                         float (&acc)[NG * V]) {
  constexpr int P = NG * V;
  for (int i = i0; i < i1; i += kTileInFlight) {
    Words<Tin, V> w[kTileInFlight][NG];
#pragma unroll
    for (int u = 0; u < kTileInFlight; ++u) {
      if (i + u < i1) {
        const int r = HAS_PERM ? perm[i + u] : i + u;
        tile_load_words<V, NG, LANES>(rows + (size_t)r * d + t0, tc, lane,
                                      w[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kTileInFlight; ++u) {
      if (i + u < i1) {
        float x[P];
        tile_unpack(w[u], x);
#pragma unroll
        for (int j = 0; j < P; ++j) acc[j] += x[j];
      }
    }
  }
}

template <typename Tin, typename Tout, int V, int NG, int LANES,
          bool HAS_PERM>
__global__ void __launch_bounds__(kThreads)
segment_sum_warp_kernel(const Tin* __restrict__ rows,
                        const int32_t* __restrict__ ptr,
                        const int32_t* __restrict__ perm,
                        Tout* __restrict__ out, int n_seg, int d) {
  constexpr int TW = LANES * NG * V;   // columns a tile spans
  const int seg = blockIdx.x * (kThreads / LANES) + threadIdx.x / LANES;
  const int lane = threadIdx.x % LANES;
  if (seg >= n_seg) return;
  const int i0 = ptr[seg];
  const int i1 = ptr[seg + 1];
  for (int t0 = 0; t0 < d; t0 += TW) {
    const int tc = min(TW, d - t0);
    float acc[NG * V];
    tile_zero(acc);
    add_rows<V, NG, LANES, HAS_PERM>(rows, perm, i0, i1, d, t0, tc, lane,
                                     acc);
    tile_store<V, NG, LANES>(out + (size_t)seg * d + t0, tc, lane, acc);
  }
}

template <typename Tin, typename Tout, int V, int NG, bool HAS_PERM>
__global__ void __launch_bounds__(kThreads)
segment_sum_block_kernel(const Tin* __restrict__ rows,
                         const int32_t* __restrict__ ptr,
                         const int32_t* __restrict__ perm,
                         Tout* __restrict__ out, int d) {
  constexpr int P = NG * V;
  constexpr int TW = kWarp * P;
  __shared__ float part[kWarpsPerBlock][TW];
  const int seg = blockIdx.x;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int i0 = ptr[seg];
  const int n = ptr[seg + 1] - i0;
  // warp w's run of the segment's positions
  const int w0 = i0 + (int)((long long)n * warp / kWarpsPerBlock);
  const int w1 = i0 + (int)((long long)n * (warp + 1) / kWarpsPerBlock);
  for (int t0 = 0; t0 < d; t0 += TW) {
    const int tc = min(TW, d - t0);
    float acc[P];
    tile_zero(acc);
    add_rows<V, NG, kWarp, HAS_PERM>(rows, perm, w0, w1, d, t0, tc, lane,
                                     acc);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int c = (lane + kWarp * g) * V;
#pragma unroll
      for (int i = 0; i < V; ++i) part[warp][c + i] = acc[g * V + i];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < tc; c += kThreads) {
      float s = part[0][c];
#pragma unroll
      for (int w = 1; w < kWarpsPerBlock; ++w) s += part[w][c];
      out[(size_t)seg * d + t0 + c] = from_f32<Tout>(s);
    }
    __syncthreads();   // the next tile writes part again
  }
}

template <typename Tin, typename Tout>
int launch_segment_sum(const Tin* rows, const int32_t* ptr,
                       const int32_t* perm, Tout* out, int n_seg, int d,
                       int form, void* stream) {
  if (form != kFormWarp && form != kFormBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  const int t_in = sizeof(Tin), t_out = sizeof(Tout);
  const int vec = tile_vec_width<Tin>(d, {{rows, t_in}, {out, t_out}});
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  GSN_BOOL_SWITCH(perm != nullptr, HP, [&] {
    if (form == kFormBlock) {
      tile_switch<Tin, false>(vec, d, [&](auto v, auto ng, auto) {
        constexpr int V = decltype(v)::value, NG = decltype(ng)::value;
        segment_sum_block_kernel<Tin, Tout, V, NG, HP>
            <<<n_seg, kThreads, 0, st>>>(rows, ptr, perm, out, d);
      });
    } else {
      tile_switch<Tin>(vec, d, [&](auto v, auto ng, auto l) {
        constexpr int V = decltype(v)::value, NG = decltype(ng)::value;
        constexpr int LANES = decltype(l)::value;
        segment_sum_warp_kernel<Tin, Tout, V, NG, LANES, HP>
            <<<row_blocks(n_seg, LANES), kThreads, 0, st>>>(
                rows, ptr, perm, out, n_seg, d);
      });
    }
  });
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gsn

// form: 0 warp, 1 block (see the header)
extern "C" int gsn_segment_sum_sorted(const float* rows, const int32_t* ptr,
                                      const int32_t* perm, float* out,
                                      int n_seg, int d, int form,
                                      void* stream) {
  return gsn::launch_segment_sum(rows, ptr, perm, out, n_seg, d, form,
                                 stream);
}

// bf16 rows; out is bf16 when out_bf16, else f32
extern "C" int gsn_segment_sum_sorted_bf16(const void* rows,
                                           const int32_t* ptr,
                                           const int32_t* perm, void* out,
                                           int n_seg, int d, int out_bf16,
                                           int form, void* stream) {
  using gsn::bf16;
  const bf16* r = static_cast<const bf16*>(rows);
  return out_bf16
             ? gsn::launch_segment_sum(r, ptr, perm, static_cast<bf16*>(out),
                                       n_seg, d, form, stream)
             : gsn::launch_segment_sum(r, ptr, perm, static_cast<float*>(out),
                                       n_seg, d, form, stream);
}

// f32 rows summed into bf16 out
extern "C" int gsn_segment_sum_sorted_f32_bf16(const float* rows,
                                               const int32_t* ptr,
                                               const int32_t* perm,
                                               void* out, int n_seg, int d,
                                               int form, void* stream) {
  return gsn::launch_segment_sum(rows, ptr, perm,
                                 static_cast<gsn::bf16*>(out), n_seg, d,
                                 form, stream);
}
