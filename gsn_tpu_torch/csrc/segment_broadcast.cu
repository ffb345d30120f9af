// K4 segment_broadcast: out[v] = g[k] for every row v in segment k
// (ptr[k] <= v < ptr[k+1]), and 0 on rows outside every segment.
//
// Replaces gsn_tpu/ops/pallas/slab_pool.py: _pool_bwd_kernel, the
// backward of slab_add_pool (dx = g[batch], 0 on padding nodes); the
// same graph->node gather is slab_graph_broadcast's forward (B4, the
// virtual node's broadcast), which launches it too.  The TPU kernel
// built a graph one-hot per
// node chunk and multiplied; here each warp owns one output row, finds
// its segment by binary search over the sorted offsets, and copies the
// segment's row.  Every output row is written, padding rows with zeros,
// so the caller needs no zero fill.
//
// Bound: bytes (one read of each segment row, one write of each output
// row; no arithmetic beyond the search).
#include "common.cuh"

namespace gsn {

template <int V>
__global__ void __launch_bounds__(kThreads)
segment_broadcast_kernel(const float* __restrict__ g,
                         const int32_t* __restrict__ ptr, int n_seg,
                         float* __restrict__ out, int n_rows, int d) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & (kWarp - 1);
  if (row >= n_rows) return;
  int k = -1;
  if (row >= ptr[0] && row < ptr[n_seg]) {
    // invariant: ptr[lo] <= row < ptr[hi]
    int lo = 0, hi = n_seg;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (ptr[mid] <= row) lo = mid; else hi = mid;
    }
    k = lo;
  }
  for (int c = lane * V; c < d; c += kWarp * V) {
    const Frag<V> x = k >= 0 ? Frag<V>::load(g + (size_t)k * d + c)
                             : Frag<V>::zero();
    x.store(out + (size_t)row * d + c);
  }
}

}  // namespace gsn

extern "C" int gsn_segment_broadcast(const float* g, const int32_t* ptr,
                                     int n_seg, float* out, int n_rows,
                                     int d, void* stream) {
  const void* ptrs[] = {g, out};
  const int vec = gsn::vec_width(d, ptrs, 2);
  const dim3 grid(gsn::row_blocks(n_rows));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  GSN_VEC_SWITCH(vec, V, [&] {
    gsn::segment_broadcast_kernel<V>
        <<<grid, gsn::kThreads, 0, st>>>(g, ptr, n_seg, out, n_rows, d);
  });
  return static_cast<int>(cudaGetLastError());
}
