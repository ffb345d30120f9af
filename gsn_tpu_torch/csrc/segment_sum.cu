// K3 segment_sum_sorted: out[k] = sum_{i in ptr[k]..ptr[k+1]} rows[perm[i]]
// (perm optional: identity when absent), accumulated in f32.
//
// Replaces gsn_tpu/ops/pallas/slab_combine.py: slab_combine_sum (the
// keyed block-row sum of per-chunk slabs) and the forward of
// gsn_tpu/ops/pallas/slab_pool.py: slab_add_pool (_pool_fwd_kernel and
// its one-hot combine).  Both compute a sum of rows into sorted
// segments; on Hopper a warp walks each segment's rows directly.  It
// serves the sender-side dB of the edge message backward (rows = dH,
// segments = senders through the host-built sender-sorted permutation)
// and the graph readout (rows = node rows, segments = graphs).  Each
// segment is summed in a fixed order by one warp, so the result is
// deterministic: no float atomics.
//
// Bound: bytes (one read of every summed row, one write of every output
// row; one add per element).
#include "common.cuh"

namespace gsn {

template <int V, bool HAS_PERM>
__global__ void __launch_bounds__(kThreads)
segment_sum_sorted_kernel(const float* __restrict__ rows,
                          const int32_t* __restrict__ ptr,
                          const int32_t* __restrict__ perm,
                          float* __restrict__ out, int n_seg, int d) {
  const int seg = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & (kWarp - 1);
  if (seg >= n_seg) return;
  const int i0 = ptr[seg];
  const int i1 = ptr[seg + 1];
  for (int c = lane * V; c < d; c += kWarp * V) {
    Frag<V> acc = Frag<V>::zero();
    for (int i = i0; i < i1; ++i) {
      const int r = HAS_PERM ? perm[i] : i;
      const Frag<V> x = Frag<V>::load(rows + (size_t)r * d + c);
#pragma unroll
      for (int j = 0; j < V; ++j) acc.v[j] += x.v[j];
    }
    acc.store(out + (size_t)seg * d + c);
  }
}

}  // namespace gsn

extern "C" int gsn_segment_sum_sorted(const float* rows, const int32_t* ptr,
                                      const int32_t* perm, float* out,
                                      int n_seg, int d, void* stream) {
  const void* ptrs[] = {rows, out};
  const int vec = gsn::vec_width(d, ptrs, 2);
  const dim3 grid(gsn::row_blocks(n_seg));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  GSN_VEC_SWITCH(vec, V, [&] {
    GSN_BOOL_SWITCH(perm != nullptr, HP, [&] {
      gsn::segment_sum_sorted_kernel<V, HP>
          <<<grid, gsn::kThreads, 0, st>>>(rows, ptr, perm, out, n_seg, d);
    });
  });
  return static_cast<int>(cudaGetLastError());
}
