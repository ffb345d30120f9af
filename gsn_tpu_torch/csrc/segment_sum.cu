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
// Rows and output are f32 -> f32, or in the reference's bf16 mode bf16
// -> f32 (the pools: slab_pool.py:123-142 keeps bf16 rows and pools them
// in f32), bf16 -> bf16 (dB, and the virtual node's broadcast backward:
// an f32 sum rounded once on its store) and f32 -> bf16 (dB of the
// fused-BN moments pass, whose dH is f32: slab_message.py:682-684).
//
// Bound: bytes (one read of every summed row, one write of every output
// row; one add per element).
#include "common.cuh"

namespace gsn {

template <typename Tin, typename Tout, int V, int LANES, bool HAS_PERM>
__global__ void __launch_bounds__(kThreads)
segment_sum_sorted_kernel(const Tin* __restrict__ rows,
                          const int32_t* __restrict__ ptr,
                          const int32_t* __restrict__ perm,
                          Tout* __restrict__ out, int n_seg, int d) {
  const int seg = blockIdx.x * (kThreads / LANES) + threadIdx.x / LANES;
  const int lane = threadIdx.x % LANES;
  if (seg >= n_seg) return;
  const int i0 = ptr[seg];
  const int i1 = ptr[seg + 1];
  for (int c = lane * V; c < d; c += LANES * V) {
    Frag<V> acc = Frag<V>::zero();
    // unrolled so that several rows' loads are in flight at once (a
    // graph readout has few segments); the adds keep their order
#pragma unroll 4
    for (int i = i0; i < i1; ++i) {
      const int r = HAS_PERM ? perm[i] : i;
      const Frag<V> x = Frag<V>::load(rows + (size_t)r * d + c);
#pragma unroll
      for (int j = 0; j < V; ++j) acc.v[j] += x.v[j];
    }
    acc.store(out + (size_t)seg * d + c);
  }
}

template <typename Tin, typename Tout>
int launch_segment_sum(const Tin* rows, const int32_t* ptr,
                       const int32_t* perm, Tout* out, int n_seg, int d,
                       void* stream) {
  const int t_in = sizeof(Tin), t_out = sizeof(Tout);
  const int vec = vec_width<Tin>(d, {{rows, t_in}, {out, t_out}});
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  vec_switch<Tin>(vec, [&](auto v) {
    constexpr int V = decltype(v)::value;
    lanes_switch<V>(d, [&](auto l) {
      constexpr int LANES = decltype(l)::value;
      const dim3 grid(row_blocks(n_seg, LANES));
      GSN_BOOL_SWITCH(perm != nullptr, HP, [&] {
        segment_sum_sorted_kernel<Tin, Tout, V, LANES, HP>
            <<<grid, kThreads, 0, st>>>(rows, ptr, perm, out, n_seg, d);
      });
    });
  });
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gsn

extern "C" int gsn_segment_sum_sorted(const float* rows, const int32_t* ptr,
                                      const int32_t* perm, float* out,
                                      int n_seg, int d, void* stream) {
  return gsn::launch_segment_sum(rows, ptr, perm, out, n_seg, d, stream);
}

// bf16 rows; out is bf16 when out_bf16, else f32
extern "C" int gsn_segment_sum_sorted_bf16(const void* rows,
                                           const int32_t* ptr,
                                           const int32_t* perm, void* out,
                                           int n_seg, int d, int out_bf16,
                                           void* stream) {
  using gsn::bf16;
  const bf16* r = static_cast<const bf16*>(rows);
  return out_bf16
             ? gsn::launch_segment_sum(r, ptr, perm, static_cast<bf16*>(out),
                                       n_seg, d, stream)
             : gsn::launch_segment_sum(r, ptr, perm, static_cast<float*>(out),
                                       n_seg, d, stream);
}

// f32 rows summed into bf16 out
extern "C" int gsn_segment_sum_sorted_f32_bf16(const float* rows,
                                               const int32_t* ptr,
                                               const int32_t* perm,
                                               void* out, int n_seg, int d,
                                               void* stream) {
  return gsn::launch_segment_sum(rows, ptr, perm,
                                 static_cast<gsn::bf16*>(out), n_seg, d,
                                 stream);
}
