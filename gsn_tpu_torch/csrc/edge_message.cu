// K1 edge_message_fwd and K2 edge_message_bwd_recv: the fused GSN edge
// message MLP's first layer, gathered and aggregated per receiver.
//
// Replaces gsn_tpu/ops/pallas/slab_message.py: slab_edge_message_aggregate
// (forward _fwd_kernel and backward _bwd_kernel) together with the
// receiver-side slab reduction of gsn_tpu/ops/pallas/slab_combine.py:
// slab_combine_sum.  The TPU kernel moved its gathers and scatters onto
// the matrix unit as one-hot products over chunk slabs, then combined the
// slabs; here each warp walks one receiver's edges in the batch's
// receiver-sorted order (CSR recv_ptr) and gathers the sender rows
// directly, so there are no slabs and no combine pass.
//
// Bound: bytes.  Per feature the work is a handful of adds, far below
// the card's f32 rate; what the kernel must move is the output (one row
// per node), A and g (one row per receiver with edges), Pe and dH (one
// row per edge) and B (one row per sender with edges).  A row with no
// edges reads nothing and writes zeros.  The row walk reads A, Pe and
// the output once and B once per edge (B's rows are shared by the few
// receivers of each sender and stay in L2).
//
//   forward   out[v] = sum_{e in recv_ptr[v]..recv_ptr[v+1]}
//                        act(B[send[e]] + A[v] + Pe[e] + b1)
//   backward  dH[e]  = act'(H[e]) * g[v]   for each edge e of receiver v
//             dA[v]  = sum_e dH[e]
// act is relu or identity; relu's backward recomputes H from the inputs
// (as the TPU kernel does) instead of storing it.
#include "common.cuh"

namespace gsn {

template <int V, bool RELU, bool HAS_A, bool HAS_PE>
__global__ void __launch_bounds__(kThreads)
edge_message_fwd_kernel(const float* __restrict__ A,
                        const float* __restrict__ B,
                        const float* __restrict__ Pe,
                        const float* __restrict__ b1,
                        const int32_t* __restrict__ recv_ptr,
                        const int32_t* __restrict__ send,
                        float* __restrict__ out, int n_rows, int d) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & (kWarp - 1);
  if (row >= n_rows) return;
  const int e0 = recv_ptr[row];
  const int e1 = recv_ptr[row + 1];
  if (e0 == e1) {  // no edges (padding rows too): no A or b1 reads
    for (int c = lane * V; c < d; c += kWarp * V)
      Frag<V>::zero().store(out + (size_t)row * d + c);
    return;
  }
  for (int c = lane * V; c < d; c += kWarp * V) {
    const Frag<V> a = HAS_A ? Frag<V>::load(A + (size_t)row * d + c)
                            : Frag<V>::zero();
    const Frag<V> bias = Frag<V>::load(b1 + c);
    Frag<V> acc = Frag<V>::zero();
    for (int e = e0; e < e1; ++e) {
      const int s = send[e];
      const Frag<V> h = Frag<V>::load(B + (size_t)s * d + c);
      const Frag<V> pe = HAS_PE ? Frag<V>::load(Pe + (size_t)e * d + c)
                                : Frag<V>::zero();
#pragma unroll
      for (int i = 0; i < V; ++i) {
        // the reference's order: B[send] + A[recv] + Pe + b1
        float x = h.v[i];
        if (HAS_A) x += a.v[i];
        if (HAS_PE) x += pe.v[i];
        x += bias.v[i];
        if (RELU) x = fmaxf(x, 0.f);
        acc.v[i] += x;
      }
    }
    acc.store(out + (size_t)row * d + c);
  }
}

template <int V, bool RELU, bool HAS_A, bool HAS_PE>
__global__ void __launch_bounds__(kThreads)
edge_message_bwd_recv_kernel(const float* __restrict__ A,
                             const float* __restrict__ B,
                             const float* __restrict__ Pe,
                             const float* __restrict__ b1,
                             const float* __restrict__ g,
                             const int32_t* __restrict__ recv_ptr,
                             const int32_t* __restrict__ send,
                             float* __restrict__ dH,
                             float* __restrict__ dA, int n_rows, int d) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & (kWarp - 1);
  if (row >= n_rows) return;
  const int e0 = recv_ptr[row];
  const int e1 = recv_ptr[row + 1];
  if (e0 == e1) {  // no edges: no g, A or b1 reads
    if (HAS_A)
      for (int c = lane * V; c < d; c += kWarp * V)
        Frag<V>::zero().store(dA + (size_t)row * d + c);
    return;
  }
  for (int c = lane * V; c < d; c += kWarp * V) {
    const Frag<V> gv = Frag<V>::load(g + (size_t)row * d + c);
    const Frag<V> a = (RELU && HAS_A)
                          ? Frag<V>::load(A + (size_t)row * d + c)
                          : Frag<V>::zero();
    const Frag<V> bias = RELU ? Frag<V>::load(b1 + c) : Frag<V>::zero();
    Frag<V> acc = Frag<V>::zero();
    for (int e = e0; e < e1; ++e) {
      Frag<V> dh = gv;
      if (RELU) {
        const int s = send[e];
        const Frag<V> h = Frag<V>::load(B + (size_t)s * d + c);
        const Frag<V> pe = HAS_PE ? Frag<V>::load(Pe + (size_t)e * d + c)
                                  : Frag<V>::zero();
#pragma unroll
        for (int i = 0; i < V; ++i) {
          float x = h.v[i];
          if (HAS_A) x += a.v[i];
          if (HAS_PE) x += pe.v[i];
          x += bias.v[i];
          dh.v[i] = x > 0.f ? gv.v[i] : 0.f;
        }
      }
      dh.store(dH + (size_t)e * d + c);
#pragma unroll
      for (int i = 0; i < V; ++i) acc.v[i] += dh.v[i];
    }
    if (HAS_A) acc.store(dA + (size_t)row * d + c);
  }
}

}  // namespace gsn

extern "C" int gsn_edge_message_fwd(const float* A, const float* B,
                                    const float* Pe, const float* b1,
                                    const int32_t* recv_ptr,
                                    const int32_t* send, float* out,
                                    int n_rows, int d, int relu, int has_a,
                                    int has_pe, void* stream) {
  const void* ptrs[] = {A, B, Pe, b1, out};
  const int vec = gsn::vec_width(d, ptrs, 5);
  const dim3 grid(gsn::row_blocks(n_rows));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  GSN_VEC_SWITCH(vec, V, [&] {
    GSN_BOOL_SWITCH(relu, R, [&] {
      GSN_BOOL_SWITCH(has_a, HA, [&] {
        GSN_BOOL_SWITCH(has_pe, HP, [&] {
          gsn::edge_message_fwd_kernel<V, R, HA, HP>
              <<<grid, gsn::kThreads, 0, st>>>(A, B, Pe, b1, recv_ptr, send,
                                               out, n_rows, d);
        });
      });
    });
  });
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gsn_edge_message_bwd_recv(const float* A, const float* B,
                                         const float* Pe, const float* b1,
                                         const float* g,
                                         const int32_t* recv_ptr,
                                         const int32_t* send, float* dH,
                                         float* dA, int n_rows, int d,
                                         int relu, int has_a, int has_pe,
                                         void* stream) {
  const void* ptrs[] = {A, B, Pe, b1, g, dH, dA};
  const int vec = gsn::vec_width(d, ptrs, 7);
  const dim3 grid(gsn::row_blocks(n_rows));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  GSN_VEC_SWITCH(vec, V, [&] {
    GSN_BOOL_SWITCH(relu, R, [&] {
      GSN_BOOL_SWITCH(has_a, HA, [&] {
        GSN_BOOL_SWITCH(has_pe, HP, [&] {
          gsn::edge_message_bwd_recv_kernel<V, R, HA, HP>
              <<<grid, gsn::kThreads, 0, st>>>(A, B, Pe, b1, g, recv_ptr,
                                               send, dH, dA, n_rows, d);
        });
      });
    });
  });
  return static_cast<int>(cudaGetLastError());
}
