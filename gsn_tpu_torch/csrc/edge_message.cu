// K1 edge_message_fwd and K2 edge_message_bwd_recv: the fused GSN edge
// message MLP's first layer, gathered and aggregated per receiver.
//
// Replaces gsn_tpu/ops/pallas/slab_message.py: slab_edge_message_aggregate
// (forward _fwd_kernel and backward _bwd_kernel) together with the
// receiver-side slab reduction of gsn_tpu/ops/pallas/slab_combine.py:
// slab_combine_sum.  The TPU kernel moved its gathers and scatters onto
// the matrix unit as one-hot products over chunk slabs, then combined the
// slabs; here the lanes walk each receiver's edges in the batch's
// receiver-sorted order (CSR recv_ptr) and gather the sender rows
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
//
// The third activation code, id_sq, is the fused-BN moments pass of the
// message MLP (slab_message.py:224-227, 260-262, 529-537, 604-618):
//   forward   out[v] = [sum_e H[e], sum_e H[e]^2]          (width 2d)
//   backward  dH[e]  = g[v, :d] + 2 H[e] g[v, d:]
// Its output, cotangent and dH are f32 for either data type: bf16-rounded
// moments would lose the digits of var = E[H^2] - E[H]^2.
//
// Element type T of A, B, Pe, g, out, dH and dA: f32, or bf16 (the
// reference's data_dtype="bfloat16", slab_message.py:228-235, 253-277,
// 579-584); in id_sq mode out, g and dH are f32 and dA is T.  b1 is f32
// in both.  H is computed in f32 from the T values in the reference's
// order B + A + Pe + b1, so the relu mask is the reference's; in bf16
// each relu or identity message is rounded to bf16 before the f32 row
// sum, the row sum is rounded once on its store, and dH, a masked copy of
// g, is exact.  The reference also rounds each chunk's partial sum; a row
// here has no chunks.
//
// Both kernels walk each receiver's edges once with a register tile
// (row_tile.cuh).  At a receiver's 2.3 edges (the ZINC batches) a walk is
// a short chain of dependent loads, recv_ptr -> send -> B, which a loop
// over columns outside the edge walk pays ceil(d / 32) times over at one
// element a lane (d=150: 5 times).  A lane holds 2-element accesses where
// 4 or 8 do not fit, a group walks up to kRowsPerGroup consecutive rows
// (one recv_ptr load and one send chunk of the group's lanes serve all of
// them, send handed out by __shfl_sync), and the sender and Pe rows of up
// to 4 edges (edges_in_flight) are loaded before any is converted or
// added.  K2 loads a row's g (and A) tile once before its edges and
// stores each edge's dH tile as it goes.  The adds keep each element's
// edge order and each message's rounding, so the bits are those of a
// walk over one column and one edge at a time.
#include <climits>

#include "row_tile.cuh"

namespace gsn {

// activation codes of the entry points
constexpr int kIdentity = 0, kRelu = 1, kIdSq = 2;

// the type of what id_sq keeps in f32 (out, g, dH), else T
template <typename T, int ACT>
using SqT = std::conditional_t<ACT == kIdSq, float, T>;

// Edges whose sender and Pe rows K1 and K2 load before any is used: 4
// for a tile of at most 4 columns a lane, else 2.  A larger tile's in-flight
// registers cost more resident warps than the loads gain: a receiver
// has 2.3 edges on average (PERF.md, section 6).
template <int P>
__host__ __device__ constexpr int edges_in_flight() {
  return P <= 4 ? 4 : 2;
}

// K1.  A group of LANES lanes walks rows_per_group consecutive receiver
// rows, each once (see the header): lane i holds the first edge of row
// row0 + i, and send for a chunk of LANES edges of the group's range.
template <typename T, int V, int NG, int LANES, int ACT, bool HAS_A,
          bool HAS_PE>
__global__ void __launch_bounds__(kThreads)
edge_message_fwd_kernel(const T* __restrict__ A,
                        const T* __restrict__ B,
                        const T* __restrict__ Pe,
                        const float* __restrict__ b1,
                        const int32_t* __restrict__ recv_ptr,
                        const int32_t* __restrict__ send,
                        SqT<T, ACT>* __restrict__ out, int n_rows, int d,
                        int rows_per_group) {
  constexpr bool SQ = ACT == kIdSq;
  constexpr int P = NG * V;          // columns a lane holds
  constexpr int TW = LANES * P;      // columns a tile spans
  constexpr int IF = edges_in_flight<P>();
  const int lane = threadIdx.x % LANES;
  const int row0 = (blockIdx.x * (kThreads / LANES) + threadIdx.x / LANES)
                   * rows_per_group;
  if (row0 >= n_rows) return;
  const unsigned mask = group_mask<LANES>();
  const int nr = min(rows_per_group, n_rows - row0);
  const int first = lane <= nr ? recv_ptr[row0 + lane] : 0;
  const int e_end = __shfl_sync(mask, first, nr, LANES);
  const int width = SQ ? 2 * d : d;

  // the grid's y blocks take the column tiles of a row in turn
  for (int t0 = blockIdx.y * TW; t0 < d; t0 += gridDim.y * TW) {
    const int tc = min(TW, d - t0);
    float bias[P];
    tile_load<V, NG, LANES>(b1 + t0, tc, lane, bias);
    int cb = INT_MIN / 2, s_own = 0;   // the send chunk the lanes hold
    for (int r = 0; r < nr; ++r) {
      const int row = row0 + r;
      const int e0 = __shfl_sync(mask, first, r, LANES);
      const int e1 = __shfl_sync(mask, first, r + 1, LANES);
      float acc[P], acc2[P];
      tile_zero(acc);
      tile_zero(acc2);
      if (e0 < e1) {  // a row with no edges (padding too) stores zeros
        float a[P];
        if (HAS_A)
          tile_load<V, NG, LANES>(A + (size_t)row * d + t0, tc, lane, a);
        else
          tile_zero(a);
        for (int e = e0; e < e1;) {
          if (e >= cb + LANES) {
            cb = e;
            s_own = cb + lane < e_end ? send[cb + lane] : 0;
          }
          const int nu = min(IF, min(e1 - e, cb + LANES - e));
          Words<T, V> hw[IF][NG], pw[IF][NG];
#pragma unroll
          for (int u = 0; u < IF; ++u) {
            const int s =
                __shfl_sync(mask, s_own, e - cb + min(u, nu - 1), LANES);
            if (u < nu) {
              tile_load_words<V, NG, LANES>(B + (size_t)s * d + t0, tc, lane,
                                            hw[u]);
              if (HAS_PE)
                tile_load_words<V, NG, LANES>(Pe + (size_t)(e + u) * d + t0,
                                              tc, lane, pw[u]);
            }
          }
#pragma unroll
          for (int u = 0; u < IF; ++u) {
            if (u < nu) {
              float h[P], pe[P];
              tile_unpack(hw[u], h);
              if (HAS_PE) tile_unpack(pw[u], pe);
#pragma unroll
              for (int i = 0; i < P; ++i) {
                // the reference's order: B[send] + A[recv] + Pe + b1
                float x = h[i];
                if (HAS_A) x += a[i];
                if (HAS_PE) x += pe[i];
                x += bias[i];
                if (ACT == kRelu) x = fmaxf(x, 0.f);
                if (SQ) {
                  acc[i] += x;
                  acc2[i] += x * x;
                } else {
                  acc[i] += round_to<T>(x);  // a bf16 message is rounded
                }
              }
            }
          }
          e += nu;
        }
      }
      SqT<T, ACT>* o = out + (size_t)row * width + t0;
      tile_store<V, NG, LANES>(o, tc, lane, acc);
      if (SQ) tile_store<V, NG, LANES>(o + d, tc, lane, acc2);
    }
  }
}

// K2.  The same walk as K1: a group of LANES lanes takes rows_per_group
// consecutive receiver rows, each once.  A row loads its g tile (and
// g2's in id_sq), A's and the bias once; then the sender and Pe words of
// up to edges_in_flight<P>() edges issue before any is unpacked, and each
// edge stores its dH tile and adds it to dA's sum, which is stored once
// at the row's end.  Identity mode reads no A, B, Pe or b1: each edge
// stores g's tile.
template <typename T, int V, int NG, int LANES, int ACT, bool HAS_A,
          bool HAS_PE>
__global__ void __launch_bounds__(kThreads)
edge_message_bwd_recv_kernel(const T* __restrict__ A,
                             const T* __restrict__ B,
                             const T* __restrict__ Pe,
                             const float* __restrict__ b1,
                             const SqT<T, ACT>* __restrict__ g,
                             const int32_t* __restrict__ recv_ptr,
                             const int32_t* __restrict__ send,
                             SqT<T, ACT>* __restrict__ dH,
                             T* __restrict__ dA, int n_rows, int d,
                             int rows_per_group) {
  constexpr bool SQ = ACT == kIdSq;
  constexpr bool RECOMPUTE = ACT != kIdentity;  // does dH need H
  constexpr int P = NG * V;          // columns a lane holds
  constexpr int TW = LANES * P;      // columns a tile spans
  constexpr int IF = edges_in_flight<P>();
  const int lane = threadIdx.x % LANES;
  const int row0 = (blockIdx.x * (kThreads / LANES) + threadIdx.x / LANES)
                   * rows_per_group;
  if (row0 >= n_rows) return;
  const unsigned mask = group_mask<LANES>();
  const int nr = min(rows_per_group, n_rows - row0);
  const int first = lane <= nr ? recv_ptr[row0 + lane] : 0;
  const int e_end = __shfl_sync(mask, first, nr, LANES);
  const int gw = SQ ? 2 * d : d;     // g's row

  for (int t0 = blockIdx.y * TW; t0 < d; t0 += gridDim.y * TW) {
    const int tc = min(TW, d - t0);
    float bias[P];
    if (RECOMPUTE)
      tile_load<V, NG, LANES>(b1 + t0, tc, lane, bias);
    else
      tile_zero(bias);
    int cb = INT_MIN / 2, s_own = 0;   // the send chunk the lanes hold
    for (int r = 0; r < nr; ++r) {
      const int row = row0 + r;
      const int e0 = __shfl_sync(mask, first, r, LANES);
      const int e1 = __shfl_sync(mask, first, r + 1, LANES);
      float acc[P];
      tile_zero(acc);
      // a row with no edges reads nothing and stores dA's zeros
      if (e0 < e1) {
        if constexpr (!RECOMPUTE) {  // dH is g's row
          float gv[P];
          tile_load<V, NG, LANES>(g + (size_t)row * gw + t0, tc, lane, gv);
          for (int e = e0; e < e1; ++e) {
            tile_store<V, NG, LANES>(dH + (size_t)e * d + t0, tc, lane, gv);
#pragma unroll
            for (int i = 0; i < P; ++i) acc[i] += gv[i];
          }
        } else {
          float gv[P], g2[P], a[P];
          const SqT<T, ACT>* gr = g + (size_t)row * gw + t0;
          tile_load<V, NG, LANES>(gr, tc, lane, gv);
          if (SQ)
            tile_load<V, NG, LANES>(gr + d, tc, lane, g2);
          else
            tile_zero(g2);
          if (HAS_A)
            tile_load<V, NG, LANES>(A + (size_t)row * d + t0, tc, lane, a);
          else
            tile_zero(a);
          for (int e = e0; e < e1;) {
            if (e >= cb + LANES) {
              cb = e;
              s_own = cb + lane < e_end ? send[cb + lane] : 0;
            }
            const int nu = min(IF, min(e1 - e, cb + LANES - e));
            Words<T, V> hw[IF][NG], pw[IF][NG];
#pragma unroll
            for (int u = 0; u < IF; ++u) {
              const int s =
                  __shfl_sync(mask, s_own, e - cb + min(u, nu - 1), LANES);
              if (u < nu) {
                tile_load_words<V, NG, LANES>(B + (size_t)s * d + t0, tc, lane,
                                              hw[u]);
                if (HAS_PE)
                  tile_load_words<V, NG, LANES>(Pe + (size_t)(e + u) * d + t0,
                                                tc, lane, pw[u]);
              }
            }
#pragma unroll
            for (int u = 0; u < IF; ++u) {
              if (u < nu) {
                float h[P], pe[P], dh[P];
                tile_unpack(hw[u], h);
                if (HAS_PE) tile_unpack(pw[u], pe);
#pragma unroll
                for (int i = 0; i < P; ++i) {
                  // the reference's order: B[send] + A[recv] + Pe + b1
                  float x = h[i];
                  if (HAS_A) x += a[i];
                  if (HAS_PE) x += pe[i];
                  x += bias[i];
                  dh[i] = SQ ? gv[i] + 2.f * x * g2[i]
                             : (x > 0.f ? gv[i] : 0.f);
                  acc[i] += dh[i];
                }
                tile_store<V, NG, LANES>(dH + (size_t)(e + u) * d + t0, tc,
                                         lane, dh);
              }
            }
            e += nu;
          }
        }
      }
      if (HAS_A)
        tile_store<V, NG, LANES>(dA + (size_t)row * d + t0, tc, lane, acc);
    }
  }
}

// Run f with the activation code as a compile-time constant.
template <typename F>
void act_switch(int act, F&& f) {
  if (act == kRelu) f(std::integral_constant<int, kRelu>());
  else if (act == kIdSq) f(std::integral_constant<int, kIdSq>());
  else f(std::integral_constant<int, kIdentity>());
}

// Receiver rows a group of K1 or K2 walks: kRowsPerGroup when the rows leave
// at least a warp's worth of groups for each of the card's SMs at that
// many a group (a batch of 1024 graphs), fewer otherwise, so a small
// batch (128 graphs at d=150) still spreads over the card.
constexpr int kRowsPerGroup = 4;
inline int group_rows(int n_rows) {
  static const int fill = [] {
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms * kWarp;
  }();
  int rpg = kRowsPerGroup;
  while (rpg > 1 && n_rows < rpg * fill) rpg /= 2;
  return rpg;
}

// The column tiles of a row of d elements at tw a tile: the grid's y
// extent, so each tile of a wide row (d=689 is eight tiles of one element
// a lane) walks the row's edges in a block of its own rather than after
// the tile before it.  The tiles share no sums, so the bits are the same.
inline int column_tiles(int d, int tw) { return (d + tw - 1) / tw; }

template <typename T>
int launch_fwd(const T* A, const T* B, const T* Pe, const float* b1,
               const int32_t* recv_ptr, const int32_t* send, void* out,
               int n_rows, int d, int act, int has_a, int has_pe,
               void* stream) {
  if (act < kIdentity || act > kIdSq)
    return static_cast<int>(cudaErrorInvalidValue);
  const int t = sizeof(T);
  int vec = tile_vec_width<T>(d, {{A, t}, {B, t}, {Pe, t}, {b1, 4},
                                  {out, act == kIdSq ? 4 : t}});
  // The moments pass stores 2 f32 a data element: at 8 bf16 a lane (a
  // half warp a row) each lane stores 32 bytes of each moment in two
  // 16-byte halves, and it measured 1.5-1.7x slower than at 4 a lane (a
  // warp a row, 512 contiguous bytes a store; PERF.md, section 6).
  if (act == kIdSq && vec == 8) vec = 4;
  const int rpg = group_rows(n_rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  tile_switch<T>(vec, d, [&](auto v, auto ng, auto l) {
    constexpr int V = decltype(v)::value, NG = decltype(ng)::value;
    constexpr int LANES = decltype(l)::value;
    const dim3 grid(row_blocks((n_rows + rpg - 1) / rpg, LANES),
                    column_tiles(d, LANES * NG * V));
    act_switch(act, [&](auto ac) {
      constexpr int ACT = decltype(ac)::value;
      GSN_BOOL_SWITCH(has_a, HA, [&] {
        GSN_BOOL_SWITCH(has_pe, HP, [&] {
          edge_message_fwd_kernel<T, V, NG, LANES, ACT, HA, HP>
              <<<grid, kThreads, 0, st>>>(
                  A, B, Pe, b1, recv_ptr, send,
                  static_cast<SqT<T, ACT>*>(out), n_rows, d, rpg);
        });
      });
    });
  });
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_recv(const T* A, const T* B, const T* Pe, const float* b1,
                    const void* g, const int32_t* recv_ptr,
                    const int32_t* send, void* dH, T* dA, int n_rows, int d,
                    int act, int has_a, int has_pe, void* stream) {
  if (act < kIdentity || act > kIdSq)
    return static_cast<int>(cudaErrorInvalidValue);
  const int t = sizeof(T);
  const int tg = act == kIdSq ? 4 : t;
  int vec = tile_vec_width<T>(d, {{A, t}, {B, t}, {Pe, t}, {b1, 4},
                                  {g, tg}, {dH, tg}, {dA, t}});
  // id_sq's f32 dH: 8 bf16 a lane (a half warp a row) store each edge's
  // 32 bytes a lane in two 16-byte halves, as K1's moments; at 4 a lane
  // (a warp a row) it measured 0.90x (PERF.md, section 6).
  if (act == kIdSq && vec == 8) vec = 4;
  const int rpg = group_rows(n_rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  tile_switch<T>(vec, d, [&](auto v, auto ng, auto l) {
    constexpr int V = decltype(v)::value, NG = decltype(ng)::value;
    constexpr int LANES = decltype(l)::value;
    const dim3 grid(row_blocks((n_rows + rpg - 1) / rpg, LANES),
                    column_tiles(d, LANES * NG * V));
    act_switch(act, [&](auto ac) {
      constexpr int ACT = decltype(ac)::value;
      GSN_BOOL_SWITCH(has_a, HA, [&] {
        GSN_BOOL_SWITCH(has_pe, HP, [&] {
          edge_message_bwd_recv_kernel<T, V, NG, LANES, ACT, HA, HP>
              <<<grid, kThreads, 0, st>>>(
                  A, B, Pe, b1, static_cast<const SqT<T, ACT>*>(g),
                  recv_ptr, send, static_cast<SqT<T, ACT>*>(dH), dA,
                  n_rows, d, rpg);
        });
      });
    });
  });
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gsn

// act: 0 identity, 1 relu, 2 id_sq (out [n_rows, 2d], g [n_rows, 2d] and
// dH f32 in every data type)
extern "C" int gsn_edge_message_fwd(const float* A, const float* B,
                                    const float* Pe, const float* b1,
                                    const int32_t* recv_ptr,
                                    const int32_t* send, float* out,
                                    int n_rows, int d, int act, int has_a,
                                    int has_pe, void* stream) {
  return gsn::launch_fwd(A, B, Pe, b1, recv_ptr, send, out, n_rows, d, act,
                         has_a, has_pe, stream);
}

extern "C" int gsn_edge_message_bwd_recv(const float* A, const float* B,
                                         const float* Pe, const float* b1,
                                         const float* g,
                                         const int32_t* recv_ptr,
                                         const int32_t* send, float* dH,
                                         float* dA, int n_rows, int d,
                                         int act, int has_a, int has_pe,
                                         void* stream) {
  return gsn::launch_bwd_recv(A, B, Pe, b1, g, recv_ptr, send, dH, dA,
                              n_rows, d, act, has_a, has_pe, stream);
}

// bf16 A, B, Pe and out (f32 b1; f32 out in id_sq), same arguments
// otherwise
extern "C" int gsn_edge_message_fwd_bf16(const void* A, const void* B,
                                         const void* Pe, const float* b1,
                                         const int32_t* recv_ptr,
                                         const int32_t* send, void* out,
                                         int n_rows, int d, int act,
                                         int has_a, int has_pe,
                                         void* stream) {
  using gsn::bf16;
  return gsn::launch_fwd(static_cast<const bf16*>(A),
                         static_cast<const bf16*>(B),
                         static_cast<const bf16*>(Pe), b1, recv_ptr, send,
                         out, n_rows, d, act, has_a, has_pe, stream);
}

// bf16 A, B, Pe, g, dH and dA (f32 b1; f32 g and dH in id_sq), same
// arguments otherwise
extern "C" int gsn_edge_message_bwd_recv_bf16(
    const void* A, const void* B, const void* Pe, const float* b1,
    const void* g, const int32_t* recv_ptr, const int32_t* send, void* dH,
    void* dA, int n_rows, int d, int act, int has_a, int has_pe,
    void* stream) {
  using gsn::bf16;
  return gsn::launch_bwd_recv(
      static_cast<const bf16*>(A), static_cast<const bf16*>(B),
      static_cast<const bf16*>(Pe), b1, g, recv_ptr, send, dH,
      static_cast<bf16*>(dA), n_rows, d, act, has_a, has_pe, stream);
}
