// K4 segment_broadcast: out[v] = g[k] for every row v in segment k
// (ptr[k] <= v < ptr[k+1]), and 0 on rows outside every segment.
//
// Replaces gsn_tpu/ops/pallas/slab_pool.py: _pool_bwd_kernel, the
// backward of slab_add_pool (dx = g[batch], 0 on padding nodes); the
// same graph->node gather is slab_graph_broadcast's forward (B4, the
// virtual node's broadcast), which launches it too.  The TPU kernel
// built a graph one-hot per node chunk and multiplied.  Every output row
// is written, padding rows with zeros, so the caller needs no zero fill.
//
// Bound: bytes (one read of each segment row, one write of each output
// row; no arithmetic beyond the search).  Each segment's output is one
// contiguous range that repeats g[k], and the rows outside every segment
// are contiguous ranges of zeros, so K4 is a streaming write of out from
// a source that stays in L2.  The design serves that stream:
//
// - out is one flat array of float4s, and each block owns a chunk of
//   kChunk consecutive float4s (8 KB), whatever the row width;
// - two warps find, by a 32-ary search over ptr (one probe a lane,
//   log32(n_seg) dependent loads), how many offsets lie at or below the
//   chunk's first and last rows; each of the chunk's rows then finds its
//   segment among the few offsets between those two counts (in L1 after
//   the search) and writes it to a table in shared memory (-1 outside
//   every segment), so the block pays for one search, not one per row;
// - every thread loads kUnroll float4s, then stores them, a warp 512
//   contiguous bytes a store, so d=70 and d=300 store as densely as
//   d=128.  A float4 of out may straddle rows; it takes one float4 of g
//   when rows are whole float4s (d % 4 == 0, g 16-byte aligned), two
//   float2s when they are whole float2s (d=70), else four floats, each
//   from its own (segment, column) through L1.  Only the float4 that
//   runs past the end of out is stored element by element; out itself
//   must be 16-byte aligned.
// Plain stores: streaming (evict-first) stores were faster only in a
// loop of isolated calls, not inside a training step.
#include <climits>

#include "common.cuh"

namespace gsn {

// 128 threads a block and 16 resident blocks an SM (32 registers a
// thread): on the card, smaller blocks did better than 256 threads at
// every path width, as more chunks are searched and stored at once
constexpr int kBlock = 128;
constexpr int kBlocksPerSm = 16;
constexpr int kUnroll = 4;
constexpr int kChunk = kBlock * kUnroll;  // float4s a block writes

// Entries of the sorted ptr[0, m) that are <= key, by one warp: each
// round every lane probes one entry of the undecided range, and the
// count of probes at or below key narrows it 32-fold.
__device__ __forceinline__ int warp_count_le(const int32_t* __restrict__ ptr,
                                             int m, int key, int lane) {
  int lo = 0, hi = m;  // ptr[i] <= key below lo, > key from hi on
  while (lo < hi) {
    const int s = (hi - lo + kWarp - 1) / kWarp;
    const int i = lo + lane * s;
    const bool le = i < hi && __ldg(ptr + i) <= key;
    const int c = __popc(__ballot_sync(0xffffffffu, le));
    if (c == 0) break;
    hi = min(hi, lo + c * s);
    lo += (c - 1) * s + 1;
  }
  return lo;
}

// Shared-memory bytes of a block at width d: the segment of each row a
// chunk can touch.
inline size_t segment_table_bytes(int d) {
  return static_cast<size_t>((4 * kChunk - 1) / d + 2) * sizeof(int);
}

template <int L>
__global__ void __launch_bounds__(kBlock, kBlocksPerSm)
segment_broadcast_kernel(const float* __restrict__ g,
                         const int32_t* __restrict__ ptr, int n_seg,
                         float* __restrict__ out, long long total, int d,
                         int step_r, int step_c) {
  extern __shared__ int seg_of[];  // by row, relative to the first row
  // first row, its column at the chunk's start, last row, and the
  // offsets at or below the first and the last row
  __shared__ int info[5];
  const int t = threadIdx.x, lane = t & (kWarp - 1), warp = t >> 5;
  const long long f0 = static_cast<long long>(blockIdx.x) * (4 * kChunk);
  const long long f1 = min(f0 + 4 * kChunk, total);  // the chunk's floats
  if (warp < 2) {
    const long long f = warp == 0 ? f0 : f1 - 1;
    // a 64-bit division only where the flat index needs one
    const int r = f <= INT_MAX ? static_cast<unsigned>(f) / d
                               : static_cast<int>(f / d);
    const int c = warp_count_le(ptr, n_seg + 1, r, lane);
    if (lane == 0) {
      info[3 + warp] = c;
      if (warp == 0) {
        info[0] = r;
        info[1] = static_cast<int>(f0 - static_cast<long long>(r) * d);
      } else {
        info[2] = r;
      }
    }
  }
  __syncthreads();
  const int r0 = info[0], c0 = info[3], c1 = info[4];
  // the offsets in [c0, c1) lie above the first row and at or below the
  // last, so each row's count of offsets at or below it is in [c0, c1];
  // the search has just brought them into L1
  for (int j = t; j <= info[2] - r0; j += kBlock) {
    int lo = c0, hi = c1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(ptr + mid) <= r0 + j) lo = mid + 1; else hi = mid;
    }
    seg_of[j] = lo >= 1 && lo <= n_seg ? lo - 1 : -1;
  }
  __syncthreads();

  // the thread's floats start at f0 + 4t and advance 4 * kBlock a step
  // (step_r rows and step_c columns); rows relative to r0.  A float4 of
  // out takes 4 / L loads of L floats, each from its own row's segment
  // (d % L == 0, so a load never straddles rows).
  int r = (info[1] + 4 * t) / d;
  int c = info[1] + 4 * t - r * d;
  float4 v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long f = f0 + 4 * t + static_cast<long long>(u) * 4 * kBlock;
    float e[4];
    int re = r, ce = c;
#pragma unroll
    for (int i = 0; i < 4; i += L) {
      if (i > 0 && (ce += L) == d) {
        ce = 0;
        ++re;
      }
      const int k = f + i < f1 ? seg_of[re] : -1;
      const float* src = g + static_cast<size_t>(k) * d + ce;
      if constexpr (L == 4) {
        const float4 x = k >= 0 ? __ldg(reinterpret_cast<const float4*>(src))
                                : make_float4(0.f, 0.f, 0.f, 0.f);
        e[0] = x.x; e[1] = x.y; e[2] = x.z; e[3] = x.w;
      } else if constexpr (L == 2) {
        const float2 x = k >= 0 ? __ldg(reinterpret_cast<const float2*>(src))
                                : make_float2(0.f, 0.f);
        e[i] = x.x; e[i + 1] = x.y;
      } else {
        e[i] = k >= 0 ? __ldg(src) : 0.f;
      }
    }
    v[u] = make_float4(e[0], e[1], e[2], e[3]);
    c += step_c;
    r += step_r;
    if (c >= d) {
      c -= d;
      ++r;
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long f = f0 + 4 * t + static_cast<long long>(u) * 4 * kBlock;
    if (f + 4 <= f1) {
      *reinterpret_cast<float4*>(out + f) = v[u];
    } else if (f < f1) {
      const float e[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
      for (int i = 0; i < f1 - f; ++i) out[f + i] = e[i];
    }
  }
}

using SegmentBroadcastKernel = void (*)(const float*, const int32_t*, int,
                                       float*, long long, int, int, int);

inline SegmentBroadcastKernel segment_broadcast_kernel_for(int load) {
  return load == 4   ? segment_broadcast_kernel<4>
         : load == 2 ? segment_broadcast_kernel<2>
                     : segment_broadcast_kernel<1>;
}

// Floats a load of g takes: 4 when rows are whole float4s and g is
// 16-byte aligned, else 2 when they are whole float2s, else 1.
inline int segment_broadcast_load(const void* g, int d) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(g);
  return d % 4 == 0 && a % 16 == 0 ? 4 : d % 2 == 0 && a % 8 == 0 ? 2 : 1;
}

}  // namespace gsn

extern "C" int gsn_segment_broadcast(const float* g, const int32_t* ptr,
                                     int n_seg, float* out, int n_rows,
                                     int d, void* stream) {
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const long long total = static_cast<long long>(n_rows) * d;
  const long long n_vec = (total + 3) / 4;
  const dim3 grid(static_cast<unsigned>((n_vec + gsn::kChunk - 1)
                                        / gsn::kChunk));
  const int step = 4 * gsn::kBlock;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto kernel = gsn::segment_broadcast_kernel_for(
      gsn::segment_broadcast_load(g, d));
  kernel<<<grid, gsn::kBlock, gsn::segment_table_bytes(d), st>>>(
      g, ptr, n_seg, out, total, d, step / d, step % d);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of the instantiation with loads of `load`
// floats (4, 2 or 1) at width d.
extern "C" int gsn_segment_broadcast_occupancy(int d, int load) {
  int blocks = 0;
  const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, gsn::segment_broadcast_kernel_for(load), gsn::kBlock,
      gsn::segment_table_bytes(d));
  return rc == cudaSuccess ? blocks : -1;
}
