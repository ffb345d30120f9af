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
// K4 copies bits, so it is written over elements of ES bytes: 4 for f32
// rows, 2 for bf16 rows (the reference's bf16 mode, slab_pool.py:163-181
// and 228-234).  One template serves both; E = 16 / ES elements make a
// 16-byte vector (4 f32, 8 bf16), held as four 32-bit registers (a bf16
// piece of 2 bytes goes into its half of one), and any width d works,
// odd ones included.
//
// Bound: bytes (one read of each segment row, one write of each output
// row; no arithmetic beyond the search).  Each segment's output is one
// contiguous range that repeats g[k], and the rows outside every segment
// are contiguous ranges of zeros, so K4 is a streaming write of out from
// a source that stays in L2.  The design serves that stream:
//
// - out is one flat array of 16-byte vectors, and each block owns a
//   chunk of kChunk consecutive vectors (8 KB), whatever the row width;
// - two warps find, by a 32-ary search over ptr (one probe a lane,
//   log32(n_seg) dependent loads), how many offsets lie at or below the
//   chunk's first and last rows; each of the chunk's rows then finds its
//   segment among the few offsets between those two counts (in L1 after
//   the search) and writes it to a table in shared memory (-1 outside
//   every segment), so the block pays for one search, not one per row;
// - every thread loads kUnroll vectors, then stores them, a warp 512
//   contiguous bytes a store, so d=70 and d=300 store as densely as
//   d=128.  A vector of out may straddle rows; it takes one 16-byte load
//   of g when rows are whole vectors (d % E == 0, g 16-byte aligned),
//   else loads of L = E/2, E/4, ... words (the widest that d and g's
//   alignment allow: f32 d=70 takes 2, bf16 d=300 takes 4), each from its
//   own (segment, column) through L1.  Only the vector that runs past
//   the end of out is stored word by word; out itself must be 16-byte
//   aligned.
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
constexpr int kChunk = kBlock * kUnroll;  // 16-byte vectors a block writes

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
// chunk of E-word vectors can touch.
inline size_t segment_table_bytes(int d, int E) {
  return static_cast<size_t>((E * kChunk - 1) / d + 2) * sizeof(int);
}

template <int ES, int L>
__global__ void __launch_bounds__(kBlock, kBlocksPerSm)
segment_broadcast_kernel(const unsigned char* __restrict__ g,
                         const int32_t* __restrict__ ptr, int n_seg,
                         unsigned char* __restrict__ out, long long total,
                         int d, int step_r, int step_c) {
  constexpr int E = 16 / ES;  // elements in a 16-byte vector
  constexpr int LB = L * ES;  // bytes a load of g takes
  extern __shared__ int seg_of[];  // by row, relative to the first row
  // first row, its column at the chunk's start, last row, and the
  // offsets at or below the first and the last row
  __shared__ int info[5];
  const int t = threadIdx.x, lane = t & (kWarp - 1), warp = t >> 5;
  const long long f0 = static_cast<long long>(blockIdx.x) * (E * kChunk);
  const long long f1 = min(f0 + E * kChunk, total);  // the chunk's elements
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

  // the thread's elements start at f0 + E t and advance E * kBlock a
  // step (step_r rows and step_c columns); rows relative to r0.  A
  // vector of out takes E / L loads of L elements, each from its own
  // row's segment (d % L == 0, so a load never straddles rows); every
  // index into v is a constant, so v stays in registers.
  int r = (info[1] + E * t) / d;
  int c = info[1] + E * t - r * d;
  uint32_t v[kUnroll][4];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long f = f0 + E * t + static_cast<long long>(u) * E * kBlock;
    int re = r, ce = c;
#pragma unroll
    for (int w = 0; w < 4; ++w) v[u][w] = 0u;
#pragma unroll
    for (int i = 0; i < E; i += L) {
      if (i > 0 && (ce += L) == d) {
        ce = 0;
        ++re;
      }
      const int k = f + i < f1 ? seg_of[re] : -1;
      if (k < 0) continue;
      const unsigned char* src = g + (static_cast<size_t>(k) * d + ce) * ES;
      const int w = i * ES / 4;  // the first register the piece fills
      if constexpr (LB == 16) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(src));
        v[u][0] = x.x; v[u][1] = x.y; v[u][2] = x.z; v[u][3] = x.w;
      } else if constexpr (LB == 8) {
        const uint2 x = __ldg(reinterpret_cast<const uint2*>(src));
        v[u][w] = x.x; v[u][w + 1] = x.y;
      } else if constexpr (LB == 4) {
        v[u][w] = __ldg(reinterpret_cast<const unsigned int*>(src));
      } else {  // a 2-byte element into its half of a register
        v[u][w] |= static_cast<uint32_t>(
            __ldg(reinterpret_cast<const unsigned short*>(src)))
            << (16 * (i & 1));
      }
    }
    c += step_c;
    r += step_r;
    if (c >= d) {
      c -= d;
      ++r;
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long f = f0 + E * t + static_cast<long long>(u) * E * kBlock;
    if (f + E <= f1) {
      *reinterpret_cast<uint4*>(out + f * ES) =
          make_uint4(v[u][0], v[u][1], v[u][2], v[u][3]);
    } else if (f < f1) {
#pragma unroll
      for (int i = 0; i < E; ++i) {
        if (f + i >= f1) continue;
        if constexpr (ES == 4) {
          reinterpret_cast<uint32_t*>(out)[f + i] = v[u][i];
        } else {
          reinterpret_cast<uint16_t*>(out)[f + i] =
              static_cast<uint16_t>(v[u][i / 2] >> (16 * (i & 1)));
        }
      }
    }
  }
}

using SegmentBroadcastKernel = void (*)(const unsigned char*,
                                        const int32_t*, int,
                                        unsigned char*, long long, int, int,
                                        int);

template <int ES>
SegmentBroadcastKernel segment_broadcast_kernel_for(int load) {
  if constexpr (ES == 2) {
    if (load == 8) return segment_broadcast_kernel<ES, 8>;
  }
  return load == 4   ? segment_broadcast_kernel<ES, 4>
         : load == 2 ? segment_broadcast_kernel<ES, 2>
                     : segment_broadcast_kernel<ES, 1>;
}

// Elements a load of g takes: the widest L dividing 16 / ES for which
// rows are whole L-element pieces (d % L == 0) and g is aligned to L
// elements.
template <int ES>
int segment_broadcast_load(const void* g, int d) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(g);
  for (int L = 16 / ES; L > 1; L /= 2)
    if (d % L == 0 && a % (L * ES) == 0) return L;
  return 1;
}

template <int ES>
int launch_segment_broadcast(const void* g, const int32_t* ptr, int n_seg,
                             void* out, int n_rows, int d, void* stream) {
  constexpr int E = 16 / ES;
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const long long total = static_cast<long long>(n_rows) * d;
  const long long n_vec = (total + E - 1) / E;
  const dim3 grid(static_cast<unsigned>((n_vec + kChunk - 1) / kChunk));
  const int step = E * kBlock;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto kernel = segment_broadcast_kernel_for<ES>(
      segment_broadcast_load<ES>(g, d));
  kernel<<<grid, kBlock, segment_table_bytes(d, E), st>>>(
      static_cast<const unsigned char*>(g), ptr, n_seg,
      static_cast<unsigned char*>(out), total, d, step / d, step % d);
  return static_cast<int>(cudaGetLastError());
}

template <int ES>
int segment_broadcast_occupancy(int d, int load) {
  int blocks = 0;
  const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, segment_broadcast_kernel_for<ES>(load), kBlock,
      segment_table_bytes(d, 16 / ES));
  return rc == cudaSuccess ? blocks : -1;
}

}  // namespace gsn

extern "C" int gsn_segment_broadcast(const float* g, const int32_t* ptr,
                                     int n_seg, float* out, int n_rows,
                                     int d, void* stream) {
  return gsn::launch_segment_broadcast<4>(g, ptr, n_seg, out, n_rows, d,
                                          stream);
}

// bf16 g and out, same arguments otherwise
extern "C" int gsn_segment_broadcast_bf16(const void* g, const int32_t* ptr,
                                          int n_seg, void* out, int n_rows,
                                          int d, void* stream) {
  return gsn::launch_segment_broadcast<2>(g, ptr, n_seg, out, n_rows, d,
                                          stream);
}

// Resident blocks per SM of the f32 instantiation with loads of `load`
// floats (4, 2 or 1) at width d.
extern "C" int gsn_segment_broadcast_occupancy(int d, int load) {
  return gsn::segment_broadcast_occupancy<4>(d, load);
}

// The same for bf16 rows, loads of 8, 4, 2 or 1 elements.
extern "C" int gsn_segment_broadcast_occupancy_bf16(int d, int load) {
  return gsn::segment_broadcast_occupancy<2>(d, load);
}
