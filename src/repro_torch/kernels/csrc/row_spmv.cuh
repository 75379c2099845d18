// The row-group SpMV that K4 (pack_spmv/csrc/pack_spmv.cu) and K1
// (csr_spmv/csrc/csr_spmv.cu) share, written by hand for Hopper (sm_90a).
//
// For every row r of one (rows, width) plane it computes
//
//   y[r] = sum over lanes c < n(r) of x[idx[r, c]] (* w[r, c])
//
// where n(r) is deg[r] clipped to [0, width], or the whole width when there
// is no degree vector (deg == nullptr: K1's deg=None path reads every lane,
// padding included).  The weight, when there is one, is multiplicative.
//
// What bounds it on the H100: bytes, and the latency of the dependent
// id -> x[id] gather.  One multiply-add per lane against a read of the id
// (and weight) and a gather of x: far below the card's float32 rate.
//
// What the design does about it:
//  * a group of G lanes owns one row and strides its lanes, so neighbouring
//    lanes read neighbouring plane addresses (coalesced 128-byte lines) and
//    a row with a degree vector stops at deg[r], never reading its padding;
//  * G = 8 / 16 / 32 lanes for narrow planes (several rows per block, a
//    fixed shuffle tree), sized by the caller to the longest row walked;
//  * each thread keeps UNROLL lanes' loads in flight before it sums them
//    (walk()), so a thread that walks several lanes waits once per UNROLL
//    lanes for the gather, not once per lane; the callers take UNROLL = 8
//    where a thread walks more than 4 lanes and 1 below, where the warps
//    keep the gathers in flight and a batch's registers would only cost
//    occupancy;
//  * rows wider than 1,024 lanes are split into segments of a few thousand
//    lanes, one 256-thread block each, and a second launch folds each row's
//    partials in order (launch_split), so the longest rows stop setting the
//    group's tail;
//  * each lane sums its lanes in order and the group reduces in a fixed
//    order (shuffles, then the eight warp partials in index order), so sums
//    come out the same from run to run, with no float atomics;
//  * x is gathered through the read-only path.
//
// Ids are read at their stored type (a template parameter).  An id outside
// x traps: a malformed plane is never a silent read.  Each including source
// defines its own extern "C" entry; the build key (kernels/_build.py)
// hashes this directory too, so an edit here rebuilds both libraries.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace row_spmv {

constexpr int kThreads = 256;

// Sum of v over the G lanes of a row group, in a fixed order.  For G <= 32
// the result is in the group's first lane; for G == kThreads (one row per
// block) it is in thread 0.  Every thread of the block must call it.
template <int G>
__device__ __forceinline__ float group_sum(float v) {
  if constexpr (G <= 32) {
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off, G);
    }
    return v;
  } else {
    static_assert(G == kThreads, "a wide group is the whole block");
    __shared__ float part[kThreads / 32];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
    __syncthreads();
    float s = 0.0f;
    if (threadIdx.x == 0) {
#pragma unroll
      for (int i = 0; i < kThreads / 32; ++i) s += part[i];
    }
    return s;
  }
}

// Sum over the lanes c0, c0 + stride, ... < end of one row (plane offset
// `base`), UNROLL lanes at a time: their ids and weights are loaded, then
// their x[id], and only then summed, in lane order, with explicit fused
// multiply-adds, so the per-thread order and the rounding do not depend on
// where a batch ends.  Ids are held in 32 bits (each is < V < 2^31; a
// negative int32 id wraps past V and traps).
template <typename IdT, bool WEIGHTED, int UNROLL>
__device__ __forceinline__ float walk(const float* __restrict__ x,
                                      const IdT* __restrict__ idx,
                                      const float* __restrict__ w,
                                      int64_t base, int64_t c0, int64_t end,
                                      int stride, int64_t num_vertices) {
  float acc = 0.0f;
  for (int64_t c = c0; c < end; c += static_cast<int64_t>(UNROLL) * stride) {
    uint32_t j[UNROLL];
    float wv[UNROLL];
    bool bad = false;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t cu = c + static_cast<int64_t>(u) * stride;
      j[u] = 0;
      wv[u] = 1.0f;
      if (cu < end) {
        j[u] = static_cast<uint32_t>(idx[base + cu]);
        if constexpr (WEIGHTED) wv[u] = w[base + cu];
      }
      bad |= j[u] >= static_cast<uint64_t>(num_vertices);
    }
    if (bad) __trap();
    float xv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      xv[u] = c + static_cast<int64_t>(u) * stride < end ? __ldg(x + j[u])
                                                          : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (c + static_cast<int64_t>(u) * stride < end) {
        acc = WEIGHTED ? __fmaf_rn(xv[u], wv[u], acc) : __fadd_rn(acc, xv[u]);
      }
    }
  }
  return acc;
}

// x[0] * 0 for a row with padding: lanes >= deg are (id 0, weight 0), so
// each term the walk skips is x[0] * 0, and one of them has their sum's
// value and zero sign (and is NaN when x[0] is not finite, as every padded
// lane is).
__device__ __forceinline__ float pad_term(const float* __restrict__ x,
                                          float acc, int64_t d,
                                          int64_t width) {
  return d < width ? __fadd_rn(acc, __fmul_rn(__ldg(x), 0.0f)) : acc;
}

// One row per group of G lanes, UNROLL lanes in flight per thread
// (walk()); PAD_TERM (K1) adds pad_term() to each row.
template <typename IdT, bool WEIGHTED, int G, int UNROLL, bool PAD_TERM>
__global__ void __launch_bounds__(kThreads)
kernel(const float* __restrict__ x, const IdT* __restrict__ idx,
       const int32_t* __restrict__ deg, const float* __restrict__ w,
       float* __restrict__ y, int64_t rows, int64_t width,
       int64_t num_vertices) {
  static_assert(UNROLL >= 1, "a thread keeps at least one lane in flight");
  const int sub = threadIdx.x % G;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (kThreads / G) + threadIdx.x / G;
  // Rows past the end still take part in the group reduction, with no lanes.
  const bool live = row < rows;
  int64_t d = 0;
  if (live) {
    d = deg == nullptr ? width : deg[row];
    d = d < 0 ? 0 : (d > width ? width : d);
  }
  float acc = walk<IdT, WEIGHTED, UNROLL>(x, idx, w, row * width, sub, d, G,
                                          num_vertices);
  acc = group_sum<G>(acc);
  if (live && sub == 0) {
    if constexpr (PAD_TERM) acc = pad_term(x, acc, d, width);
    y[row] = acc;
  }
}

// The row split (the wide groups of K1 and K4), in two launches.
// segment_kernel: block b walks one segment of one row, a 256-thread group
// over its lanes, and writes the segment's sum to partial[b].  The segments
// are segs[b] = (row, lane_begin, lane_end), sorted by row, each row's in
// lane order from lane 0 (a degree walk); or, with segs == nullptr, every
// row's [0, width) cut into per_row pieces of `chunk` lanes (K1's
// every-lane path).  Both cut
// at multiples of `chunk`, so the two paths sum the same lanes in the same
// order and agree bit for bit wherever the padding adds only zeros.
template <typename IdT, bool WEIGHTED, int UNROLL>
__global__ void __launch_bounds__(kThreads)
segment_kernel(const float* __restrict__ x, const IdT* __restrict__ idx,
               const int32_t* __restrict__ deg, const float* __restrict__ w,
               const int32_t* __restrict__ segs, int64_t per_row,
               int64_t chunk, float* __restrict__ partial, int64_t rows,
               int64_t width, int64_t num_vertices) {
  int64_t row, lo, hi;
  if (segs != nullptr) {
    const int32_t* s = segs + 3 * static_cast<int64_t>(blockIdx.x);
    row = s[0];
    lo = s[1] < 0 ? 0 : s[1];
    hi = s[2];
    if (row < 0 || row >= rows) {
      __trap();  // a segment outside the plane: a malformed list
    }
  } else {
    row = blockIdx.x / per_row;
    lo = (blockIdx.x - row * per_row) * chunk;
    hi = lo + chunk;
  }
  int64_t d = deg == nullptr ? width : deg[row];
  d = d < 0 ? 0 : (d > width ? width : d);
  hi = hi < d ? hi : d;
  float acc = walk<IdT, WEIGHTED, UNROLL>(x, idx, w, row * width,
                                          lo + threadIdx.x, hi, kThreads,
                                          num_vertices);
  acc = group_sum<kThreads>(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = acc;
}

// fold_kernel: one thread per row (segs == nullptr: its per_row partials)
// or per segment (the thread of a row's first segment, lane_begin == 0,
// takes the row's partials), summed in segment order, then pad_term().
template <bool PAD_TERM>
__global__ void __launch_bounds__(kThreads)
fold_kernel(const float* __restrict__ x, const int32_t* __restrict__ deg,
            const int32_t* __restrict__ segs, int64_t num_segs,
            int64_t per_row, const float* __restrict__ partial,
            float* __restrict__ y, int64_t rows, int64_t width) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int64_t row, q, q_end;
  if (segs == nullptr) {
    if (t >= rows) return;
    row = t;
    q = t * per_row;
    q_end = q + per_row;
  } else {
    if (t >= num_segs || segs[3 * t + 1] != 0) return;
    row = segs[3 * t];
    q = t;
    for (q_end = t + 1; q_end < num_segs && segs[3 * q_end] == row; ++q_end) {
    }
  }
  float acc = 0.0f;
  for (; q < q_end; ++q) acc = __fadd_rn(acc, partial[q]);
  int64_t d = deg == nullptr ? width : deg[row];
  d = d < 0 ? 0 : (d > width ? width : d);
  if constexpr (PAD_TERM) acc = pad_term(x, acc, d, width);
  y[row] = acc;
}

template <typename IdT, bool WEIGHTED, int G, int UNROLL, bool PAD_TERM>
cudaError_t launch_group(const void* x, const void* idx, const void* deg,
                         const void* w, void* y, int64_t rows, int64_t width,
                         int64_t num_vertices, cudaStream_t stream) {
  constexpr int kRowsPerBlock = kThreads / G;
  const unsigned blocks =
      static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  kernel<IdT, WEIGHTED, G, UNROLL, PAD_TERM><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const IdT*>(idx),
      static_cast<const int32_t*>(deg), static_cast<const float*>(w),
      static_cast<float*>(y), rows, width, num_vertices);
  return cudaGetLastError();
}

// group: lanes per row, 8, 16, 32 or 256.  deg may be null (every lane of
// the row); w must be non-null when WEIGHTED.  Launches on `stream`,
// allocates nothing, and returns cudaGetLastError() after the launch.
template <typename IdT, bool WEIGHTED, int UNROLL, bool PAD_TERM>
cudaError_t launch(int group, const void* x, const void* idx,
                   const void* deg, const void* w, void* y, int64_t rows,
                   int64_t width, int64_t num_vertices, cudaStream_t stream) {
  if (rows < 0 || width < 1) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  switch (group) {
    case 8:
      return launch_group<IdT, WEIGHTED, 8, UNROLL, PAD_TERM>(
          x, idx, deg, w, y, rows, width, num_vertices, stream);
    case 16:
      return launch_group<IdT, WEIGHTED, 16, UNROLL, PAD_TERM>(
          x, idx, deg, w, y, rows, width, num_vertices, stream);
    case 32:
      return launch_group<IdT, WEIGHTED, 32, UNROLL, PAD_TERM>(
          x, idx, deg, w, y, rows, width, num_vertices, stream);
    case kThreads:
      return launch_group<IdT, WEIGHTED, kThreads, UNROLL, PAD_TERM>(
          x, idx, deg, w, y, rows, width, num_vertices, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The row split: segment_kernel over num_segs segments (or rows * per_row
// implied ones when segs is null), then fold_kernel.  partial is float
// scratch of one value per segment.  Launches on `stream`, allocates
// nothing, and returns the first launch error.
template <typename IdT, bool WEIGHTED, int UNROLL, bool PAD_TERM>
cudaError_t launch_split(const void* x, const void* idx, const void* deg,
                         const void* w, const void* segs, int64_t num_segs,
                         int64_t chunk, void* partial, void* y, int64_t rows,
                         int64_t width, int64_t num_vertices,
                         cudaStream_t stream) {
  if (rows < 0 || width < 1 || chunk < 1 || num_segs < 0) {
    return cudaErrorInvalidValue;
  }
  const int64_t per_row = (width + chunk - 1) / chunk;
  const int64_t blocks = segs == nullptr ? rows * per_row : num_segs;
  if (rows == 0 || blocks == 0) return cudaSuccess;
  segment_kernel<IdT, WEIGHTED, UNROLL>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          static_cast<const float*>(x), static_cast<const IdT*>(idx),
          static_cast<const int32_t*>(deg), static_cast<const float*>(w),
          static_cast<const int32_t*>(segs), per_row, chunk,
          static_cast<float*>(partial), rows, width, num_vertices);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t threads = segs == nullptr ? rows : num_segs;
  fold_kernel<PAD_TERM>
      <<<static_cast<unsigned>((threads + kThreads - 1) / kThreads), kThreads,
         0, stream>>>(static_cast<const float*>(x),
                      static_cast<const int32_t*>(deg),
                      static_cast<const int32_t*>(segs), num_segs, per_row,
                      static_cast<const float*>(partial),
                      static_cast<float*>(y), rows, width);
  return cudaGetLastError();
}

}  // namespace row_spmv
