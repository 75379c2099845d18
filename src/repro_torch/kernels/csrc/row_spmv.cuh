// The row-group SpMV that K4 (pack_spmv/csrc/pack_spmv.cu) and K1
// (csr_spmv/csrc/csr_spmv.cu) share, written by hand for Hopper (sm_90a).
//
// For every row r of one (rows, width) plane it computes
//
//   y[r] = sum over lanes c < n(r) of x[idx[r, c]] (* w[r, c])
//
// where n(r) is deg[r] clipped to [0, width], or the whole width when there
// is no degree vector (deg == nullptr: K1 reads every lane, padding
// included).  The weight, when there is one, is multiplicative.
//
// What bounds it on the H100: bytes.  One multiply-add per lane against a
// gather of x and a read of the id (and weight): far below the card's
// float32 rate.
//
// What the design does about it:
//  * a group of G lanes owns one row and strides its lanes, so neighbouring
//    lanes read neighbouring plane addresses (coalesced 128-byte lines) and
//    a row with a degree vector stops at deg[r], never reading its padding;
//  * G = 8 / 16 / 32 lanes for narrow planes (several rows per block, a
//    fixed shuffle tree), and G = 256 — a whole block per row — for planes
//    wider than 1,024 lanes, so a hub row of ~10^5 lanes takes ~300 steps
//    per lane instead of ~2,400 in one warp;
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

template <typename IdT, bool WEIGHTED, int G>
__global__ void __launch_bounds__(kThreads)
kernel(const float* __restrict__ x, const IdT* __restrict__ idx,
       const int32_t* __restrict__ deg, const float* __restrict__ w,
       float* __restrict__ y, int64_t rows, int64_t width,
       int64_t num_vertices) {
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
  const int64_t base = row * width;
  float acc = 0.0f;
  for (int64_t c = sub; c < d; c += G) {
    const uint64_t j =
        static_cast<uint64_t>(static_cast<int64_t>(idx[base + c]));
    if (j >= static_cast<uint64_t>(num_vertices)) {
      __trap();
    }
    float v = __ldg(x + j);
    if constexpr (WEIGHTED) v *= w[base + c];
    acc += v;
  }
  acc = group_sum<G>(acc);
  if (live && sub == 0) y[row] = acc;
}

template <typename IdT, bool WEIGHTED, int G>
cudaError_t launch_group(const void* x, const void* idx, const void* deg,
                         const void* w, void* y, int64_t rows, int64_t width,
                         int64_t num_vertices, cudaStream_t stream) {
  constexpr int kRowsPerBlock = kThreads / G;
  const unsigned blocks =
      static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  kernel<IdT, WEIGHTED, G><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const IdT*>(idx),
      static_cast<const int32_t*>(deg), static_cast<const float*>(w),
      static_cast<float*>(y), rows, width, num_vertices);
  return cudaGetLastError();
}

// group: lanes per row, 8, 16, 32 or 256.  deg may be null (every lane of
// the row); w must be non-null when WEIGHTED.  Launches on `stream`,
// allocates nothing, and returns cudaGetLastError() after the launch.
template <typename IdT, bool WEIGHTED>
cudaError_t launch(int group, const void* x, const void* idx,
                   const void* deg, const void* w, void* y, int64_t rows,
                   int64_t width, int64_t num_vertices, cudaStream_t stream) {
  if (rows < 0 || width < 1) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  switch (group) {
    case 8:
      return launch_group<IdT, WEIGHTED, 8>(x, idx, deg, w, y, rows, width,
                                            num_vertices, stream);
    case 16:
      return launch_group<IdT, WEIGHTED, 16>(x, idx, deg, w, y, rows, width,
                                             num_vertices, stream);
    case 32:
      return launch_group<IdT, WEIGHTED, 32>(x, idx, deg, w, y, rows, width,
                                             num_vertices, stream);
    case kThreads:
      return launch_group<IdT, WEIGHTED, kThreads>(x, idx, deg, w, y, rows,
                                                   width, num_vertices,
                                                   stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace row_spmv
