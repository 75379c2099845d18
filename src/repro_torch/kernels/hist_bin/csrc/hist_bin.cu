// DBG binning (hist_bin), written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel `hist_bin_pallas` in
// src/repro/kernels/hist_bin/hist_bin.py:49 (kernel body `_kernel` :25):
// steps 1-2 of the paper's Listing 1 on the device.  For every vertex v
//
//   groups[v] = the first k with deg[v] >= bounds[k], or 0 when none does
//               (the TPU kernel's argmax over the >= mask)
//   hist[k]   = the number of vertices in group k
//
// with K <= 32 bounds.
//
// What bounds it on the H100: bytes — 4 bytes of degree in and 4 bytes of
// group out per vertex, against at most K compares.
//
// What the design does about it:
//  * one thread per vertex (a grid-stride loop over a bounded grid), reads
//    and writes coalesced;
//  * the bounds sit in shared memory, read by every thread of the block;
//  * the histogram is counted in shared int32 atomics per block, then one
//    global atomic per bin per block.  Integer atomics are exact, so the
//    result does not depend on the order they land in.
//
// The C entry returns cudaGetLastError() after the launch; the launch is on
// the caller's stream, allocates nothing, and ADDS into hist (the caller
// zeroes it).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBins = 32;
constexpr int64_t kMaxBlocks = 132 * 16;  // 16 blocks per SM on an H100

__global__ void __launch_bounds__(kThreads)
hist_bin_kernel(const int32_t* __restrict__ deg,
                const int32_t* __restrict__ bounds, int k,
                int32_t* __restrict__ groups, int32_t* __restrict__ hist,
                int64_t n) {
  __shared__ int32_t sb[kMaxBins];
  __shared__ int32_t sh[kMaxBins];
  if (threadIdx.x < k) {
    sb[threadIdx.x] = bounds[threadIdx.x];
    sh[threadIdx.x] = 0;
  }
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       v < n; v += stride) {
    const int32_t d = deg[v];
    int g = 0;
    for (int i = 0; i < k; ++i) {
      if (d >= sb[i]) {
        g = i;
        break;
      }
    }
    groups[v] = g;
    atomicAdd(&sh[g], 1);
  }
  __syncthreads();
  if (threadIdx.x < k && sh[threadIdx.x] != 0) {
    atomicAdd(&hist[threadIdx.x], sh[threadIdx.x]);
  }
}

}  // namespace

// deg, groups: (n,) int32; bounds: (k,) int32 with 1 <= k <= 32; hist: (k,)
// int32, zeroed by the caller.  Returns a cudaError_t (0 on success).
extern "C" int hist_bin(const void* deg, const void* bounds, int k,
                        void* groups, void* hist, int64_t n, void* stream) {
  if (k < 1 || k > kMaxBins || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  hist_bin_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(deg), static_cast<const int32_t*>(bounds), k,
      static_cast<int32_t*>(groups), static_cast<int32_t*>(hist), n);
  return static_cast<int>(cudaGetLastError());
}
