// K2, the hot/cold split embedding gather, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel `hot_gather_pallas` in
// src/repro/kernels/gather_embed/gather_embed.py:36 (kernel body `_kernel`
// :27) and, in one pass, the `where` merge of `ops.split_gather` (ops.py:22)
// around it.  Two entry points over one kernel template:
//
//   hot_gather:   out[t] = hot[ids[t]]  if ids[t] < H, else a zero row
//                 (the TPU kernel's function)
//   split_gather: out[t] = hot[ids[t]]      if ids[t] < H
//                          cold[ids[t] - H] otherwise, the index clamped to
//                          C - 1 (the reference's XLA gather clamps too)
//
// An id below 0 is outside the contract and is clamped to 0: no id ever
// makes the kernel read outside a table.  The element type is float32 or
// bfloat16 (K2_ELEM_BYTES = 4 or 2, one library each); the copy never looks
// at the values, so the result is bitwise the table's rows.
//
// What bounds it on the H100: bytes — each output row is read once from a
// table and written once (T * D * elem each way, plus 4 bytes of id per
// token); there is no arithmetic.
//
// What the design does about it:
//  * the TPU design kept the (H, D) hot panel resident in VMEM.  At Yi-9B
//    width that panel is 8192 x 4096 x 4 B = 128 MiB, more than the H100's
//    50 MB L2 and far more than a block's 227 KB of shared memory, so the
//    kernel is a plain row copy: hot rows get their locality from L2 reuse
//    across tokens, which is what DBG's grouping buys on this card;
//  * one thread per 16-byte vector of the output (uint4 loads and stores,
//    neighbouring threads on neighbouring addresses) when D * elem is a
//    multiple of 16 and every pointer is 16-byte aligned, else one thread per
//    element; a grid-stride loop over T * (vectors per row) on a bounded
//    grid, so any T works and a short decode call (T = batch) still spreads
//    its rows over many blocks.
//
// The C entries return cudaGetLastError() after the launch; the launch is on
// the caller's stream and allocates nothing.
#include <cuda_runtime.h>

#include <cstdint>

#ifndef K2_ELEM_BYTES
#define K2_ELEM_BYTES 4
#endif

namespace {

#if K2_ELEM_BYTES == 4
using Elem = uint32_t;  // float32, copied as its bits
#elif K2_ELEM_BYTES == 2
using Elem = uint16_t;  // bfloat16, copied as its bits
#else
#error "K2_ELEM_BYTES must be 4 or 2"
#endif

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // 16 blocks per SM on an H100

// Unit: the copy unit (uint4 or Elem); units: units per row.
template <typename Unit, bool kSplit>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const int32_t* __restrict__ ids, const Unit* __restrict__ hot,
              int64_t h, const Unit* __restrict__ cold, int64_t c,
              int64_t units, Unit* __restrict__ out, int64_t n) {
  const int64_t total = n * units;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < total; i += stride) {
    const int64_t t = i / units;
    const int64_t j = i - t * units;
    int64_t id = ids[t];
    if (id < 0) id = 0;
    const Unit* src = nullptr;
    if (id < h) {
      src = hot + id * units;
    } else if (kSplit && c > 0) {
      const int64_t r = id - h < c ? id - h : c - 1;
      src = cold + r * units;
    }
    out[i] = src != nullptr ? src[j] : Unit{};  // zero row: hot_gather's cold id
  }
}

template <bool kSplit>
int launch(const void* ids, const void* hot, int64_t h, const void* cold,
           int64_t c, int64_t d, void* out, int64_t n, void* stream) {
  if (h < 0 || c < 0 || d < 1 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const int64_t row_bytes = d * K2_ELEM_BYTES;
  const bool vec = row_bytes % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(hot) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(cold) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int64_t units = vec ? row_bytes / 16 : d;
  int64_t blocks = (n * units + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* id = static_cast<const int32_t*>(ids);
  if (vec) {
    gather_kernel<uint4, kSplit><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        id, static_cast<const uint4*>(hot), h, static_cast<const uint4*>(cold),
        c, units, static_cast<uint4*>(out), n);
  } else {
    gather_kernel<Elem, kSplit><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        id, static_cast<const Elem*>(hot), h, static_cast<const Elem*>(cold),
        c, units, static_cast<Elem*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ids: (n,) int32; hot: (h, d); out: (n, d); elements of K2_ELEM_BYTES.
// Returns a cudaError_t (0 on success).
extern "C" int hot_gather(const void* ids, const void* hot, int64_t h,
                          int64_t d, void* out, int64_t n, void* stream) {
  return launch<false>(ids, hot, h, nullptr, 0, d, out, n, stream);
}

// ids: (n,) int32; hot: (h, d); cold: (c, d) with c >= 1; out: (n, d).
// Returns a cudaError_t (0 on success).
extern "C" int split_gather(const void* ids, const void* hot, int64_t h,
                            const void* cold, int64_t c, int64_t d, void* out,
                            int64_t n, void* stream) {
  if (c < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(ids, hot, h, cold, c, d, out, n, stream);
}
