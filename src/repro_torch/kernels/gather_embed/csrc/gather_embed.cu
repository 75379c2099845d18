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
// makes the kernel read outside a table.  Ids are int32 or int64, read
// through an element stride, so a strided column of a prompt needs no copy
// kernel ahead of this one.  The element type is float32 or bfloat16
// (K2_ELEM_BYTES = 4 or 2, one library each); the copy never looks at the
// values, so the result is bitwise the table's rows.
//
// What bounds it on the H100: bytes — each output row is read once from a
// table and written once (T * D * elem each way, plus the ids); there is no
// arithmetic.  At the decode call (T = batch) the bytes are nothing, and
// what is left is the launch and the wrapper's host time.
//
// What the design does about it:
//  * the TPU design kept the (H, D) hot panel resident in VMEM.  At Yi-9B
//    width that panel is 8192 x 4096 x 4 B = 128 MiB, more than the H100's
//    50 MB L2 and far more than a block's 227 KB of shared memory, so the
//    kernel is a row copy: hot rows get their locality from L2 reuse across
//    tokens, which is what DBG's grouping buys on this card;
//  * one block per output row: the id is read once per block and no thread
//    divides; the row's 16-byte units (uint4, when the row is a multiple of
//    16 bytes and every table and the output are 16-byte aligned; else
//    elements) are strided over the 256 threads, kBatch per thread, all
//    loads issued before the stores;
//  * stores are streaming (st.global.cs): the output is never re-read by
//    this kernel, so it should not evict the hot rows from L2.  On the H100
//    at 8,192 Zipf ids they took ~2% off the device time against plain
//    stores; an L2 evict_last / evict_first policy on hot / cold loads took
//    nothing off and was dropped (see PERF.md).
//
// Hopper's bulk-copy engine (cp.async.bulk through shared memory on an
// mbarrier, one thread of a one-warp block issuing each copy) took ~12% more
// device time than this kernel at 8,192 Zipf ids on the H100 (see PERF.md),
// so the threads copy the rows.
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
constexpr int kBatch = 4;  // units per thread in flight: a 16 KiB row at once

// The table row token t reads (-1: a zero row), and whether it is hot.
template <typename IdT, bool kSplit>
__device__ __forceinline__ int64_t source_row(const IdT* __restrict__ ids,
                                              int64_t id_stride, int64_t t,
                                              int64_t h, int64_t c,
                                              bool* hot) {
  int64_t id = static_cast<int64_t>(ids[t * id_stride]);
  if (id < 0) id = 0;
  *hot = id < h;
  if (*hot) return id;
  if (kSplit) return id - h < c ? id - h : c - 1;
  return -1;  // hot_gather's cold id: a zero row
}

// Block t copies output row t.  Unit: the copy unit (uint4 or Elem); units:
// units per row.
template <typename Unit, typename IdT, bool kSplit>
__global__ void __launch_bounds__(kThreads)
row_kernel(const IdT* __restrict__ ids, int64_t id_stride,
           const Unit* __restrict__ hot, int64_t h,
           const Unit* __restrict__ cold, int64_t c, int units,
           Unit* __restrict__ out) {
  const int64_t t = blockIdx.x;
  bool is_hot;
  const int64_t r = source_row<IdT, kSplit>(ids, id_stride, t, h, c, &is_hot);
  const Unit* src =
      r < 0 ? nullptr : (is_hot ? hot : cold) + r * static_cast<int64_t>(units);
  Unit* dst = out + t * static_cast<int64_t>(units);
  for (int j0 = threadIdx.x; j0 < units; j0 += kThreads * kBatch) {
    Unit v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int j = j0 + b * kThreads;
      v[b] = src != nullptr && j < units ? __ldg(src + j) : Unit{};
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int j = j0 + b * kThreads;
      if (j < units) __stcs(dst + j, v[b]);
    }
  }
}

template <typename IdT, bool kSplit>
cudaError_t launch_ids(const IdT* ids, int64_t id_stride, const void* hot,
                       int64_t h, const void* cold, int64_t c, int64_t d,
                       void* out, int64_t n, cudaStream_t s) {
  const int64_t row_bytes = d * K2_ELEM_BYTES;
  const bool vec = row_bytes % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(hot) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(cold) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const auto blocks = static_cast<unsigned>(n);
  if (vec) {
    row_kernel<uint4, IdT, kSplit><<<blocks, kThreads, 0, s>>>(
        ids, id_stride, static_cast<const uint4*>(hot), h,
        static_cast<const uint4*>(cold), c, static_cast<int>(row_bytes / 16),
        static_cast<uint4*>(out));
  } else {
    row_kernel<Elem, IdT, kSplit><<<blocks, kThreads, 0, s>>>(
        ids, id_stride, static_cast<const Elem*>(hot), h,
        static_cast<const Elem*>(cold), c, static_cast<int>(d),
        static_cast<Elem*>(out));
  }
  return cudaGetLastError();
}

template <bool kSplit>
int launch(const void* ids, int id_bytes, int64_t id_stride, const void* hot,
           int64_t h, const void* cold, int64_t c, int64_t d, void* out,
           int64_t n, void* stream) {
  // a grid over T: at most 2^31 - 1 rows; a row's units index in an int
  if (h < 0 || c < 0 || d < 1 || d > INT32_MAX || n < 0 || n > INT32_MAX ||
      id_stride < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (id_bytes) {
    case 4:
      err = launch_ids<int32_t, kSplit>(static_cast<const int32_t*>(ids),
                                        id_stride, hot, h, cold, c, d, out, n,
                                        s);
      break;
    case 8:
      err = launch_ids<int64_t, kSplit>(static_cast<const int64_t*>(ids),
                                        id_stride, hot, h, cold, c, d, out, n,
                                        s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// ids: (n,) int32 or int64 (id_bytes 4 or 8), element i at ids[i *
// id_stride]; hot: (h, d); out: (n, d); elements of K2_ELEM_BYTES.
// Returns a cudaError_t (0 on success).
extern "C" int hot_gather(const void* ids, int id_bytes, int64_t id_stride,
                          const void* hot, int64_t h, int64_t d, void* out,
                          int64_t n, void* stream) {
  return launch<false>(ids, id_bytes, id_stride, hot, h, nullptr, 0, d, out,
                       n, stream);
}

// As hot_gather, with cold: (c, d), c >= 1.
extern "C" int split_gather(const void* ids, int id_bytes, int64_t id_stride,
                            const void* hot, int64_t h, const void* cold,
                            int64_t c, int64_t d, void* out, int64_t n,
                            void* stream) {
  if (c < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(ids, id_bytes, id_stride, hot, h, cold, c, d, out, n,
                      stream);
}
