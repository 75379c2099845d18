// K4, the packed hot-segment SpMV, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel `hot_spmv_pallas` in
// src/repro/kernels/pack_spmv/pack_spmv.py:58 (kernel bodies
// `_kernel_unweighted` :26 and `_kernel_weighted` :42).  For every row r of
// one hot slot table it computes
//
//   y[r] = sum over slots c < deg[r] of x[idx[r, c]] (* w[r, c])
//
// The weight is multiplicative (K5's is additive), and the padding slots
// add nothing (the TPU function has no padding term).  Ids are read at the
// width the packed storage keeps them: uint8 (V <= 256), uint16
// (V <= 65,536) or uint32, so the id plane is never widened in memory.
//
// What bounds it on the H100: bytes (x once, the valid ids at their stored
// width, and weights, deg and y: at 3.35 TB/s that is the floor), and the
// latency of the dependent id -> x[id] gather.  The hub table (a few
// thousand rows of up to ~10^5 slots) is most of the work, and a block per
// hub row leaves each thread ~300 slots to walk one after another.
//
// What the design does about it: the row-group kernels of
// ../../csrc/row_spmv.cuh, shared with K1, as K1 runs them.  The lane group
// is sized to the longest row (the wrapper's walk_lanes), a thread that
// walks more than 4 slots keeps 8 gathers in flight, and a table whose
// longest row passes 1,024 slots is split into segments of at most
// SEGMENT_LANES slots (the wrapper's list), a 256-thread block each, whose
// partials a second launch folds per row in order.
#include "../../csrc/row_spmv.cuh"

namespace {
// As K1 (csr_spmv.cu): 8 slots' loads in flight per thread where a thread
// walks more than 4 slots of its row, one below.
constexpr int kUnroll = 8;
constexpr int kBatchAbove = 4;

template <typename IdT, bool WEIGHTED>
cudaError_t pick_walk(int group, const void* x, const void* idx,
                      const void* deg, const void* w, const void* segs,
                      int64_t num_segs, int64_t chunk, void* partial, void* y,
                      int64_t rows, int64_t width, int64_t num_vertices,
                      int64_t walk_lanes, cudaStream_t stream) {
  if (group == row_spmv::kThreads) {
    return row_spmv::launch_split<IdT, WEIGHTED, kUnroll, false>(
        x, idx, deg, w, segs, num_segs, chunk, partial, y, rows, width,
        num_vertices, stream);
  }
  if (walk_lanes > kBatchAbove * group) {
    return row_spmv::launch<IdT, WEIGHTED, kUnroll, false>(
        group, x, idx, deg, w, y, rows, width, num_vertices, stream);
  }
  return row_spmv::launch<IdT, WEIGHTED, 1, false>(
      group, x, idx, deg, w, y, rows, width, num_vertices, stream);
}

template <typename IdT>
cudaError_t pick_weight(const void* w, int group, const void* x,
                        const void* idx, const void* deg, const void* segs,
                        int64_t num_segs, int64_t chunk, void* partial,
                        void* y, int64_t rows, int64_t width,
                        int64_t num_vertices, int64_t walk_lanes,
                        cudaStream_t stream) {
  if (w != nullptr) {
    return pick_walk<IdT, true>(group, x, idx, deg, w, segs, num_segs, chunk,
                                partial, y, rows, width, num_vertices,
                                walk_lanes, stream);
  }
  return pick_walk<IdT, false>(group, x, idx, deg, w, segs, num_segs, chunk,
                               partial, y, rows, width, num_vertices,
                               walk_lanes, stream);
}

}  // namespace

// idx_bytes: 1 (uint8), 2 (uint16) or 4 (uint32 ids).  deg: int32 (rows,).
// w may be null (no weight plane).  group: lanes per row, 8, 16, 32, or
// 256, which takes the two-launch row split over segs (num_segs int32
// (row, lane_begin, lane_end) triples, sorted by row, each row's in slot
// order from slot 0, covering [0, deg)); partial is then float scratch of
// one value per segment.  walk_lanes: the longest row walked, which tells
// whether a thread walks enough slots to keep a batch in flight.  Returns a
// cudaError_t (0 on success).
extern "C" int k4_hot_spmv(const void* x, const void* idx, int idx_bytes,
                           const void* deg, const void* w, const void* segs,
                           int64_t num_segs, int64_t chunk, void* partial,
                           void* y, int64_t rows, int64_t width,
                           int64_t num_vertices, int group,
                           int64_t walk_lanes, void* stream) {
  const bool split = group == row_spmv::kThreads;
  if (deg == nullptr || (split && (segs == nullptr || partial == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (idx_bytes) {
    case 1:
      err = pick_weight<uint8_t>(w, group, x, idx, deg, segs, num_segs, chunk,
                                 partial, y, rows, width, num_vertices,
                                 walk_lanes, s);
      break;
    case 2:
      err = pick_weight<uint16_t>(w, group, x, idx, deg, segs, num_segs,
                                  chunk, partial, y, rows, width,
                                  num_vertices, walk_lanes, s);
      break;
    case 4:
      err = pick_weight<uint32_t>(w, group, x, idx, deg, segs, num_segs,
                                  chunk, partial, y, rows, width,
                                  num_vertices, walk_lanes, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
