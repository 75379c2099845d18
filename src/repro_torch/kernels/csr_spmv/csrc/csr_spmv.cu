// K1, the degree-binned ELL SpMV, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel `ell_spmv_pallas` in
// src/repro/kernels/csr_spmv/csr_spmv.py:47 (kernel body `_kernel` :33).
// For every row r of one DBG group's ELL planes it computes the TPU
// kernel's function
//
//   y[r] = sum over ALL lanes c < W of x[idx[r, c]] * w[r, c]
//
// The TPU kernel has no degree vector: padding lanes carry id 0 and weight
// 0 and are summed like any other, so a non-finite x[0] reaches every row
// with padding (0 * inf is NaN).  Ids are int32, as K1's packer stores
// them.
//
// What bounds it on the H100: bytes.  Read lane by lane, the padded planes
// (8 bytes of id + weight per lane) are ~20x the edges on a DBG-binned RMAT
// graph, and they set the floor of the deg == nullptr path.  With the
// packer's degree vector the kernel reads only lanes c < deg[r] — lanes
// >= deg are (0, 0.0), which `ell_pack_groups` guarantees — and adds the
// one term x[0] * 0 to each row with deg[r] < W, which has the value (and
// the NaN) of all its padding terms.  Its floor is then the real lanes, x
// once, and deg and y per row.
//
// What else bounds it: the latency of the dependent id -> x[id] gather, and
// on the hub group (a few thousand rows of up to ~10^5 lanes) the longest
// rows, which set the group's tail.  So the lane group is sized to the
// longest row it walks, a thread that walks more than 4 lanes keeps 8 in
// flight, and a group wider than 1,024 lanes is split into pieces of a
// few thousand lanes, a 256-thread block each, whose partials a second
// launch folds per row in order.  The degree walk's pieces follow its
// segment list; the every-lane path cuts each row's width at the same
// multiples, so the two paths sum the same lanes in the same order.
//
// The row-group kernels (a lane group per row, the split, a fixed-order
// reduction, no float atomics) are ../../csrc/row_spmv.cuh, shared with K4.
#include "../../csrc/row_spmv.cuh"

namespace {
// Lanes of one thread with loads in flight, where a thread walks more than
// kBatchAbove lanes of its row; below that the warps keep the gathers in
// flight, and a batch's registers would only cost occupancy.
constexpr int kUnroll = 8;
constexpr int kBatchAbove = 4;
}  // namespace

// deg: int32 (rows,) true degrees, or null for every lane of each row.
// group: lanes per row, 8, 16, 32, or 256, which takes the two-launch row
// split: over segs (num_segs int32 (row, lane_begin, lane_end) triples,
// sorted by row, each row's in lane order from lane 0, covering [0, deg))
// or, when segs is null, over every row's width cut every `chunk` lanes;
// partial is then float scratch of one value per segment.  walk_lanes: the
// longest row the walk takes (the width, or the largest degree), which
// tells whether a thread walks enough lanes to keep a batch in flight.
// Returns a cudaError_t (0 on success).
extern "C" int k1_ell_spmv(const void* x, const void* idx, const void* w,
                           const void* deg, const void* segs,
                           int64_t num_segs, int64_t chunk, void* partial,
                           void* y, int64_t rows, int64_t width,
                           int64_t num_vertices, int group,
                           int64_t walk_lanes, void* stream) {
  if (w == nullptr || (group == row_spmv::kThreads && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (group == row_spmv::kThreads) {
    err = row_spmv::launch_split<int32_t, true, kUnroll, true>(
        x, idx, deg, w, segs, num_segs, chunk, partial, y, rows, width,
        num_vertices, s);
  } else if (walk_lanes > kBatchAbove * group) {
    err = row_spmv::launch<int32_t, true, kUnroll, true>(
        group, x, idx, deg, w, y, rows, width, num_vertices, s);
  } else {
    err = row_spmv::launch<int32_t, true, 1, true>(
        group, x, idx, deg, w, y, rows, width, num_vertices, s);
  }
  return static_cast<int>(err);
}
