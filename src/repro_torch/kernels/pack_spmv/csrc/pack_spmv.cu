// K4, the packed hot-segment SpMV, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel `hot_spmv_pallas` in
// src/repro/kernels/pack_spmv/pack_spmv.py:58 (kernel bodies
// `_kernel_unweighted` :26 and `_kernel_weighted` :42).  For every row r of
// one hot slot table it computes
//
//   y[r] = sum over slots c < deg[r] of x[idx[r, c]] (* w[r, c])
//
// The weight is multiplicative (K5's is additive).  Ids are read at the
// width the packed storage keeps them: uint8 (V <= 256), uint16
// (V <= 65,536) or uint32, so the id plane is never widened in memory.  The
// least traffic is x once, the valid ids at their stored width (and
// weights), deg and y; at 3.35 TB/s that is the floor.
//
// The row-group kernel itself (a lane group per row that stops at deg[r],
// a fixed-order reduction) is ../../csrc/row_spmv.cuh, shared with K1.
#include "../../csrc/row_spmv.cuh"

namespace {

template <typename IdT>
cudaError_t pick_weight(int group, const void* x, const void* idx,
                        const void* deg, const void* w, void* y, int64_t rows,
                        int64_t width, int64_t num_vertices,
                        cudaStream_t stream) {
  if (w != nullptr) {
    return row_spmv::launch<IdT, true>(group, x, idx, deg, w, y, rows, width,
                                       num_vertices, stream);
  }
  return row_spmv::launch<IdT, false>(group, x, idx, deg, w, y, rows, width,
                                      num_vertices, stream);
}

}  // namespace

// idx_bytes: 1 (uint8), 2 (uint16) or 4 (uint32 ids).  w may be null (no
// weight plane).  group: lanes per row, 8, 16, 32 or 256.  Returns a
// cudaError_t (0 on success).
extern "C" int k4_hot_spmv(const void* x, const void* idx, int idx_bytes,
                           const void* deg, const void* w, void* y,
                           int64_t rows, int64_t width, int64_t num_vertices,
                           int group, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (idx_bytes) {
    case 1:
      err = pick_weight<uint8_t>(group, x, idx, deg, w, y, rows, width,
                                 num_vertices, s);
      break;
    case 2:
      err = pick_weight<uint16_t>(group, x, idx, deg, w, y, rows, width,
                                  num_vertices, s);
      break;
    case 4:
      err = pick_weight<uint32_t>(group, x, idx, deg, w, y, rows, width,
                                  num_vertices, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
