// K1, the degree-binned ELL SpMV, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel `ell_spmv_pallas` in
// src/repro/kernels/csr_spmv/csr_spmv.py:47 (kernel body `_kernel` :33).
// For every row r of one DBG group's ELL planes it computes
//
//   y[r] = sum over ALL lanes c < W of x[idx[r, c]] * w[r, c]
//
// The TPU kernel has no degree vector: padding lanes carry id 0 and weight
// 0 and are summed like any other, so a non-finite x[0] reaches every row
// with padding (0 * inf is NaN), exactly as on the TPU.  Ids are int32, as
// K1's packer stores them.  By definition K1 reads the whole padded planes
// (8 bytes of id + weight per lane); at 3.35 TB/s those planes plus x and y
// set its floor.
//
// The row-group kernel itself (a lane group per row over every lane, a
// fixed-order reduction) is ../../csrc/row_spmv.cuh, shared with K4: here
// it runs with no degree vector.
#include "../../csrc/row_spmv.cuh"

// group: lanes per row, 8, 16, 32 or 256.  Returns a cudaError_t (0 on
// success).
extern "C" int k1_ell_spmv(const void* x, const void* idx, const void* w,
                           void* y, int64_t rows, int64_t width,
                           int64_t num_vertices, int group, void* stream) {
  if (w == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(row_spmv::launch<int32_t, true>(
      group, x, idx, nullptr, w, y, rows, width, num_vertices,
      static_cast<cudaStream_t>(stream)));
}
