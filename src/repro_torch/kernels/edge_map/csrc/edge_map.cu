// K5, the fused edge map, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel `ell_edge_map_pallas` in
// src/repro/kernels/edge_map/edge_map.py:159 (kernel body `_make_kernel`).
// For every ELL row r it computes
//
//   y[r, k] = REDUCE( base[r, k], REDUCE over lanes c < deg[r] of v[c, k] )
//   v[c, k] = identity                        where alive[r, c] == 0
//           = neutral                         where frontier[idx[r, c](, k)] == 0
//           = x[idx[r, c], k] (+ w[r, c] | +1)  otherwise
//   base    = init_rows[r, k], or the identity when there is no init
//
// with REDUCE one of sum, min, max.  x may be a (V,) vector (K = 1) or a
// (V, K) plane; the frontier is shared (V,) or per query (V, K).  Ids are
// uint16 or int32, whichever the packer stored.
//
// What bounds it on the H100: bytes.  Each lane does one add and one compare
// per byte-heavy gather; the work is far below the card's float32 rate.  The
// least traffic is the valid lanes of the idx (and w / alive) planes, deg, x
// once, the frontier once, init and y: edge_map_tile_bytes in edge_map.py
// counts the padded planes, and at 3.35 TB/s that is the kernel's floor.
//
// What the design does about it:
//  * a group of G lanes (G = 8, 16 or 32, the smallest power of two >= the
//    tile's width, capped at a warp) owns one row and strides its columns, so
//    lanes past deg[r] — the ELL padding — are never read at all;
//  * the ids are read at their stored width (uint16 halves the idx plane);
//  * x is gathered through L2: after DBG the hot vertices are contiguous, and
//    at the sizes the paper runs x fits the 50 MB L2;
//  * each lane reduces its columns in order, then the group reduces with a
//    fixed shuffle tree: sums come out the same from run to run, with no
//    float atomics, and min / max are exact;
//  * K query lanes of a plane ride one pass over the row's ids, KC of them
//    per thread (blockIdx.y walks chunks of KC when K > KC).
//
// Build: one shared library per reduction, compiled with -DK5_REDUCE=0|1|2
// (see repro_torch/kernels/_build.py).  The C entry returns cudaGetLastError()
// after the launch; the launch is on the caller's stream and allocates nothing.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#ifndef K5_REDUCE
#error "compile with -DK5_REDUCE=0 (sum), 1 (min) or 2 (max)"
#endif

namespace {

constexpr int kThreads = 256;

// The reductions.  min / max propagate NaN like torch.minimum / maximum.
template <int RED>
__device__ __forceinline__ float combine(float a, float b) {
  if constexpr (RED == 0) {
    return a + b;
  } else if constexpr (RED == 1) {
    return (a < b || a != a) ? a : b;
  } else {
    return (a > b || a != a) ? a : b;
  }
}

// The start of each lane's partial reduction: the true neutral element, so a
// lane with no columns leaves the group's result unchanged.
template <int RED>
__device__ __forceinline__ float lane_start() {
  if constexpr (RED == 0) {
    return 0.0f;
  } else if constexpr (RED == 1) {
    return __int_as_float(0x7f800000);  // +inf
  } else {
    return __int_as_float(0xff800000);  // -inf
  }
}

// WMODE: 0 no weight, 1 unit weight (+1, no plane read), 2 weight plane.
// FMODE: 0 no frontier, 1 shared (V,) frontier, 2 per-query (V, K) frontier.
template <int RED, typename IdT, int WMODE, int FMODE, bool ALIVE, bool INIT,
          int KC>
__global__ void __launch_bounds__(kThreads)
edge_map_kernel(const float* __restrict__ x, const IdT* __restrict__ idx,
                const int32_t* __restrict__ deg, const float* __restrict__ w,
                const int8_t* __restrict__ frontier,
                const int8_t* __restrict__ alive,
                const float* __restrict__ init, float* __restrict__ y,
                int64_t rows, int64_t width, int64_t num_vertices, int k_total,
                int group, float neutral, float identity) {
  const int sub = threadIdx.x & (group - 1);
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / group;
  const int k0 = blockIdx.y * KC;
  // Every lane of the warp reaches the shuffles below, so rows past the end
  // still run the tree, with no columns.
  const bool live = row < rows;
  int64_t d = 0;
  if (live) {
    d = deg[row];
    d = d < 0 ? 0 : (d > width ? width : d);
  }

  float acc[KC];
#pragma unroll
  for (int k = 0; k < KC; ++k) acc[k] = lane_start<RED>();

  const int64_t base = row * width;
  for (int64_t c = sub; c < d; c += group) {
    const int64_t j = static_cast<int64_t>(idx[base + c]);
    if (static_cast<uint64_t>(j) >= static_cast<uint64_t>(num_vertices)) {
      __trap();  // an id outside x: a malformed tile, never a silent read
    }
    const bool ok = ALIVE ? alive[base + c] > 0 : true;
    float add = 0.0f;
    if constexpr (WMODE == 2) add = w[base + c];
    if constexpr (WMODE == 1) add = 1.0f;
    bool active = true;
    if constexpr (FMODE == 1) active = frontier[j] > 0;
    const float* xj = x + j * k_total + k0;
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      if (KC == 1 || k0 + k < k_total) {
        float v;
        if (!ok) {
          v = identity;
        } else {
          v = xj[k];
          if constexpr (WMODE != 0) v += add;
          if constexpr (FMODE == 1) {
            if (!active) v = neutral;
          } else if constexpr (FMODE == 2) {
            if (frontier[j * k_total + k0 + k] <= 0) v = neutral;
          }
        }
        acc[k] = combine<RED>(acc[k], v);
      }
    }
  }

#pragma unroll
  for (int k = 0; k < KC; ++k) {
    float v = acc[k];
    for (int off = group >> 1; off > 0; off >>= 1) {
      v = combine<RED>(v, __shfl_down_sync(0xffffffffu, v, off, group));
    }
    acc[k] = v;
  }

  if (live && sub == 0) {
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      if (KC == 1 || k0 + k < k_total) {
        float r = acc[k];
        // Padding lanes take the identity.  For sum the wrapper admits only
        // identity 0, so they add nothing and are skipped outright.
        if (RED != 0 && d < width) r = combine<RED>(r, identity);
        const int64_t o = row * k_total + k0 + k;
        const float b = INIT ? init[o] : identity;
        y[o] = combine<RED>(b, r);
      }
    }
  }
}

struct Args {
  const void* x;
  const void* idx;
  const void* deg;
  const void* w;
  const void* frontier;
  const void* alive;
  const void* init;
  void* y;
  int64_t rows;
  int64_t width;
  int64_t num_vertices;
  int k;
  int group;
  float neutral;
  float identity;
  cudaStream_t stream;
};

template <int RED, typename IdT, int WMODE, int FMODE, bool ALIVE, bool INIT,
          int KC>
cudaError_t launch(const Args& a) {
  const int64_t threads = a.rows * a.group;
  const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads),
                  static_cast<unsigned>((a.k + KC - 1) / KC));
  edge_map_kernel<RED, IdT, WMODE, FMODE, ALIVE, INIT, KC>
      <<<grid, kThreads, 0, a.stream>>>(
          static_cast<const float*>(a.x), static_cast<const IdT*>(a.idx),
          static_cast<const int32_t*>(a.deg), static_cast<const float*>(a.w),
          static_cast<const int8_t*>(a.frontier),
          static_cast<const int8_t*>(a.alive),
          static_cast<const float*>(a.init), static_cast<float*>(a.y), a.rows,
          a.width, a.num_vertices, a.k, a.group, a.neutral, a.identity);
  return cudaGetLastError();
}

// Runtime flags -> template arguments.
template <typename F>
cudaError_t pick_bool(bool b, F&& f) {
  return b ? f(std::true_type{}) : f(std::false_type{});
}

template <typename F>
cudaError_t pick3(int m, F&& f) {
  switch (m) {
    case 0: return f(std::integral_constant<int, 0>{});
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

#if K5_REDUCE == 0
#define K5_ENTRY k5_edge_map_sum
#elif K5_REDUCE == 1
#define K5_ENTRY k5_edge_map_min
#else
#define K5_ENTRY k5_edge_map_max
#endif

// idx_bytes: 2 (uint16 ids) or 4 (int32 ids).  Pointers that a mode does not
// read may be null.  Returns a cudaError_t (0 on success).
extern "C" int K5_ENTRY(const void* x, const void* idx, int idx_bytes,
                        const void* deg, const void* w, int wmode,
                        const void* frontier, int fmode, const void* alive,
                        const void* init, void* y, int64_t rows, int64_t width,
                        int64_t num_vertices, int k, int group, float neutral,
                        float identity, void* stream) {
  if ((idx_bytes != 2 && idx_bytes != 4) || k < 1 ||
      (group != 8 && group != 16 && group != 32) || rows < 0 || width < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  const Args a{x,    idx,   deg,  w,    frontier,     alive, init,    y,
               rows, width, num_vertices, k, group, neutral, identity,
               static_cast<cudaStream_t>(stream)};
  const cudaError_t err = pick_bool(idx_bytes == 2, [&](auto u16) {
    using IdT = std::conditional_t<decltype(u16)::value, uint16_t, int32_t>;
    return pick3(wmode, [&](auto wm) {
      return pick3(fmode, [&](auto fm) {
        return pick_bool(alive != nullptr, [&](auto al) {
          return pick_bool(init != nullptr, [&](auto in) {
            return pick_bool(k == 1, [&](auto one) {
              return launch<K5_REDUCE, IdT, decltype(wm)::value,
                            decltype(fm)::value, decltype(al)::value,
                            decltype(in)::value,
                            (decltype(one)::value ? 1 : 8)>(a);
            });
          });
        });
      });
    });
  });
  return static_cast<int>(err);
}
