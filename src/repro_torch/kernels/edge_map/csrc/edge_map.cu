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
// What bounds it on the H100: bytes, and the latency of the dependent
// id -> x[id] gather.  Each lane does one add and one compare per
// byte-heavy gather; the work is far below the card's float32 rate.  The
// least traffic is the valid lanes of the idx (and w / alive) planes, deg,
// x once, the frontier once, init and y; at 3.35 TB/s that is the floor.
// On a DBG-binned RMAT graph the hub class holds a few thousand rows of up
// to ~10^5 lanes, and how fast its longest rows finish sets the class's
// time.
//
// What the design does about it:
//  * a group of G lanes owns one row and strides its columns, so lanes past
//    deg[r] — the ELL padding — are never read at all.  G comes from the
//    tile's width (repro_torch.kernels._wrap.lanes_per_row): 8, 16 or 32
//    lanes (several rows per block) up to 1,024 lanes, and a whole
//    256-thread block above that, so a hub row of ~75k lanes is walked by
//    256 threads, not by one warp's ~2,400 steps;
//  * where a thread walks several lanes of its row, it keeps several lanes'
//    loads in flight (ids, weights and alive bytes, then the frontier and
//    x[id]) before it reduces them, in lane order, so it waits on the
//    gather once per batch, not per lane; in a narrow class where it walks
//    at most K5_BATCH_ABOVE lanes, it keeps no batch, and the registers it
//    saves buy occupancy (PERF.md, section 6, has both kernels' times per
//    class);
//  * the wide path splits rows into segments of at most a few thousand
//    lanes (row, lane_begin, lane_end; _wrap.row_segments), one block each:
//    every block writes one partial per query lane, and a second launch
//    folds each row's partials in segment order, so a row far longer than
//    the rest no longer sets the class's tail (PERF.md, section 6, times it
//    beside a block per whole row);
//  * the ids are read at their stored width (uint16 halves the idx plane);
//  * x is gathered through L2: after DBG the hot vertices are contiguous, and
//    at the sizes the paper runs x fits the 50 MB L2;
//  * each lane reduces its columns in order, then the group reduces with a
//    fixed shuffle tree (a block: each warp's tree, then the eight warp
//    partials in index order through shared memory): sums come out the
//    same from run to run, with no float atomics, and min / max are exact;
//  * K query lanes of a plane ride one pass over the row's ids, KC of them
//    per thread (blockIdx.y walks chunks of KC when K > KC).
//
// Build: one shared library per reduction, compiled with -DK5_REDUCE=0|1|2
// (see repro_torch/kernels/_build.py); -DK5_BATCH_ABOVE=N overrides the
// narrow kernel's batch threshold (0: always batch, 32 or more: never).  The C entry returns cudaGetLastError()
// after its launches; they are on the caller's stream and allocate nothing.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#ifndef K5_REDUCE
#error "compile with -DK5_REDUCE=0 (sum), 1 (min) or 2 (max)"
#endif
#ifndef K5_BATCH_ABOVE
#define K5_BATCH_ABOVE 4
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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
//
// Reduces the lanes c0, c0 + stride, ... < end of one row (plane offset
// `base`) into acc, UNROLL lanes at a time: all their loads are issued
// before the first of them is combined, and they are combined in lane order,
// so the result is the one-lane-at-a-time walk's, bit for bit.  Ids are held
// in 32 bits (every id is < V < 2^31; a negative int32 id wraps past V and
// traps), which keeps the batch's registers, and so the occupancy, down.
template <int RED, typename IdT, int WMODE, int FMODE, bool ALIVE, int KC,
          int UNROLL>
__device__ __forceinline__ void walk(
    float (&acc)[KC], const float* __restrict__ x,
    const IdT* __restrict__ idx, const float* __restrict__ w,
    const int8_t* __restrict__ frontier, const int8_t* __restrict__ alive,
    int64_t base, int64_t c0, int64_t end, int stride, int64_t num_vertices,
    int k_total, int k0, float neutral, float identity) {
  for (int64_t c = c0; c < end; c += static_cast<int64_t>(UNROLL) * stride) {
    uint32_t j[UNROLL];
    bool ok[UNROLL];
    float add[UNROLL];
    bool bad = false;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t cu = c + static_cast<int64_t>(u) * stride;
      ok[u] = cu < end;
      j[u] = 0;
      add[u] = WMODE == 1 ? 1.0f : 0.0f;
      if (ok[u]) {
        j[u] = static_cast<uint32_t>(idx[base + cu]);
        if constexpr (ALIVE) ok[u] = alive[base + cu] > 0;
        if constexpr (WMODE == 2) add[u] = w[base + cu];
      }
      bad |= j[u] >= static_cast<uint64_t>(num_vertices);
    }
    if (bad) {
      __trap();  // an id outside x: a malformed tile, never a silent read
    }
    bool active[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      active[u] = true;
      if constexpr (FMODE == 1) {
        if (ok[u]) active[u] = frontier[j[u]] > 0;
      }
    }
    float v[UNROLL][KC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t row_k = static_cast<int64_t>(j[u]) * k_total + k0;
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        float t = identity;
        if (ok[u] && (KC == 1 || k0 + k < k_total)) {
          t = x[row_k + k];
          if constexpr (WMODE != 0) t += add[u];
          if constexpr (FMODE == 1) {
            if (!active[u]) t = neutral;
          } else if constexpr (FMODE == 2) {
            if (frontier[row_k + k] <= 0) t = neutral;
          }
        }
        v[u][k] = t;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (c + static_cast<int64_t>(u) * stride < end) {
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          if (KC == 1 || k0 + k < k_total) {
            acc[k] = combine<RED>(acc[k], v[u][k]);
          }
        }
      }
    }
  }
}

// Lanes of one thread with loads in flight, where a thread walks more than
// kBatchAbove lanes of its row; below that the warps, not a batch, keep the
// gathers in flight, and a batch's registers would only cost occupancy.  A
// narrow-kernel thread walks at most kNarrowLanes lanes (1,024 / 32), so a
// threshold of that or more never batches, and 0 always does; only the
// kernels a threshold can pick are compiled.
template <int KC>
constexpr int kUnroll = KC == 1 ? 8 : 4;
constexpr int kBatchAbove = K5_BATCH_ABOVE;
constexpr int kNarrowLanes = 1024 / 32;

__device__ __forceinline__ int64_t clip_degree(const int32_t* deg, int64_t row,
                                               int64_t width) {
  const int64_t d = deg[row];
  return d < 0 ? 0 : (d > width ? width : d);
}

// A row's reduced lanes r -> y: padding lanes take the identity, then the
// accumulator is seeded by init (or the identity).
template <int RED, bool INIT>
__device__ __forceinline__ void finish(float r, float* __restrict__ y,
                                       const float* __restrict__ init,
                                       int64_t o, int64_t d, int64_t width,
                                       float identity) {
  // For sum the wrapper admits only identity 0, so padding adds nothing and
  // is skipped outright.
  if (RED != 0 && d < width) r = combine<RED>(r, identity);
  const float b = INIT ? init[o] : identity;
  y[o] = combine<RED>(b, r);
}

// Narrow classes: a group of `group` (8, 16 or 32) lanes per row; UNROLL is
// kUnroll, or 1 where no thread walks more than kBatchAbove lanes.
template <int RED, typename IdT, int WMODE, int FMODE, bool ALIVE, bool INIT,
          int KC, int UNROLL>
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
  const int64_t d = live ? clip_degree(deg, row, width) : 0;

  float acc[KC];
#pragma unroll
  for (int k = 0; k < KC; ++k) acc[k] = lane_start<RED>();
  walk<RED, IdT, WMODE, FMODE, ALIVE, KC, UNROLL>(
      acc, x, idx, w, frontier, alive, row * width, sub, d, group,
      num_vertices, k_total, k0, neutral, identity);

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
        finish<RED, INIT>(acc[k], y, init, row * k_total + k0 + k, d, width,
                          identity);
      }
    }
  }
}

// Wide classes (a 256-thread block per piece of a row), in two launches.
// edge_map_block_kernel: block b walks one segment of one row and writes its
// partial[b, k].  The segments are segs[b] = (row, lane_begin, lane_end),
// sorted by row, each row's in lane order from lane 0, covering [0, deg).
// fold_kernel finishes the rows.
template <int RED, typename IdT, int WMODE, int FMODE, bool ALIVE, int KC>
__global__ void __launch_bounds__(kThreads)
edge_map_block_kernel(const float* __restrict__ x,
                      const IdT* __restrict__ idx,
                      const int32_t* __restrict__ deg,
                      const float* __restrict__ w,
                      const int8_t* __restrict__ frontier,
                      const int8_t* __restrict__ alive,
                      const int32_t* __restrict__ segs,
                      float* __restrict__ partial, int64_t rows,
                      int64_t width, int64_t num_vertices, int k_total,
                      float neutral, float identity) {
  const int k0 = blockIdx.y * KC;
  const int32_t* s = segs + 3 * static_cast<int64_t>(blockIdx.x);
  const int64_t row = s[0];
  const int64_t lo = s[1] < 0 ? 0 : s[1];
  if (row < 0 || row >= rows) {
    __trap();  // a segment outside the tile: a malformed list
  }
  const int64_t d = clip_degree(deg, row, width);
  const int64_t hi = s[2] < d ? s[2] : d;

  float acc[KC];
#pragma unroll
  for (int k = 0; k < KC; ++k) acc[k] = lane_start<RED>();
  walk<RED, IdT, WMODE, FMODE, ALIVE, KC, kUnroll<KC>>(
      acc, x, idx, w, frontier, alive, row * width, lo + threadIdx.x, hi,
      kThreads, num_vertices, k_total, k0, neutral, identity);

  __shared__ float part[kWarps][KC];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v = combine<RED>(v, __shfl_down_sync(0xffffffffu, v, off));
    }
    if (lane == 0) part[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    if (KC == 1 || k0 + k < k_total) {
      float r = part[0][k];
#pragma unroll
      for (int i = 1; i < kWarps; ++i) r = combine<RED>(r, part[i][k]);
      partial[static_cast<int64_t>(blockIdx.x) * k_total + k0 + k] = r;
    }
  }
}

// fold_kernel: one thread per (segment, query lane); the thread of a row's
// first segment (lane_begin == 0) folds the row's partials in segment order
// and finishes the row.
template <int RED, bool INIT>
__global__ void __launch_bounds__(kThreads)
fold_kernel(const int32_t* __restrict__ segs, int64_t num_segs,
            const float* __restrict__ partial,
            const int32_t* __restrict__ deg, const float* __restrict__ init,
            float* __restrict__ y, int64_t width, int k_total,
            float identity) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t s = t / k_total;
  const int k = static_cast<int>(t - s * k_total);
  if (s >= num_segs || segs[3 * s + 1] != 0) return;
  const int64_t row = segs[3 * s];
  int64_t q_end = s + 1;
  while (q_end < num_segs && segs[3 * q_end] == row) ++q_end;
  float r = lane_start<RED>();
  for (int64_t q = s; q < q_end; ++q) {
    r = combine<RED>(r, partial[q * k_total + k]);
  }
  finish<RED, INIT>(r, y, init, row * k_total + k,
                    clip_degree(deg, row, width), width, identity);
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
  const void* segs;
  int64_t num_segs;
  void* partial;
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
  const unsigned chunks = static_cast<unsigned>((a.k + KC - 1) / KC);
  const float* x = static_cast<const float*>(a.x);
  const IdT* idx = static_cast<const IdT*>(a.idx);
  const int32_t* deg = static_cast<const int32_t*>(a.deg);
  const float* w = static_cast<const float*>(a.w);
  const int8_t* frontier = static_cast<const int8_t*>(a.frontier);
  const int8_t* alive = static_cast<const int8_t*>(a.alive);
  const float* init = static_cast<const float*>(a.init);
  float* y = static_cast<float*>(a.y);
  if (a.group != kThreads) {
    const int64_t threads = a.rows * a.group;
    const dim3 grid(static_cast<unsigned>((threads + kThreads - 1) / kThreads),
                    chunks);
    if constexpr (kBatchAbove > 0) {
      if (kBatchAbove >= kNarrowLanes || a.width <= kBatchAbove * a.group) {
        edge_map_kernel<RED, IdT, WMODE, FMODE, ALIVE, INIT, KC, 1>
            <<<grid, kThreads, 0, a.stream>>>(
                x, idx, deg, w, frontier, alive, init, y, a.rows, a.width,
                a.num_vertices, a.k, a.group, a.neutral, a.identity);
        return cudaGetLastError();
      }
    }
    if constexpr (kBatchAbove < kNarrowLanes) {
      edge_map_kernel<RED, IdT, WMODE, FMODE, ALIVE, INIT, KC, kUnroll<KC>>
          <<<grid, kThreads, 0, a.stream>>>(
              x, idx, deg, w, frontier, alive, init, y, a.rows, a.width,
              a.num_vertices, a.k, a.group, a.neutral, a.identity);
    }
    return cudaGetLastError();
  }
  const int32_t* segs = static_cast<const int32_t*>(a.segs);
  if (a.num_segs == 0) return cudaSuccess;
  edge_map_block_kernel<RED, IdT, WMODE, FMODE, ALIVE, KC>
      <<<dim3(static_cast<unsigned>(a.num_segs), chunks), kThreads, 0,
         a.stream>>>(x, idx, deg, w, frontier, alive, segs,
                     static_cast<float*>(a.partial), a.rows, a.width,
                     a.num_vertices, a.k, a.neutral, a.identity);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t threads = a.num_segs * a.k;
  fold_kernel<RED, INIT>
      <<<static_cast<unsigned>((threads + kThreads - 1) / kThreads), kThreads,
         0, a.stream>>>(segs, a.num_segs, static_cast<const float*>(a.partial),
                        deg, init, y, a.width, a.k, a.identity);
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

// idx_bytes: 2 (uint16 ids) or 4 (int32 ids).  group: lanes per row, 8,
// 16, 32 or 256; 256 takes the two-launch split over segs: num_segs int32
// (row, lane_begin, lane_end) triples sorted by row, each row's in lane
// order from lane 0, together covering [0, deg) of every row, with partial
// float scratch of num_segs * k.  Pointers that a mode does not read may be
// null.  Returns a cudaError_t (0 on success).
extern "C" int K5_ENTRY(const void* x, const void* idx, int idx_bytes,
                        const void* deg, const void* w, int wmode,
                        const void* frontier, int fmode, const void* alive,
                        const void* init, void* y, const void* segs,
                        int64_t num_segs, void* partial, int64_t rows,
                        int64_t width, int64_t num_vertices, int k, int group,
                        float neutral, float identity, void* stream) {
  if ((idx_bytes != 2 && idx_bytes != 4) || k < 1 ||
      (group != 8 && group != 16 && group != 32 && group != kThreads) ||
      rows < 0 || width < 1 ||
      (group == kThreads &&
       (segs == nullptr || num_segs < rows || partial == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  const Args a{x,     idx,      deg,   w,        frontier, alive,
               init,  y,        segs,  num_segs, partial,  rows,
               width, num_vertices,    k,        group,    neutral,
               identity, static_cast<cudaStream_t>(stream)};
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
