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
//    per thread (blockIdx.y walks chunks of KC when K > KC);
//  * a whole tile set is one call (K5_GROUPED), not a launch per class and
//    a combine: one edge_map_kernel launch covers up to eight narrow
//    classes that share the id width, the weight / alive planes and
//    batching, which the launch passes by value; each block finds its class
//    by a scan of the classes' first blocks (a launch of one class, as
//    ell_edge_map's always is, skips it), and every row is stored
//    straight into the vertex-space output at rows[r], seeded by
//    init[rows[r]].  A row keeps its lane group, its walk and its shuffle
//    tree, so its result is bitwise the one its class's own launch gives;
//    rows are disjoint across classes, so the store is the set-scatter the
//    combine was.  A wide class keeps its two launches, its fold storing
//    the same way.  The caller's class table (ops.py, built once per tile
//    set) holds each class's planes and shapes; how the classes are batched,
//    grouped into launches and cut into blocks is decided here, for both
//    entries alike;
//  * an unbatched narrow block of a launch of several classes walks
//    kNarrowPasses chunks of rows one after another: its rows are short (a
//    row of 8 to 128 lanes is one or a few loads a thread), so the class
//    lookup, paid once a block, is paid once for eight chunks (PERF.md,
//    section 6, times 1, 2, 4 and 8); a launch of one class has no lookup
//    and walks one chunk a block.
//
// Build: one shared library per reduction, compiled with -DK5_REDUCE=0|1|2
// (see repro_torch/kernels/_build.py); -DK5_BATCH_ABOVE=N overrides the
// batch threshold of both entries (0: always batch, 32 or more: never).
// Each C entry returns the first launch error; the launches are on the
// caller's stream and allocate nothing.
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
// threshold of that or more never batches, and 0 always does.
template <int KC>
constexpr int kUnroll = KC == 1 ? 8 : 4;
constexpr int kBatchAbove = K5_BATCH_ABOVE;
constexpr int kNarrowLanes = 1024 / 32;

// Chunks of kThreads / group rows that one narrow block walks one after
// another: kNarrowPasses where the block pays a class lookup (a launch of
// several classes) and its rows are short (unbatched), so the lookup is
// paid once for several chunks; else one, as a launch per class walks.
constexpr int kNarrowPasses = 8;
__host__ __device__ constexpr int narrow_passes(bool batched, int classes) {
  return !batched && classes > 1 ? kNarrowPasses : 1;
}

// Whether a narrow class of `width` lanes and `group` lanes per row batches
// its loads, and its blocks at `passes` chunks a block.
bool batches(int64_t width, int64_t group) {
  return kBatchAbove == 0 ||
         (kBatchAbove < kNarrowLanes &&
          width > static_cast<int64_t>(kBatchAbove) * group);
}

int64_t narrow_blocks(int64_t rows, int64_t group, int passes) {
  const int64_t per_block = static_cast<int64_t>(kThreads) * passes;
  return (rows * group + per_block - 1) / per_block;
}

__device__ __forceinline__ int64_t clip_degree(const int32_t* deg, int64_t row,
                                               int64_t width) {
  const int64_t d = deg[row];
  return d < 0 ? 0 : (d > width ? width : d);
}

// One tile class, as a row of the class table: ops.py's CLASS_FIELDS, one
// int64 each, in this order (the grouped entry checks their number).
// `rows` null: row r's result is stored at r (ell_edge_map's y); else at
// rows[r] of the vertex-space output.
struct ClassEntry {
  const void* idx;
  const int32_t* deg;
  const float* w;
  const int8_t* alive;
  const int64_t* rows;
  const int32_t* segs;   // a wide class's segment list; else null
  int64_t num_segs;
  int64_t plane_rows;    // rows of the planes (padding rows included)
  int64_t num_rows;      // rows walked and stored: the class's own
  int64_t width;
  int64_t group;         // lanes per row: 8, 16, 32, or 256 (wide)
  int64_t idx_bytes;     // 2 (uint16 ids) or 4 (int32)
};
constexpr int kFields = sizeof(ClassEntry) / sizeof(int64_t);
static_assert(sizeof(ClassEntry) == kFields * sizeof(int64_t),
              "a class is a row of int64 fields");

// A row's reduced lanes r -> y[o]: padding lanes take the identity, then
// the accumulator is seeded by init[o] (or the identity).  o is the row's
// output offset: its row in a class's y, or its vertex in the output.
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

// A row's output row o (its vertex, or the row itself in a class's own y),
// checked against the output.
__device__ __forceinline__ int64_t checked_out(int64_t o, int64_t out_rows) {
  if (o < 0 || o >= out_rows) {
    __trap();  // a row id outside the output: a malformed tile
  }
  return o;
}

// The classes one narrow launch covers, passed by value as a
// __grid_constant__ parameter: the kernel reads them from the constant
// bank, as it reads its own parameters, with no load from device memory
// and no staging.  first_block[j] is class j's first block in the launch
// (ascending from 0); kMaxClasses bounds a launch's classes and the scan
// that finds a block's class.
constexpr int kMaxClasses = 8;
struct ClassList {
  ClassEntry cls[kMaxClasses];
  int64_t first_block[kMaxClasses];
  int count;
};

// Narrow classes: a group of `group` (8, 16 or 32) lanes per row; UNROLL is
// kUnroll, or 1 where no thread walks more than kBatchAbove lanes.  The
// launch covers list.count classes, each from its first block on: a block's
// class is the last whose first block it has reached, and the block walks
// narrow_passes consecutive chunks of kThreads / group rows, each row
// exactly as a launch of that class alone would.
template <int RED, typename IdT, int WMODE, int FMODE, bool ALIVE, bool INIT,
          int KC, int UNROLL>
__global__ void __launch_bounds__(kThreads)
edge_map_kernel(const float* __restrict__ x,
                const int8_t* __restrict__ frontier,
                const float* __restrict__ init, float* __restrict__ y,
                const __grid_constant__ ClassList list, int64_t num_vertices,
                int64_t out_rows, int k_total, float neutral,
                float identity) {
  const int64_t b = blockIdx.x;
  // A one-class list (ell_edge_map's, or a grouped launch of one class)
  // skips the scan: its fields are the parameters' own.
  ClassEntry c = list.cls[0];
  int64_t first_block = 0;
  if (list.count > 1) {
#pragma unroll
    for (int j = 1; j < kMaxClasses; ++j) {
      if (j < list.count && b >= list.first_block[j]) {
        c = list.cls[j];
        first_block = list.first_block[j];
      }
    }
  }
  const int group = static_cast<int>(c.group);
  const int shift = 31 - __clz(group);  // group is a power of two
  const int sub = threadIdx.x & (group - 1);
  const int k0 = blockIdx.y * KC;
  const int passes = narrow_passes(UNROLL != 1, list.count);
  const int64_t chunk0 = (b - first_block) * passes;
#pragma unroll 1
  for (int pass = 0; pass < passes; ++pass) {
    const int64_t first = (chunk0 + pass) * kThreads;
    if ((first >> shift) >= c.num_rows) break;  // the same for the block
    const int64_t row = (first + threadIdx.x) >> shift;
    // Every lane of the warp reaches the shuffles below, so rows past the
    // end still run the tree, with no columns.
    const bool live = row < c.num_rows;
    const int64_t d = live ? clip_degree(c.deg, row, c.width) : 0;
    // Where the row's result goes, read before the walk: the load of
    // rows[row] then overlaps the walk's, and the store after the shuffles
    // waits on nothing.
    const bool stores = live && sub == 0;
    const int64_t vertex =
        !stores ? 0 : c.rows == nullptr ? row : c.rows[row];

    float acc[KC];
#pragma unroll
    for (int k = 0; k < KC; ++k) acc[k] = lane_start<RED>();
    walk<RED, IdT, WMODE, FMODE, ALIVE, KC, UNROLL>(
        acc, x, static_cast<const IdT*>(c.idx), c.w, frontier, c.alive,
        row * c.width, sub, d, group, num_vertices, k_total, k0, neutral,
        identity);

#pragma unroll
    for (int k = 0; k < KC; ++k) {
      float v = acc[k];
      for (int off = group >> 1; off > 0; off >>= 1) {
        v = combine<RED>(v, __shfl_down_sync(0xffffffffu, v, off, group));
      }
      acc[k] = v;
    }

    if (stores) {
      const int64_t o = checked_out(vertex, out_rows) * k_total + k0;
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        if (KC == 1 || k0 + k < k_total) {
          finish<RED, INIT>(acc[k], y, init, o + k, d, c.width, identity);
        }
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
// and finishes the row, if it is one of the class's num_rows (the list
// also covers the planes' padding rows).
template <int RED, bool INIT>
__global__ void __launch_bounds__(kThreads)
fold_kernel(const int32_t* __restrict__ segs, int64_t num_segs,
            const float* __restrict__ partial,
            const int32_t* __restrict__ deg, const int64_t* __restrict__ rows,
            int64_t num_rows, const float* __restrict__ init,
            float* __restrict__ y, int64_t out_rows, int64_t width,
            int k_total, float identity) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t s = t / k_total;
  const int k = static_cast<int>(t - s * k_total);
  if (s >= num_segs || segs[3 * s + 1] != 0) return;
  const int64_t row = segs[3 * s];
  if (row >= num_rows) return;
  int64_t q_end = s + 1;
  while (q_end < num_segs && segs[3 * q_end] == row) ++q_end;
  float r = lane_start<RED>();
  for (int64_t q = s; q < q_end; ++q) {
    r = combine<RED>(r, partial[q * k_total + k]);
  }
  finish<RED, INIT>(r, y, init,
                    checked_out(rows == nullptr ? row : rows[row], out_rows) *
                            k_total + k,
                    clip_degree(deg, row, width), width, identity);
}

// What one edge map passes to every launch it makes.
struct Call {
  const float* x;
  const int8_t* frontier;
  const float* init;
  float* y;
  int64_t num_vertices;
  int64_t out_rows;
  int k;
  float neutral;
  float identity;
  cudaStream_t stream;
};

template <int KC>
unsigned query_chunks(int k) {
  return static_cast<unsigned>((k + KC - 1) / KC);
}

// One launch of edge_map_kernel over `blocks` blocks of the classes of
// `list`, batched or not.
template <int RED, typename IdT, int WMODE, int FMODE, bool ALIVE, bool INIT,
          int KC>
cudaError_t launch_narrow(const Call& a, const ClassList& list,
                          int64_t blocks, bool batched) {
  const dim3 grid(static_cast<unsigned>(blocks), query_chunks<KC>(a.k));
  if (batched) {
    edge_map_kernel<RED, IdT, WMODE, FMODE, ALIVE, INIT, KC, kUnroll<KC>>
        <<<grid, kThreads, 0, a.stream>>>(a.x, a.frontier, a.init, a.y, list,
                                          a.num_vertices, a.out_rows, a.k,
                                          a.neutral, a.identity);
  } else {
    edge_map_kernel<RED, IdT, WMODE, FMODE, ALIVE, INIT, KC, 1>
        <<<grid, kThreads, 0, a.stream>>>(a.x, a.frontier, a.init, a.y, list,
                                          a.num_vertices, a.out_rows, a.k,
                                          a.neutral, a.identity);
  }
  return cudaGetLastError();
}

// A wide class's two launches: its segments' blocks, then the fold.
template <int RED, typename IdT, int WMODE, int FMODE, bool ALIVE, bool INIT,
          int KC>
cudaError_t launch_wide(const Call& a, const ClassEntry& c, float* partial) {
  if (c.num_segs == 0) return cudaSuccess;
  edge_map_block_kernel<RED, IdT, WMODE, FMODE, ALIVE, KC>
      <<<dim3(static_cast<unsigned>(c.num_segs), query_chunks<KC>(a.k)),
         kThreads, 0, a.stream>>>(
          a.x, static_cast<const IdT*>(c.idx), c.deg, c.w, a.frontier,
          c.alive, c.segs, partial, c.plane_rows, c.width, a.num_vertices,
          a.k, a.neutral, a.identity);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t threads = c.num_segs * a.k;
  fold_kernel<RED, INIT>
      <<<static_cast<unsigned>((threads + kThreads - 1) / kThreads), kThreads,
         0, a.stream>>>(c.segs, c.num_segs, partial, c.deg, c.rows,
                        c.num_rows, a.init, a.y, a.out_rows, c.width, a.k,
                        a.identity);
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

// The launches of the classes of `list`: one wide class's two, or one
// narrow launch of `blocks` blocks, with the first class's modes as
// template arguments.
cudaError_t launch(const Call& a, const ClassList& list, int64_t blocks,
                   bool batched, int wmode, int fmode, float* partial) {
  const ClassEntry& c = list.cls[0];
  return pick_bool(c.idx_bytes == 2, [&](auto u16) {
    using IdT = std::conditional_t<decltype(u16)::value, uint16_t, int32_t>;
    return pick3(wmode, [&](auto wm) {
      return pick3(fmode, [&](auto fm) {
        return pick_bool(c.alive != nullptr, [&](auto al) {
          return pick_bool(a.init != nullptr, [&](auto in) {
            return pick_bool(a.k == 1, [&](auto one) {
              constexpr int W = decltype(wm)::value, F = decltype(fm)::value;
              constexpr bool A = decltype(al)::value, I = decltype(in)::value;
              constexpr int KC = decltype(one)::value ? 1 : 8;
              if (c.group == kThreads) {
                return launch_wide<K5_REDUCE, IdT, W, F, A, I, KC>(a, c,
                                                                  partial);
              }
              return launch_narrow<K5_REDUCE, IdT, W, F, A, I, KC>(
                  a, list, blocks, batched);
            });
          });
        });
      });
    });
  });
}

bool valid_group(int64_t group) {
  return group == 8 || group == 16 || group == 32 || group == kThreads;
}

}  // namespace

#if K5_REDUCE == 0
#define K5_ENTRY k5_edge_map_sum
#define K5_GROUPED k5_grouped_sum
#elif K5_REDUCE == 1
#define K5_ENTRY k5_edge_map_min
#define K5_GROUPED k5_grouped_min
#else
#define K5_ENTRY k5_edge_map_max
#define K5_GROUPED k5_grouped_max
#endif

// One tile class into its own y (ell_edge_map).  idx_bytes: 2 (uint16
// ids) or 4 (int32 ids).  group: lanes per row, 8, 16, 32 or 256; 256
// takes the two-launch split over segs: num_segs int32 (row, lane_begin,
// lane_end) triples sorted by row, each row's in lane order from lane 0,
// together covering [0, deg) of every row, with partial float scratch of
// num_segs * k.  Pointers that a mode does not read may be null.  Returns
// a cudaError_t (0 on success).
extern "C" int K5_ENTRY(const void* x, const void* idx, int idx_bytes,
                        const void* deg, const void* w, int wmode,
                        const void* frontier, int fmode, const void* alive,
                        const void* init, void* y, const void* segs,
                        int64_t num_segs, void* partial, int64_t rows,
                        int64_t width, int64_t num_vertices, int k, int group,
                        float neutral, float identity, void* stream) {
  if ((idx_bytes != 2 && idx_bytes != 4) || k < 1 || !valid_group(group) ||
      rows < 0 || width < 1 ||
      (group == kThreads &&
       (segs == nullptr || num_segs < rows || partial == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  ClassList list{};
  list.cls[0] = ClassEntry{idx,      static_cast<const int32_t*>(deg),
                           static_cast<const float*>(w),
                           static_cast<const int8_t*>(alive),
                           nullptr,  static_cast<const int32_t*>(segs),
                           num_segs, rows, rows, width, group, idx_bytes};
  list.count = 1;
  const Call a{static_cast<const float*>(x),
               static_cast<const int8_t*>(frontier),
               static_cast<const float*>(init), static_cast<float*>(y),
               num_vertices, rows, k, neutral, identity,
               static_cast<cudaStream_t>(stream)};
  const bool batched = batches(width, group);
  return static_cast<int>(launch(a, list,
                                 narrow_blocks(rows, group,
                                               narrow_passes(batched, 1)),
                                 batched, wmode, fmode,
                                 static_cast<float*>(partial)));
}

// Every class of a tile set straight into the vertex-space output y
// (out_rows rows, k floats each), from its class table (ops.py's
// build_class_table): `classes` rows of `fields` int64 each, ClassEntry's
// fields in its order.  Narrow classes that share the id width, the weight
// and alive planes and batching share a launch, up to kMaxClasses in the
// table's order; each wide class takes its two launches, its partials at
// the next of the partial_rows rows of partial.  use_weights: 0, or 1 for
// each class's weight plane (+1 where it has none).  init is the
// (out_rows, k) seed or null.  *launches is set to the kernels launched.
extern "C" int K5_GROUPED(const void* table, int classes, int fields,
                          const void* x, const void* frontier, int fmode,
                          const void* init, void* y, void* partial,
                          int64_t partial_rows, int use_weights,
                          int64_t num_vertices, int64_t out_rows, int k,
                          float neutral, float identity, int* launches,
                          void* stream) {
  if (fields != kFields || classes < 0 || k < 1 || launches == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *launches = 0;
  const ClassEntry* cls = static_cast<const ClassEntry*>(table);
  const Call a{static_cast<const float*>(x),
               static_cast<const int8_t*>(frontier),
               static_cast<const float*>(init), static_cast<float*>(y),
               num_vertices, out_rows, k, neutral, identity,
               static_cast<cudaStream_t>(stream)};
  // The narrow launches being filled, one per kind: id width, weight
  // plane, alive plane, batching.
  constexpr int kKinds = 16;
  ClassList open[kKinds];
  for (ClassList& l : open) l.count = 0;
  int64_t next_partial = 0;
  auto flush = [&](int kind) {
    ClassList& l = open[kind];
    const bool batched = kind >> 3;
    const int passes = narrow_passes(batched, l.count);
    int64_t blocks = 0;
    for (int j = 0; j < l.count; ++j) {
      l.first_block[j] = blocks;
      blocks += narrow_blocks(l.cls[j].num_rows, l.cls[j].group, passes);
    }
    const cudaError_t err =
        launch(a, l, blocks, batched, use_weights ? (l.cls[0].w ? 2 : 1) : 0,
               fmode, nullptr);
    *launches += 1;
    l.count = 0;
    return err;
  };
  for (int i = 0; i < classes; ++i) {
    const ClassEntry& c = cls[i];
    const bool wide = c.group == kThreads;
    if ((c.idx_bytes != 2 && c.idx_bytes != 4) || !valid_group(c.group) ||
        c.num_rows < 0 || c.num_rows > c.plane_rows || c.width < 1 ||
        (wide && (c.segs == nullptr || partial == nullptr ||
                  next_partial + c.num_segs > partial_rows))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (c.num_rows == 0) continue;
    cudaError_t err = cudaSuccess;
    if (wide) {
      ClassList one{};
      one.cls[0] = c;
      one.count = 1;
      err = launch(a, one, c.num_segs, false,
                   use_weights ? (c.w ? 2 : 1) : 0, fmode,
                   static_cast<float*>(partial) + next_partial * k);
      next_partial += c.num_segs;
      *launches += c.num_segs ? 2 : 0;
    } else {
      const bool batched = batches(c.width, c.group);
      const int kind = (c.idx_bytes == 2) | (c.w != nullptr) << 1 |
                       (c.alive != nullptr) << 2 | batched << 3;
      ClassList& l = open[kind];
      l.cls[l.count] = c;
      l.count += 1;
      if (l.count == kMaxClasses) err = flush(kind);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  for (int kind = 0; kind < kKinds; ++kind) {
    if (open[kind].count == 0) continue;
    const cudaError_t err = flush(kind);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
