// DBG binning (hist_bin) and its stable rank, written by hand for Hopper
// (sm_90a).  Steps 1-3 of the paper's Listing 1 on the device, in two
// kernels over one tiling of the vertices: tile t is vertices
// [t * kTile, (t + 1) * kTile), one block each.
//
// bin_kernel replaces the TPU kernel `hist_bin_pallas` in
// src/repro/kernels/hist_bin/hist_bin.py:49 (kernel body `_kernel` :25).  For
// every vertex v
//
//   groups[v] = the first k with deg[v] >= bounds[k], or 0 when none does
//               (the TPU kernel's argmax over the >= mask)
//   hist[k]   = the number of vertices in group k
//
// with 1 <= K <= 32 bounds in any order.  It also writes
//
//   tiles[t][k] = the number of group-k vertices in the tiles before t
//
// (tiles is (T, kp), kp = K rounded up to a power of two; columns past K
// hold 0).  A second instance
// (kFromDegrees = false) takes the groups as given and writes only hist and
// tiles: the first pass of a stable mapping from groups alone.
//
// rank_kernel is the stable mapping (Listing 1 step 3) that the JAX package
// computes in XLA outside its kernel (src/repro/kernels/hist_bin/ops.py:30,
// `stable_mapping_from_groups`): a vertex's new id is
//
//   mapping[v] = start[g] + tiles[tile(v)][g]
//                + #{u in tile(v), u < v, groups[u] == g}
//
// with g = groups[v] and start[g] = hist[0] + ... + hist[g - 1], as int64:
// the vertices of group 0 first, each group in
// vertex order, which is the host `group_reorder` mapping bit for bit.
//
// What bounds them on the H100: bytes.  bin_kernel reads 4 bytes of degree
// and writes 4 of group per vertex, against at most K compares; rank_kernel
// reads the 4-byte group and writes the 8-byte id.  The two together move
// 20 bytes a vertex, where the least is 16 (degree in, group and id out).
//
// What the design does about it:
//  * a fixed tile of 4,096 vertices per block (512 blocks at 2^21: every
//    block is resident at once), 16 vertices per thread, all loads issued
//    before any use;
//  * bin_kernel reads and writes int4 over the tile in warp-coalesced
//    order, 512 contiguous bytes per warp instruction (scalar accesses at a
//    ragged tile end or an unaligned pointer);
//  * groups are found without branches: the bounds from last to first,
//    each a compare and a select, over the 16 vertices a thread holds;
//  * counts are per thread, in shared memory laid out [group][thread]: a
//    thread's counters sit in its lane's bank, so no two lanes of a warp
//    meet on a bank and no atomic is needed (82% of the vertices fall in
//    one bin, where the old kernel's shared atomics serialized);
//  * a block's counts are summed per warp (`__reduce_add_sync`) and then
//    over the warps in order into tiles[t][k]; the last block to finish,
//    by an integer ticket, folds the tiles in tile order into hist and the
//    exclusive prefix of every group over the tiles.  So the kernel writes
//    its own histogram: no memset, one device operation.  The ticket is a
//    counter the wrapper keeps per stream; the last block resets it.  The fold
//    reads the (T, kp) counts coalesced, 4,096 per round trip to L2 (all of
//    them at 2^21 vertices and K = 8), and scans them with shuffles; only
//    the counts wait on the fence before the ticket, the groups are stored
//    after it.  This combine across the grid (ticket, fence, fold) is what
//    the kernel spends beyond a plain load, bin, count and store.  Built
//    with -DHIST_BIN_TWO_OPS=1 (a comparison build of the hist_bin entry
//    alone) the histogram instead comes from a memset and K atomics per
//    block, and the tiles are not written;
//  * rank_kernel stages the tile's groups through shared memory (coalesced
//    in, 16 consecutive vertices per thread out), counts per thread as
//    above, takes each group's exclusive scan over the threads (warp
//    shuffles, then the warps in order), then walks its 16 vertices in
//    order; the ids go back through shared memory so that each warp stores
//    256 contiguous bytes.
// Every count and prefix is an exact integer, so the outputs do not depend
// on the order in which blocks run.  V < 2^31 (the ids are int32 until the
// store).
//
// The C entries return cudaGetLastError() after the launch; each launch is
// on the caller's stream and allocates nothing.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 16;
constexpr int kTile = kThreads * kPerThread;  // 4,096 vertices per block
constexpr int kQuads = kPerThread / 4;        // int4 accesses per thread
constexpr int kMaxBins = 32;
constexpr unsigned kFull = 0xffffffffu;

#ifndef HIST_BIN_TWO_OPS
#define HIST_BIN_TWO_OPS 0
#endif
// the comparison build: a memset, then K atomics per block into hist
constexpr bool kTwoOps = HIST_BIN_TWO_OPS != 0;

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// A tile's row of counts is K wide rounded up to a power of two, kp, so
// that kp divides 32 and a thread of the fold always meets the same group.
__host__ __device__ constexpr int padded_bins(int k) {
  int kp = 1;
  while (kp < k) kp <<= 1;
  return kp;
}

constexpr int kFoldRows = 16;  // rows of kThreads counts per fold round

// The last block's fold.  tiles is (num_tiles, kp) int32, read as rows of
// kThreads counts: count f = r * kThreads + tid is group tid % kp of tile
// f / kp, so thread tid always meets group tid % kp, and the tiles run in
// the order (row, warp, lane / kp).  hist[k] = the sum of group k's counts,
// and each count becomes its group's count in the tiles before its own.  A
// round loads kFoldRows rows at once (coalesced: one round trip
// to L2), scans each within the warp (shuffles by multiples of kp) and
// over the warps (shared memory), and carries the totals on.
__device__ void fold_tiles(int32_t* __restrict__ tiles, int num_tiles, int k,
                           int kp, int32_t* __restrict__ hist,
                           int32_t* scratch) {  // kMaxBins * kThreads ints
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = tid % kp;
  int32_t* within = scratch;                       // [row][thread]
  int32_t* wtot = scratch + kFoldRows * kThreads;  // [row][warp][group]
  const int64_t total = static_cast<int64_t>(num_tiles) * kp;
  int carry = 0;  // group b's count in the rows before this round
  for (int64_t r0 = 0; r0 * kThreads < total; r0 += kFoldRows) {
    const int32_t* src = tiles + r0 * kThreads + tid;
    const int64_t left = total - r0 * kThreads - tid;  // counts from src on
    int c[kFoldRows];
#pragma unroll
    for (int i = 0; i < kFoldRows; ++i) {
      c[i] = i * kThreads < left ? __ldcg(src + i * kThreads) : 0;
    }
#pragma unroll
    for (int i = 0; i < kFoldRows; ++i) {
      int s = c[i];
      for (int o = kp; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(kFull, s, o);
        if (lane >= o) s += u;
      }
      within[i * kThreads + tid] = s - c[i];  // this warp's earlier tiles
      if (lane >= 32 - kp) wtot[(i * kWarps + warp) * kp + b] = s;
    }
    __syncthreads();
    for (int i = 0; i < kFoldRows; ++i) {
      int before = carry + within[i * kThreads + tid];
      for (int w = 0; w < kWarps; ++w) {
        const int s = wtot[(i * kWarps + w) * kp + b];
        if (w < warp) before += s;
        carry += s;
      }
      if (i * kThreads < left) {
        tiles[r0 * kThreads + tid + i * kThreads] = before;
      }
    }
    __syncthreads();  // within and wtot are rewritten by the next round
  }
  if (tid < k) hist[tid] = carry;
}

// One block per tile.  kFromDegrees: `in` holds degrees, groups are written;
// else `in` holds groups (clamped to [0, k)) and nothing per vertex is
// written.  vec: `in` and `groups` are 16-byte aligned.
// At least 4 blocks per SM (64 registers), so that the 512 tiles of 2^21
// vertices are resident at once.
template <bool kFromDegrees>
__global__ void __launch_bounds__(kThreads, 4)
bin_kernel(const int32_t* __restrict__ in, const int32_t* __restrict__ bounds,
           int k, int32_t* __restrict__ groups, int32_t* __restrict__ hist,
           int32_t* __restrict__ tiles, unsigned* __restrict__ ticket,
           int64_t n, bool vec) {
  __shared__ int32_t sb[kMaxBins];
  __shared__ int32_t cnt[kMaxBins * kThreads];  // [group][thread]
  __shared__ int32_t wsum[kMaxBins][kWarps];
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  const int m = n - base < kTile ? static_cast<int>(n - base) : kTile;
  if (kFromDegrees && tid < k) sb[tid] = bounds[tid];
  for (int b = 0; b < k; ++b) cnt[b * kThreads + tid] = 0;

  // slot (q, j) of this thread is vertex base + 4 * (q * kThreads + tid) + j
  int v[kQuads][4];
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
    const int e = 4 * (q * kThreads + tid);
    if (vec && e + 4 <= m) {
      const int4 x = *reinterpret_cast<const int4*>(in + base + e);
      v[q][0] = x.x;
      v[q][1] = x.y;
      v[q][2] = x.z;
      v[q][3] = x.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[q][j] = e + j < m ? in[base + e + j] : 0;
    }
  }
  __syncthreads();  // sb

  int g[kQuads][4];
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      g[q][j] = kFromDegrees ? 0 : min(max(v[q][j], 0), k - 1);
    }
  }
  if (kFromDegrees) {
    for (int b = k - 1; b >= 0; --b) {  // the first matching bound wins
      const int32_t bound = sb[b];
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
#pragma unroll
        for (int j = 0; j < 4; ++j) g[q][j] = v[q][j] >= bound ? b : g[q][j];
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
    const int e = 4 * (q * kThreads + tid);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (e + j < m) cnt[g[q][j] * kThreads + tid] += 1;
    }
  }
  __syncthreads();

  for (int b = 0; b < k; ++b) {
    const int s = __reduce_add_sync(kFull, cnt[b * kThreads + tid]);
    if (lane == 0) wsum[b][warp] = s;
  }
  __syncthreads();
  // publish this tile's counts (zero past k), then take a ticket: the last
  // block folds.  Thread 0 fences after the barrier (a release of the
  // block's counts, as a grid-wide barrier does it) before its ticket, and
  // the last block fences after it (an acquire of every block's counts).
  // Only the counts wait on the fence: the groups are stored after it, and
  // the kernel's end orders them.  (The comparison build adds the block's
  // counts to hist instead.)
  const int kp = padded_bins(k);
  if (kTwoOps) {
    if (tid < k) {
      int s = 0;
      for (int w = 0; w < kWarps; ++w) s += wsum[tid][w];
      atomicAdd(hist + tid, s);
    }
  } else {
    if (tid < kp) {
      int s = 0;
      if (tid < k) {
        for (int w = 0; w < kWarps; ++w) s += wsum[tid][w];
      }
      tiles[static_cast<int64_t>(blockIdx.x) * kp + tid] = s;
    }
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      last = atomicAdd(ticket, 1u) == gridDim.x - 1;
      if (last) {
        *ticket = 0;  // every other block has taken its ticket
        __threadfence();
      }
    }
  }
  if (kFromDegrees) {
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      const int e = 4 * (q * kThreads + tid);
      if (vec && e + 4 <= m) {
        *reinterpret_cast<int4*>(groups + base + e) =
            make_int4(g[q][0], g[q][1], g[q][2], g[q][3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (e + j < m) groups[base + e + j] = g[q][j];
        }
      }
    }
  }
  if (kTwoOps) return;
  __syncthreads();
  if (!last) return;
  fold_tiles(tiles, gridDim.x, k, kp, hist, cnt);
}

// Dynamic shared memory of rank_kernel: the staging area (the tile's
// groups as int32, then its ids as int64, one padding slot per thread
// row), the counters [group][thread], the warps' totals and bases and
// the tile's first id of every group.
__host__ __device__ constexpr int rank_smem_bytes(int k) {
  return (kTile + kThreads) * 8 + k * kThreads * 4 + 2 * k * kWarps * 4 +
         k * 4;
}

// group staging index: one padding word per 32, so that both the
// coalesced writes and the per-thread reads of 16 words miss no bank
__device__ __forceinline__ int pad32(int x) { return x + (x >> 5); }

__global__ void __launch_bounds__(kThreads)
rank_kernel(const int32_t* __restrict__ groups, int k,
            const int32_t* __restrict__ hist, const int32_t* __restrict__ tiles,
            int64_t* __restrict__ mapping, int64_t n, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* stage = reinterpret_cast<int64_t*>(smem);
  int32_t* gstage = reinterpret_cast<int32_t*>(smem);  // before `stage`
  int32_t* cnt = reinterpret_cast<int32_t*>(stage + kTile + kThreads);
  int32_t* wtot = cnt + k * kThreads;  // [group][warp]
  int32_t* wbase = wtot + k * kWarps;  // [warp][group]: a bank per group
  int32_t* first = wbase + k * kWarps;  // the tile's first id of each group
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  const int m = n - base < kTile ? static_cast<int>(n - base) : kTile;

  // 0. (warp 0, beside the loads below) the start of every group, an
  //    exclusive scan of hist, plus the group's count in earlier tiles
  if (warp == 0) {
    const int h = lane < k ? hist[lane] : 0;
    const int before =
        lane < k ? tiles[static_cast<int64_t>(blockIdx.x) * padded_bins(k) +
                         lane]
                 : 0;
    const int start = warp_inclusive_scan(h, lane) - h;
    if (lane < k) first[lane] = start + before;
  }

  // 1. the tile's groups: coalesced into shared memory, then the thread's
  //    16 consecutive vertices 16 * tid .. 16 * tid + 15 out of it
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
    const int e = 4 * (q * kThreads + tid);
    int x[4];
    if (vec && e + 4 <= m) {
      const int4 w = *reinterpret_cast<const int4*>(groups + base + e);
      x[0] = w.x;
      x[1] = w.y;
      x[2] = w.z;
      x[3] = w.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = e + j < m ? groups[base + e + j] : 0;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) gstage[pad32(e + j)] = x[j];
  }
  for (int b = 0; b < k; ++b) cnt[b * kThreads + tid] = 0;
  __syncthreads();
  int g[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    g[i] = min(max(gstage[pad32(kPerThread * tid + i)], 0), k - 1);
  }
  const int mine = min(max(m - kPerThread * tid, 0), kPerThread);
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    if (i < mine) cnt[g[i] * kThreads + tid] += 1;
  }
  __syncthreads();  // the counters are complete; gstage is free

  // 2. per group: the exclusive scan of the counts over the threads
  for (int b = 0; b < k; ++b) {
    int32_t* c = cnt + b * kThreads + tid;
    const int own = *c;
    const int incl = warp_inclusive_scan(own, lane);
    if (lane == 31) wtot[b * kWarps + warp] = incl;
    *c = incl - own;
  }
  __syncthreads();
  if (tid < k * kWarps) {
    const int b = tid / kWarps, w = tid % kWarps;
    int s = first[b];
    for (int u = 0; u < w; ++u) s += wtot[b * kWarps + u];
    wbase[w * k + b] = s;
  }
  __syncthreads();

  // 3. the thread's vertices in order: each takes the next id of its group
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    if (i < mine) {
      int32_t* c = cnt + g[i] * kThreads + tid;
      const int rank = *c;
      *c = rank + 1;
      stage[(kPerThread + 1) * tid + i] = wbase[warp * k + g[i]] + rank;
    }
  }
  __syncthreads();

  // 4. coalesced stores: 32 consecutive ids per warp instruction
  for (int x = tid; x < m; x += kThreads) {
    mapping[base + x] = stage[x + x / kPerThread];
  }
}

int64_t num_tiles(int64_t n) { return n <= 0 ? 1 : (n + kTile - 1) / kTile; }

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

bool bad_args(int k, int64_t n, int64_t tiles_len) {
  return k < 1 || k > kMaxBins || n < 0 || n > INT32_MAX ||
         tiles_len < num_tiles(n) * padded_bins(k);
}

}  // namespace

// deg, groups: (n,) int32; bounds: (k,) int32, 1 <= k <= 32; hist: (k,)
// int32; tiles: int32 scratch of at least ceil(n / 4096) * kp entries,
// which holds each tile's offsets on return; ticket: one uint32, zero
// between calls (the kernel leaves it so), which no call on another stream
// shares.  n of 0 still launches one empty tile, which writes the zero
// histogram.
extern "C" int hist_bin(const void* deg, const void* bounds, int k,
                        void* groups, void* hist, void* tiles,
                        int64_t tiles_len, void* ticket, int64_t n,
                        void* stream) {
  if (bad_args(k, n, tiles_len)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kTwoOps) {
    const cudaError_t err = cudaMemsetAsync(hist, 0, k * sizeof(int32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  bin_kernel<true><<<static_cast<unsigned>(num_tiles(n)), kThreads, 0, s>>>(
      static_cast<const int32_t*>(deg), static_cast<const int32_t*>(bounds), k,
      static_cast<int32_t*>(groups), static_cast<int32_t*>(hist),
      static_cast<int32_t*>(tiles), static_cast<unsigned*>(ticket), n,
      aligned(deg) && aligned(groups));
  return static_cast<int>(cudaGetLastError());
}

// hist and each tile's offsets (as hist_bin writes them) of groups given
// as (n,) int32 values in [0, k).
extern "C" int group_tiles(const void* groups, int k, void* hist, void* tiles,
                           int64_t tiles_len, void* ticket, int64_t n,
                           void* stream) {
  if (bad_args(k, n, tiles_len)) return static_cast<int>(cudaErrorInvalidValue);
  bin_kernel<false><<<static_cast<unsigned>(num_tiles(n)), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(groups), nullptr, k, nullptr,
      static_cast<int32_t*>(hist), static_cast<int32_t*>(tiles),
      static_cast<unsigned*>(ticket), n, aligned(groups));
  return static_cast<int>(cudaGetLastError());
}

// mapping: (n,) int64 from groups (n,) int32 in [0, k), and the histogram
// and tile offsets that hist_bin or group_tiles wrote for the same n and k.
extern "C" int stable_rank(const void* groups, int k, const void* hist,
                           const void* tiles, int64_t tiles_len,
                           void* mapping, int64_t n, void* stream) {
  if (bad_args(k, n, tiles_len)) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = rank_smem_bytes(k);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  rank_kernel<<<static_cast<unsigned>(num_tiles(n)), kThreads, bytes,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(groups), k,
      static_cast<const int32_t*>(hist), static_cast<const int32_t*>(tiles),
      static_cast<int64_t*>(mapping), n, aligned(groups));
  return static_cast<int>(cudaGetLastError());
}

// vertices per tile (the Python wrapper sizes its scratch with it)
extern "C" int hist_bin_tile() { return kTile; }
