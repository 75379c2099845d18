// Absorbed MLA decode attention over a bf16 or float32 latent cache, written
// by hand for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package decodes MLA by re-expanding the whole
// latent cache into keys and values every step, outside any kernel.  This is
// DeepSeek-V2's absorbed decode: with k_up folded into the query and v_up into
// the output, one token of sequence b attends straight over its cached rows,
//
//   s[h, t] = (q_lat[b, h] . latent[b, t] + q_rope[b, h] . krope[b, t]) * scale
//   o[b, h] = sum_t softmax_t(s[h, t]) latent[b, t]          t in [0, rows[b])
//
// with a latent row of 512 and a rope key of 64 (one row: 576 bf16, 1,152 B)
// shared by every head, and o the (B, H, 512) latent output that v_up takes.
//
// What bounds it on the H100: bytes.  Each row is read once for all H <= 16
// heads; per row that is 16 x (576 + 512) multiply-adds against 1,152 B, about
// 30 operations a byte: CUDA cores at 67 TFLOP/s would fall behind 3.35 TB/s,
// the tensor cores (989 TFLOP/s in bf16) do not.
//
// What the design does about it:
//  * one block reads one slice of one sequence's rows, tiles of 64 rows
//    brought into shared memory by cp.async two tiles ahead of the math, and
//    stops at the sequence's own length (rows past it are never read);
//  * the heads are the 16 rows of mma.sync m16n8k16 (bf16 in, fp32
//    accumulation): scores are Q (16 x 576) by the tile's rows, the output
//    P (16 x 64) by the tile's latent rows, the operands taken by ldmatrix
//    from rows padded to 1,168 B so that no two lanes hit one bank;
//  * an online softmax in fp32 per head (base 2, the scale folded in), with
//    the probabilities rounded to bf16 for the second product and summed as
//    rounded, so the weights and their sum agree;
//  * long caches are split over the SMs (flash decoding): 32 sequences alone
//    would fill a quarter of the 132 SMs.  Each block writes its unnormalised
//    output, running max and sum; a second kernel combines the slices of
//    each (sequence, head) and writes o in bf16.
//
// A float32 cache (the port's float32 models, at any latent width up to 512
// and rope width up to 64) takes a variant of the split kernel on the CUDA
// cores, fp32 throughout, in tiles of 32 rows: one lane per row for the
// scores, the rows padded by one float (577 at DeepSeek-V2's widths) so that
// no two lanes hit one bank.  Its slices are combined by the same kernel,
// which then writes o in float32.
//
// Each C entry returns cudaGetLastError() after its launches; they are on the
// caller's stream and allocate nothing (the wrapper hands the scratch).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kHeads = 16;    // the mma's 16 rows; fewer heads are padded
constexpr int kLatent = 512;  // latent row (kv_lora)
constexpr int kRope = 64;     // rotated key row (qk_rope)
constexpr int kDim = kLatent + kRope;
constexpr int kTile = 64;  // cache rows per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStride = kDim + 8;   // shared row, bf16: 1,168 B
constexpr int kSStride = kTile + 4; // scores, fp32
constexpr int kPStride = kTile + 8; // probabilities, bf16: 144 B
constexpr int kStages = 2;
constexpr int kChunks = kDim / 8;   // 16-byte pieces of a row: 64 + 8

constexpr size_t kTileBytes = size_t(kTile) * kStride * 2;
constexpr size_t kSmemBytes = kStages * kTileBytes + size_t(kHeads) * kStride * 2 +
                              size_t(kHeads) * kSStride * 4 +
                              size_t(kHeads) * kPStride * 2 + kHeads * 4;

// the float32 variant
constexpr int kF32Tile = 32;  // one row per lane
constexpr int kF32Threads = 256;  // 8 warps: heads w and w + 8 each
// shared memory at the widest rows (a shared row of kDim + 1 floats)
constexpr size_t kF32SmemBytes =
    (size_t(kF32Tile) * (kDim + 1) + size_t(kHeads) * kDim +
     size_t(kHeads) * kF32Tile + kHeads) * 4;

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulation.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [row0, row0 + kTile) of sequence b into one stage; rows at or past
// `end` are zero-filled (never read), so a masked row adds 0 x 0.
__device__ __forceinline__ void load_tile(__nv_bfloat16* stage,
                                          const __nv_bfloat16* latent,
                                          const __nv_bfloat16* krope,
                                          int64_t row0, int64_t end) {
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const int64_t row = row0 + r;
    const bool live = row < end;
    const int64_t at = live ? row : row0;
    const __nv_bfloat16* src = c < kLatent / 8
                                   ? latent + at * kLatent + c * 8
                                   : krope + at * kRope + (c - kLatent / 8) * 8;
    cp_async16(stage + r * kStride + c * 8, src, live);
  }
}

// Block (split, b): rows [split * chunk, min((split + 1) * chunk, rows[b]))
// of sequence b, every head.  Writes the slice's unnormalised output
// o_part[b, split] (H x 512, fp32) and its running max (base 2) and sum.
__global__ void __launch_bounds__(kThreads, 1)
mla_decode_split_kernel(const __nv_bfloat16* __restrict__ q_lat, int64_t ql_sb,
             int64_t ql_sh, const __nv_bfloat16* __restrict__ q_rope,
             int64_t qr_sb, int64_t qr_sh,
             const __nv_bfloat16* __restrict__ cache_latent,
             const __nv_bfloat16* __restrict__ cache_krope, int64_t s_max,
             const int64_t* __restrict__ rows, int heads, int /*latent*/,
             int /*rope*/, float scale_log2, int chunk,
             float* __restrict__ o_part, float* __restrict__ m_part,
             float* __restrict__ l_part) {
  // the widths are kLatent and kRope (the entry checks them)
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* qs = ks + kStages * kTile * kStride;
  float* ss = reinterpret_cast<float*>(qs + kHeads * kStride);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(ss + kHeads * kSStride);
  float* alpha_s = reinterpret_cast<float*>(ps + kHeads * kPStride);

  const int split = blockIdx.x;
  const int b = blockIdx.y;
  const int splits = gridDim.x;
  const int64_t n = rows[b];
  const int64_t begin = int64_t(split) * chunk;
  if (begin >= n) return;  // the combine reads only the live slices
  const int64_t end = begin + chunk < n ? begin + chunk : n;
  const int tiles = static_cast<int>((end - begin + kTile - 1) / kTile);
  const __nv_bfloat16* latent = cache_latent + int64_t(b) * s_max * kLatent;
  const __nv_bfloat16* krope = cache_krope + int64_t(b) * s_max * kRope;

  load_tile(ks, latent, krope, begin, end);
  cp_async_commit();

  // the query: [q_lat | q_rope] per head, zero rows past `heads`
  for (int i = threadIdx.x; i < kHeads * kDim; i += kThreads) {
    const int h = i / kDim;
    const int c = i % kDim;
    __nv_bfloat16 v = __float2bfloat16(0.0f);
    if (h < heads) {
      v = c < kLatent ? q_lat[int64_t(b) * ql_sb + int64_t(h) * ql_sh + c]
                      : q_rope[int64_t(b) * qr_sb + int64_t(h) * qr_sh +
                               (c - kLatent)];
    }
    qs[h * kStride + c] = v;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;    // the mma's row group
  const int tig = lane % 4;  // thread in group
  // softmax roles: 8 threads per head, 8 of the tile's rows each
  const int sm_head = threadIdx.x / 8;
  const int sm_part = threadIdx.x % 8;
  float m_run = neg_inf();  // this head's running max (base 2) and sum
  float l_run = 0.0f;

  float o[16][4];  // this warp's 128 output columns, 16 n8 tiles
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) o[j][i] = 0.0f;
  }

  for (int t = 0; t < tiles; ++t) {
    const int64_t row0 = begin + int64_t(t) * kTile;
    if (t + 1 < tiles) {
      load_tile(ks + ((t + 1) % kStages) * kTile * kStride, latent, krope,
                row0 + kTile, end);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* tile = ks + (t % kStages) * kTile * kStride;

    // scores: this warp's 16 rows of the tile (two n8 tiles), two
    // accumulators per tile over even and odd k steps
    float acc[2][2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][p][i] = 0.0f;
      }
    }
    const __nv_bfloat16* qa = qs + (lane % 16) * kStride + (lane / 16) * 8;
    const __nv_bfloat16* kb = tile +
                              (warp * 16 + (lane / 16) * 8 + lane % 8) * kStride +
                              ((lane / 8) % 2) * 8;
#pragma unroll 2
    for (int k0 = 0; k0 < kDim; k0 += 32) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t a[4], bb[4];
        ldmatrix_x4(a, qa + k0 + p * 16);
        ldmatrix_x4(bb, kb + k0 + p * 16);
        mma(acc[0][p], a, bb[0], bb[1]);
        mma(acc[1][p], a, bb[2], bb[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = g + (i / 2) * 8;
        const int r = warp * 16 + j * 8 + tig * 2 + (i % 2);
        const float s = (acc[j][0][i] + acc[j][1][i]) * scale_log2;
        ss[h * kSStride + r] = row0 + r < end ? s : neg_inf();
      }
    }
    __syncthreads();

    // online softmax, per head over the tile's 64 rows
    {
      float v[8];
      float mx = neg_inf();
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[i] = ss[sm_head * kSStride + sm_part * 8 + i];
        mx = fmaxf(mx, v[i]);
      }
#pragma unroll
      for (int off = 1; off < 8; off *= 2) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m_run, mx);  // finite: a tile has a live row
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const __nv_bfloat16 p = __float2bfloat16(exp2f(v[i] - m_new));
        ps[sm_head * kPStride + sm_part * 8 + i] = p;
        sum += __bfloat162float(p);
      }
#pragma unroll
      for (int off = 1; off < 8; off *= 2) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      const float alpha = exp2f(m_run - m_new);  // 0 on the first tile
      l_run = l_run * alpha + sum;
      m_run = m_new;
      if (sm_part == 0) alpha_s[sm_head] = alpha;
    }
    __syncthreads();

    // output: this warp's 128 latent columns, P (16 x 64) by the tile's rows
    {
      const float al_lo = alpha_s[g];
      const float al_hi = alpha_s[g + 8];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        o[j][0] *= al_lo;
        o[j][1] *= al_lo;
        o[j][2] *= al_hi;
        o[j][3] *= al_hi;
      }
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, ps + (lane % 16) * kPStride + kk * 16 + (lane / 16) * 8);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int c0 = warp * 128 + jj * 16;
          uint32_t bb[4];
          ldmatrix_x4_trans(
              bb, tile + (kk * 16 + lane % 16) * kStride + c0 + (lane / 16) * 8);
          mma(o[2 * jj], a, bb[0], bb[1]);
          mma(o[2 * jj + 1], a, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // the stage is loaded again two tiles on
  }

  const int64_t part = int64_t(b) * splits + split;
  float* out = o_part + part * kHeads * kLatent;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = warp * 128 + j * 8 + tig * 2;
    *reinterpret_cast<float2*>(out + g * kLatent + col) =
        make_float2(o[j][0], o[j][1]);
    *reinterpret_cast<float2*>(out + (g + 8) * kLatent + col) =
        make_float2(o[j][2], o[j][3]);
  }
  if (sm_part == 0) {
    m_part[part * kHeads + sm_head] = m_run;
    l_part[part * kHeads + sm_head] = l_run;
  }
}

// The float32 split kernel: the same block, slice and outputs as the bf16
// one, on a float32 cache of rows `latent` + `rope` wide, in fp32 on the CUDA
// cores.
__global__ void __launch_bounds__(kF32Threads)
mla_decode_split_f32_kernel(const float* __restrict__ q_lat, int64_t ql_sb,
             int64_t ql_sh, const float* __restrict__ q_rope, int64_t qr_sb,
             int64_t qr_sh, const float* __restrict__ cache_latent,
             const float* __restrict__ cache_krope, int64_t s_max,
             const int64_t* __restrict__ rows, int heads, int latent,
             int rope, float scale_log2, int chunk,
             float* __restrict__ o_part, float* __restrict__ m_part,
             float* __restrict__ l_part) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dim = latent + rope;
  const int stride = dim + 1;
  float* ks = reinterpret_cast<float*>(smem);  // kF32Tile x stride
  float* qs = ks + kF32Tile * stride;          // kHeads x dim
  float* ps = qs + kHeads * dim;               // kHeads x kF32Tile
  float* alpha_s = ps + kHeads * kF32Tile;     // kHeads

  const int split = blockIdx.x;
  const int b = blockIdx.y;
  const int splits = gridDim.x;
  const int64_t n = rows[b];
  const int64_t begin = int64_t(split) * chunk;
  if (begin >= n) return;  // the combine reads only the live slices
  const int64_t end = begin + chunk < n ? begin + chunk : n;
  const float* lat = cache_latent + int64_t(b) * s_max * latent;
  const float* krope = cache_krope + int64_t(b) * s_max * rope;

  for (int i = threadIdx.x; i < kHeads * dim; i += kF32Threads) {
    const int h = i / dim;
    const int c = i % dim;
    float v = 0.0f;
    if (h < heads) {
      v = c < latent ? q_lat[int64_t(b) * ql_sb + int64_t(h) * ql_sh + c]
                     : q_rope[int64_t(b) * qr_sb + int64_t(h) * qr_sh +
                              (c - latent)];
    }
    qs[h * dim + c] = v;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float m_run[2] = {neg_inf(), neg_inf()};  // heads warp and warp + 8
  float l_run[2] = {0.0f, 0.0f};
  // columns threadIdx.x and threadIdx.x + 256, where they are < latent
  const int col0 = threadIdx.x < latent ? threadIdx.x : 0;
  const int col1 = threadIdx.x + kF32Threads < latent
                       ? threadIdx.x + kF32Threads : 0;
  float o[kHeads][2];
#pragma unroll
  for (int h = 0; h < kHeads; ++h) o[h][0] = o[h][1] = 0.0f;

  for (int64_t row0 = begin; row0 < end; row0 += kF32Tile) {
    __syncthreads();  // the last tile's rows are read
    for (int i = threadIdx.x; i < kF32Tile * dim; i += kF32Threads) {
      const int r = i / dim;
      const int c = i % dim;
      const int64_t row = row0 + r;
      float v = 0.0f;  // rows at or past `end` are never read
      if (row < end) {
        v = c < latent ? lat[row * latent + c]
                       : krope[row * rope + (c - latent)];
      }
      ks[r * stride + c] = v;
    }
    __syncthreads();

    // scores of row `lane` for this warp's two heads, and their online
    // softmax across the warp
    const float* k = ks + lane * stride;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int h = warp + 8 * j;
      const float* q = qs + h * dim;
      float s = 0.0f;
#pragma unroll 8
      for (int c = 0; c < dim; ++c) s = fmaf(q[c], k[c], s);
      s = row0 + lane < end ? s * scale_log2 : neg_inf();
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m_run[j], mx);  // finite: a live row
      const float p = exp2f(s - m_new);
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      const float alpha = exp2f(m_run[j] - m_new);  // 0 on the first tile
      l_run[j] = l_run[j] * alpha + sum;
      m_run[j] = m_new;
      ps[h * kF32Tile + lane] = p;
      if (lane == 0) alpha_s[h] = alpha;
    }
    __syncthreads();

    // output: two latent columns of every head over the tile's rows
#pragma unroll
    for (int h = 0; h < kHeads; ++h) {
      o[h][0] *= alpha_s[h];
      o[h][1] *= alpha_s[h];
    }
    for (int r = 0; r < kF32Tile; ++r) {
      const float v0 = ks[r * stride + col0];
      const float v1 = ks[r * stride + col1];
#pragma unroll
      for (int h = 0; h < kHeads; ++h) {
        const float p = ps[h * kF32Tile + r];
        o[h][0] = fmaf(p, v0, o[h][0]);
        o[h][1] = fmaf(p, v1, o[h][1]);
      }
    }
  }

  const int64_t part = int64_t(b) * splits + split;
  float* out = o_part + part * kHeads * kLatent;
#pragma unroll
  for (int h = 0; h < kHeads; ++h) {
    if (threadIdx.x < latent) out[h * kLatent + threadIdx.x] = o[h][0];
    if (threadIdx.x + kF32Threads < latent) {
      out[h * kLatent + threadIdx.x + kF32Threads] = o[h][1];
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      m_part[part * kHeads + warp + 8 * j] = m_run[j];
      l_part[part * kHeads + warp + 8 * j] = l_run[j];
    }
  }
}

__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

// Block (h, b): o[b, h] = sum over the live slices of 2^(m_s - M) o_s over
// the same sum of l_s, in the cache's dtype.  Each thread takes 4 of the
// `latent` columns (a slice's o_s rows are kLatent apart).
template <typename T>
__global__ void __launch_bounds__(kThreads)
mla_decode_combine_kernel(const float* __restrict__ o_part,
               const float* __restrict__ m_part,
               const float* __restrict__ l_part,
               const int64_t* __restrict__ rows, int splits, int chunk,
               int latent, T* __restrict__ out) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int heads = gridDim.x;
  const int col = threadIdx.x * 4;
  if (col >= latent) return;
  const int64_t n = rows[b];
  const int64_t wanted = (n + chunk - 1) / chunk;
  const int live = static_cast<int>(wanted < splits ? wanted : splits);
  float mx = neg_inf();
  for (int s = 0; s < live; ++s) {
    mx = fmaxf(mx, m_part[(int64_t(b) * splits + s) * kHeads + h]);
  }
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float den = 0.0f;
  for (int s = 0; s < live; ++s) {
    const int64_t part = int64_t(b) * splits + s;
    const float w = exp2f(m_part[part * kHeads + h] - mx);
    den += w * l_part[part * kHeads + h];
    const float4 v = *reinterpret_cast<const float4*>(
        o_part + (part * kHeads + h) * kLatent + col);
    acc.x += w * v.x;
    acc.y += w * v.y;
    acc.z += w * v.z;
    acc.w += w * v.w;
  }
  const float inv = 1.0f / den;
  T* dst = out + (int64_t(b) * heads + h) * latent + col;
  store(dst, acc.x * inv);
  store(dst + 1, acc.y * inv);
  store(dst + 2, acc.z * inv);
  store(dst + 3, acc.w * inv);
}

// The launches of one call: the split kernel `split` (kSmem bytes of shared
// memory a block, granted past 48 KB per device once), then the combine.
template <typename T, int kBlock, size_t kSmem, typename Split>
int attend(Split split, const void* q_lat, int64_t ql_sb, int64_t ql_sh,
           const void* q_rope, int64_t qr_sb, int64_t qr_sh,
           const void* cache_latent, const void* cache_krope, int64_t s_max,
           const void* rows, int batch, int heads, int latent, int rope,
           float scale_log2, int chunk, int splits, void* o_part, void* m_part,
           void* l_part, void* out, void* stream) {
  if (batch < 1 || heads < 1 || heads > kHeads || chunk < kTile ||
      chunk % kTile != 0 || splits < 1 || s_max < 1 || batch > 65535 ||
      latent < 4 || latent > kLatent || latent % 4 != 0 || rope < 0 ||
      rope > kRope) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static uint64_t configured = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= 64 || !(configured >> device & 1)) {
    err = cudaFuncSetAttribute(split,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < 64) configured |= uint64_t(1) << device;
  }
  auto s = static_cast<cudaStream_t>(stream);
  split<<<dim3(splits, batch), kBlock, kSmem, s>>>(
      static_cast<const T*>(q_lat), ql_sb, ql_sh, static_cast<const T*>(q_rope),
      qr_sb, qr_sh, static_cast<const T*>(cache_latent),
      static_cast<const T*>(cache_krope), s_max,
      static_cast<const int64_t*>(rows), heads, latent, rope, scale_log2,
      chunk, static_cast<float*>(o_part), static_cast<float*>(m_part),
      static_cast<float*>(l_part));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mla_decode_combine_kernel<T><<<dim3(heads, batch), kThreads, 0, s>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(m_part),
      static_cast<const float*>(l_part), static_cast<const int64_t*>(rows),
      splits, chunk, latent, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q_lat: (batch, heads, latent) bf16, element (b, h, c) at b * ql_sb + h *
// ql_sh + c; q_rope: (batch, heads, rope) likewise; cache_latent (batch,
// s_max, latent) and cache_krope (batch, s_max, rope) bf16, contiguous, with
// latent 512 and rope 64; rows: (batch,) int64, 1 <= rows[b] <= s_max; heads
// <= 16; chunk: rows per slice, a multiple of 64; splits >= ceil(max rows /
// chunk).  Scratch: o_part (batch, splits, 16, 512) fp32, m_part and l_part
// (batch, splits, 16) fp32.  out: (batch, heads, latent) bf16.  Returns a
// cudaError_t (0 on success).
extern "C" int mla_decode_attend(const void* q_lat, int64_t ql_sb,
                                 int64_t ql_sh, const void* q_rope,
                                 int64_t qr_sb, int64_t qr_sh,
                                 const void* cache_latent,
                                 const void* cache_krope, int64_t s_max,
                                 const void* rows, int batch, int heads,
                                 int latent, int rope, float scale_log2,
                                 int chunk, int splits, void* o_part,
                                 void* m_part, void* l_part, void* out,
                                 void* stream) {
  if (latent != kLatent || rope != kRope) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return attend<__nv_bfloat16, kThreads, kSmemBytes>(
      mla_decode_split_kernel, q_lat, ql_sb, ql_sh, q_rope, qr_sb, qr_sh,
      cache_latent, cache_krope, s_max, rows, batch, heads, latent, rope,
      scale_log2, chunk, splits, o_part, m_part, l_part, out, stream);
}

// The same call on float32 queries and caches, with a float32 out, at any
// latent <= 512 (a multiple of 4) and rope <= 64.
extern "C" int mla_decode_attend_f32(const void* q_lat, int64_t ql_sb,
                                     int64_t ql_sh, const void* q_rope,
                                     int64_t qr_sb, int64_t qr_sh,
                                     const void* cache_latent,
                                     const void* cache_krope, int64_t s_max,
                                     const void* rows, int batch, int heads,
                                     int latent, int rope, float scale_log2,
                                     int chunk, int splits, void* o_part,
                                     void* m_part, void* l_part, void* out,
                                     void* stream) {
  return attend<float, kF32Threads, kF32SmemBytes>(
      mla_decode_split_f32_kernel, q_lat, ql_sb, ql_sh, q_rope, qr_sb, qr_sh,
      cache_latent, cache_krope, s_max, rows, batch, heads, latent, rope,
      scale_log2, chunk, splits, o_part, m_part, l_part, out, stream);
}

// Shared memory one block of the split kernel takes (for the notes).
extern "C" int mla_decode_smem_bytes() { return static_cast<int>(kSmemBytes); }
