// Flash-attention forward for Hopper (sm_90a): the prompt attention of a
// cold admission, online softmax in f32.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_flash_kernel.
//
// q (B, Sq, H, D) against k/v (B, Sk, KV, D), out (B, Sq, H, D).  Query
// positions are END-ALIGNED: query i sits at i + Sk - Sq.  Causal mask
// (key <= query position), optional sliding window (query position - key
// < window), GQA by h / (H / KV).  A row with no valid key writes zeros.
// No logit softcap.  Head dims 64, 128 and 256 (the models' own).
//
// What bounds it on this card: arithmetic.  At the prompt lengths of a
// cold admission (128-1024 tokens) every K/V row is reused by all the
// query rows after it, so the ~4*D flops per (query, key) pair outweigh
// the bytes of q, k, v and the output: 67 TFLOP/s of f32 FMA against
// 3.35 TB/s puts the crossover near 20 flops per byte.  So the design is
// about feeding the FMA units from registers, not from shared memory.
//
// Design: one block of 8 warps per (query head, batch row, query tile of
// BQ = 8*TM rows: 64 at D=64, 32 at D=128 and 256, key chunk).  Warp w
// owns query rows w*TM .. w*TM+TM-1 outright: its lanes hold a TM x 2
// register micro-tile of scores (keys lane and lane + 32 of a 64-key
// tile) and a TM x D/32 micro-tile of the output accumulator, so the
// online softmax of a row is two warp reductions and no block barrier.
// Q, K and V reach shared memory in chunks of 64 head dims (the QK
// product accumulates over D in chunks, the P.V product writes the
// output in chunks), so a block holds three chunk buffers and its
// probabilities: 85 KB at D=256 and 128, 118 KB at D=64, where whole
// D=256 tiles would take 133 KB.  Each chunk is copied with
// 16-byte cp.async two stages ahead of its use.  Rows are padded by 4
// floats, so the 16-byte reads of K rows by consecutive lanes hit
// distinct banks.  Key tiles wholly above the causal diagonal or outside
// the window add nothing to (m, l, acc) and are not visited.  A causal
// tile sees up to Sk keys where the first sees one tile, so a tile's keys
// are cut into equal chunks of at most 8 key tiles at D=64, 4 at D >= 128,
// one block each, merged by a second pass in ascending order: at Gemma3's
// Sq = Sk = 1024 the longest block walks 4 tiles, not 16.  The query tile is the slowest grid axis,
// heaviest first, so the long blocks of every head start before the
// short ones.  Any Sq and Sk work: rows
// past Sq and keys past Sk are zero-filled and masked.  fp32 FMA
// throughout: no TF32, no tensor cores.
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF (-1e30f)

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int BK = 64;       // keys per tile: two per lane
constexpr int DC = 64;       // head dims per chunk
constexpr int LD = DC + 4;   // padded chunk row, in floats
constexpr int STAGES = 3;    // chunk buffers: one computed on, two in flight

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = fill ? 16 : 0;  // 0: write zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// every copy group but the newest STAGES - 1 has landed
__device__ __forceinline__ void cp_async_wait_stage() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ bool pair_valid(int qpos, int key, int Sk,
                                           int causal, int window) {
  bool v = key < Sk;
  if (causal) v = v && key <= qpos;
  if (window > 0) v = v && qpos - key < window;
  return v;
}

// Copy `n` rows of one 64-dim chunk (row stride `stride` floats in global
// memory, rows at or past `valid` zero-filled) into a padded buffer.
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           size_t stride, int n, int valid) {
  for (int i = threadIdx.x; i < n * (DC / 4); i += THREADS) {
    const int r = i / (DC / 4), c = i - r * (DC / 4);
    const bool in = r < valid;
    cp_async16(dst + r * LD + c * 4, in ? src + r * stride + c * 4 : src, in);
  }
}

// The key tiles [k_first, k_first + n_tiles * BK) some row of the query
// tile at q0 may see (rows past Sq excluded).
struct KeyRange {
  int k_first, n_tiles;
};

__host__ __device__ inline KeyRange key_range(int q0, int BQ, int Sq, int Sk,
                                              int causal, int window) {
  const int rows = Sq - q0 < BQ ? Sq - q0 : BQ;
  const int off = Sk - Sq;  // query i sits at i + off
  const int qlo = q0 + off, qhi = q0 + rows - 1 + off;
  const int k_end = causal ? (Sk < qhi + 1 ? Sk : qhi + 1) : Sk;
  const int lo = window > 0 ? qlo - window + 1 : 0;
  KeyRange kr;
  kr.k_first = (lo > 0 ? lo : 0) / BK * BK;
  kr.n_tiles = k_end > kr.k_first ? (k_end - kr.k_first + BK - 1) / BK : 0;
  return kr;
}

// Key tiles per block at most: 8 (512 keys) at D = 64, 4 at D >= 128,
// whose tiles are 2-4x the work.
__host__ __device__ inline int key_chunks(const KeyRange& kr, int D) {
  const int kch = D == 64 ? 8 : 4;
  return kr.n_tiles > 0 ? (kr.n_tiles + kch - 1) / kch : 1;
}

template <int D, int TM>
__global__ void __launch_bounds__(THREADS, 2) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ part_o, float* __restrict__ part_ml, int Sq, int Sk,
    int H, int KV, int causal, int window, int n_chunks, float scale) {
  static_assert(D % DC == 0, "64-dim chunks");
  constexpr int BQ = WARPS * TM;
  constexpr int NC = D / DC;
  constexpr int PT = TM < 4 ? 4 : TM;    // P row of a key, padded to a float4
  constexpr int STAGE = (BQ + BK) * LD;  // floats of one chunk buffer
  // the query tile is the slowest grid axis, taken from the last: the
  // heaviest causal tiles of every head start first; each tile's key
  // range is cut into equal chunks (key_chunks), one block each
  const int n_qt = gridDim.z / n_chunks;
  const int q0 = (n_qt - 1 - (int)blockIdx.z / n_chunks) * BQ;
  const int chunk = blockIdx.z % n_chunks;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / (H / KV);
  const int rows = min(BQ, Sq - q0);
  const int off = Sk - Sq;  // query i sits at i + off
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  extern __shared__ __align__(16) float smem[];
  float* pw = smem + STAGES * STAGE + warp * BK * PT;  // this warp's P, [key][row]

  // this block's key tiles: chunk `chunk` of those some row may see
  const KeyRange kr = key_range(q0, BQ, Sq, Sk, causal, window);
  const int my_chunks = key_chunks(kr, D);
  if (chunk >= my_chunks) return;
  const int per = (kr.n_tiles + my_chunks - 1) / my_chunks;  // balanced
  const int k_first = kr.k_first + chunk * per * BK;
  const int n_tiles = min(per, kr.n_tiles - chunk * per);
  const int n_stages = n_tiles * 2 * NC;  // per tile: NC QK chunks, NC V chunks

  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)KV * D;
  const float* qb = q + ((size_t)b * Sq + q0) * q_stride + (size_t)h * D;
  const float* kb = k + (size_t)b * Sk * kv_stride + (size_t)kvh * D;
  const float* vb = v + (size_t)b * Sk * kv_stride + (size_t)kvh * D;

  // stage g: key tile g / (2 NC); its part p < NC is QK chunk p (Q rows then
  // K rows), p >= NC is V chunk p - NC
  auto issue = [&](int g) {
    float* buf = smem + (g % STAGES) * STAGE;
    const int kt = k_first + (g / (2 * NC)) * BK;
    const int p = g % (2 * NC);
    if (p < NC) {
      stage_rows(buf, qb + p * DC, q_stride, BQ, rows);
      stage_rows(buf + BQ * LD, kb + (size_t)kt * kv_stride + p * DC,
                 kv_stride, BK, Sk - kt);
    } else {
      stage_rows(buf, vb + (size_t)kt * kv_stride + (p - NC) * DC, kv_stride,
                 BK, Sk - kt);
    }
  };

  float o[TM][NC][2];
  float m[TM], l[TM], s[TM][2];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
    s[i][0] = s[i][1] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[i][c][0] = o[i][c][1] = 0.f;
  }

  for (int g = 0; g < STAGES - 1; ++g) {
    if (g < n_stages) issue(g);
    cp_async_commit();
  }
  for (int g = 0; g < n_stages; ++g) {
    // stage g + STAGES - 1 goes into the buffer stage g - 1 left
    if (g + STAGES - 1 < n_stages) issue(g + STAGES - 1);
    cp_async_commit();
    cp_async_wait_stage();  // stage g is in
    __syncthreads();
    const float* buf = smem + (g % STAGES) * STAGE;
    const int kt = k_first + (g / (2 * NC)) * BK;
    const int p = g % (2 * NC);
    if (p < NC) {
      // scores of this warp's rows against keys lane and lane + 32
      if (p == 0) {
#pragma unroll
        for (int i = 0; i < TM; ++i) s[i][0] = s[i][1] = 0.f;
      }
      const float* qs = buf + warp * TM * LD;
      const float* ks = buf + BQ * LD;
#pragma unroll 4
      for (int d = 0; d < DC; d += 4) {
        const float4 k0 = *reinterpret_cast<const float4*>(ks + lane * LD + d);
        const float4 k1 =
            *reinterpret_cast<const float4*>(ks + (lane + 32) * LD + d);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(qs + i * LD + d);
          s[i][0] = fmaf(qv.x, k0.x, s[i][0]);
          s[i][0] = fmaf(qv.y, k0.y, s[i][0]);
          s[i][0] = fmaf(qv.z, k0.z, s[i][0]);
          s[i][0] = fmaf(qv.w, k0.w, s[i][0]);
          s[i][1] = fmaf(qv.x, k1.x, s[i][1]);
          s[i][1] = fmaf(qv.y, k1.y, s[i][1]);
          s[i][1] = fmaf(qv.z, k1.z, s[i][1]);
          s[i][1] = fmaf(qv.w, k1.w, s[i][1]);
        }
      }
      if (p == NC - 1) {
        // online softmax of each row over this key tile
        float pa[TM], pb[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int r = warp * TM + i;
          const int qpos = q0 + r + off;
          const bool v0 = r < rows && pair_valid(qpos, kt + lane, Sk, causal, window);
          const bool v1 =
              r < rows && pair_valid(qpos, kt + lane + 32, Sk, causal, window);
          const float s0 = s[i][0] * scale, s1 = s[i][1] * scale;
          const float mx =
              warp_max(fmaxf(v0 ? s0 : NEG_INF, v1 ? s1 : NEG_INF));
          const float m_new = fmaxf(m[i], mx);
          const float p0 = v0 ? expf(s0 - m_new) : 0.f;
          const float p1 = v1 ? expf(s1 - m_new) : 0.f;
          const float alpha = expf(m[i] - m_new);
          l[i] = alpha * l[i] + warp_sum(p0 + p1);
          m[i] = m_new;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            o[i][c][0] *= alpha;
            o[i][c][1] *= alpha;
          }
          pa[i] = p0;
          pb[i] = p1;
        }
#pragma unroll
        for (int i = 0; i < TM; i += 4) {
          *reinterpret_cast<float4*>(pw + lane * PT + i) = make_float4(
              pa[i], pa[i + 1], i + 2 < TM ? pa[i + 2] : 0.f,
              i + 3 < TM ? pa[i + 3] : 0.f);
          *reinterpret_cast<float4*>(pw + (lane + 32) * PT + i) = make_float4(
              pb[i], pb[i + 1], i + 2 < TM ? pb[i + 2] : 0.f,
              i + 3 < TM ? pb[i + 3] : 0.f);
        }
        __syncwarp();
      }
    } else {
      // o[:, chunk] += P . V[:, chunk]: this lane's columns 2*lane, 2*lane+1
      const int cv = p - NC;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c != cv) continue;
#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
          const float2 vv =
              *reinterpret_cast<const float2*>(buf + kk * LD + 2 * lane);
#pragma unroll
          for (int i = 0; i < TM; i += 4) {
            const float4 pp =
                *reinterpret_cast<const float4*>(pw + kk * PT + i);
            const float pr[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
            for (int u = 0; u < 4 && i + u < TM; ++u) {
              o[i + u][c][0] = fmaf(pr[u], vv.x, o[i + u][c][0]);
              o[i + u][c][1] = fmaf(pr[u], vv.y, o[i + u][c][1]);
            }
          }
        }
      }
    }
    __syncthreads();  // this buffer is free before it is refilled
  }

  // one chunk: the output; else this chunk's unnormalised (o, m, l)
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = warp * TM + i;
    if (r >= rows) continue;
    const float inv = my_chunks == 1 ? 1.f / (l[i] == 0.f ? 1.f : l[i]) : 1.f;
    const size_t row = ((size_t)b * H + h) * Sq + q0 + r;  // (b, h, query)
    float* orow = my_chunks == 1
                      ? out + (((size_t)b * Sq + q0 + r) * H + h) * D
                      : part_o + (row * n_chunks + chunk) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float2 val;
      val.x = o[i][c][0] * inv;
      val.y = o[i][c][1] * inv;
      *reinterpret_cast<float2*>(orow + c * DC + 2 * lane) = val;
    }
    if (my_chunks > 1 && lane == 0) {
      part_ml[(row * n_chunks + chunk) * 2] = m[i];
      part_ml[(row * n_chunks + chunk) * 2 + 1] = l[i];
    }
  }
}

// Merge the key chunks of the query rows whose tile was cut, in ascending
// chunk order: out = sum_c o_c exp(m_c - M) / sum_c l_c exp(m_c - M).  One
// block per (head, batch row, query), threads over D.
template <int BQ>
__global__ void __launch_bounds__(256) flash_combine_kernel(
    const float* __restrict__ part_o, const float* __restrict__ part_ml,
    float* __restrict__ out, int Sq, int Sk, int H, int D, int causal,
    int window, int n_chunks) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int i = blockIdx.z;
  const int n =
      key_chunks(key_range(i / BQ * BQ, BQ, Sq, Sk, causal, window), D);
  if (n == 1) return;  // written by its one block
  const size_t row = ((size_t)b * H + h) * Sq + i;
  const float* ml = part_ml + row * n_chunks * 2;
  float M = NEG_INF;
  for (int c = 0; c < n; ++c) M = fmaxf(M, ml[2 * c]);
  float L = 0.f;
  for (int c = 0; c < n; ++c) L += ml[2 * c + 1] * expf(ml[2 * c] - M);
  float* orow = out + (((size_t)b * Sq + i) * H + h) * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float A = 0.f;
    for (int c = 0; c < n; ++c)
      A += part_o[(row * n_chunks + c) * D + d] * expf(ml[2 * c] - M);
    orow[d] = A / (L == 0.f ? 1.f : L);
  }
}

template <int D, int TM>
cudaError_t launch(const float* q, const float* k, const float* v, float* out,
                   float* part_o, float* part_ml, int B, int Sq, int Sk,
                   int H, int KV, int causal, int window, int n_chunks,
                   float scale, cudaStream_t stream) {
  constexpr int BQ = WARPS * TM;
  constexpr int PT = TM < 4 ? 4 : TM;
  const size_t smem =
      sizeof(float) * (STAGES * (size_t)(BQ + BK) * LD + WARPS * BK * PT);
  auto kernel = flash_fwd_kernel<D, TM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (Sq + BQ - 1) / BQ;
  kernel<<<dim3(H, B, n_qt * n_chunks), THREADS, smem, stream>>>(
      q, k, v, out, part_o, part_ml, Sq, Sk, H, KV, causal, window, n_chunks,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return err;
  flash_combine_kernel<BQ><<<dim3(H, B, Sq), min(256, D), 0, stream>>>(
      part_o, part_ml, out, Sq, Sk, H, D, causal, window, n_chunks);
  return cudaGetLastError();
}

// Query rows per tile: 64 at D = 64, 32 at D = 128 and 256 (a lane then
// holds 16 or 32 floats of output).
constexpr int tile_rows(int D) { return D == 64 ? 64 : 32; }

}  // namespace

// The most key chunks any query tile of this shape is cut into: the
// wrapper sizes the merge scratch from it (none when it is 1).
extern "C" int flash_attention_chunks(int Sq, int Sk, int D, int causal,
                                      int window) {
  const int BQ = tile_rows(D);
  int most = 1;
  for (int q0 = 0; q0 < Sq; q0 += BQ) {
    const int c = key_chunks(key_range(q0, BQ, Sq, Sk, causal, window), D);
    most = c > most ? c : most;
  }
  return most;
}

// part_o (B, H, Sq, n_chunks, D) and part_ml (B, H, Sq, n_chunks, 2) are
// f32 scratch, unused (may be null) when n_chunks == 1.
extern "C" int flash_attention_fwd(const float* q, const float* k,
                                   const float* v, float* out, float* part_o,
                                   float* part_ml, int B, int Sq, int Sk,
                                   int H, int KV, int D, int causal,
                                   int window, int n_chunks, float scale,
                                   void* stream) {
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)launch<64, tile_rows(64) / WARPS>(
          q, k, v, out, part_o, part_ml, B, Sq, Sk, H, KV, causal, window,
          n_chunks, scale, s);
    case 128:
      return (int)launch<128, tile_rows(128) / WARPS>(
          q, k, v, out, part_o, part_ml, B, Sq, Sk, H, KV, causal, window,
          n_chunks, scale, s);
    case 256:
      return (int)launch<256, tile_rows(256) / WARPS>(
          q, k, v, out, part_o, part_ml, B, Sq, Sk, H, KV, causal, window,
          n_chunks, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
