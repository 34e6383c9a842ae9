// Flash-attention forward for Hopper (sm_90a): the prompt attention of a
// cold admission, online softmax in f32.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_flash_kernel.
//
// q (B, Sq, H, D) against k/v (B, Sk, KV, D), out (B, Sq, H, D).  Query
// positions are END-ALIGNED: query i sits at i + Sk - Sq.  Causal mask
// (key <= query position), optional sliding window (query position - key
// < window), GQA by h / (H / KV).  A row with no valid key writes zeros.
// No logit softcap.
//
// What bounds it on this card: arithmetic.  At the prompt lengths of a
// cold admission (128-512 tokens) every K/V row is reused by all the
// query rows after it, so the ~4*D flops per (query, key) pair outweigh
// the bytes of q, k, v and the output: 67 TFLOP/s of f32 FMA against
// 3.35 TB/s puts the crossover near 20 flops per byte.
//
// Design: one block per (query tile of BQ rows, query head, batch row).
// The block keeps its scaled query tile and its output accumulator in
// shared memory and walks the K/V rows of its head's KV group in tiles
// of BK, staging each tile in shared memory (K rows padded by one float
// so the score loop reads without bank conflicts), then scores, the
// online-softmax update and the P.V accumulation, all in f32 FMA.  The
// walk covers only keys some row of the tile may see: tiles wholly above
// the causal diagonal or wholly outside the window add nothing to
// (m, l, acc) and are not visited.  Any Sq and Sk work: rows past Sq and
// keys past Sk are masked, so the TPU kernel's multiples of 128 are not
// needed.  Simple first: no tensor cores, no cp.async/TMA pipelining.
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF (-1e30f)

namespace {

constexpr int BQ = 32;       // query rows per block
constexpr int BK = 32;       // keys per tile (one per lane in the softmax)
constexpr int THREADS = 128;

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

__global__ void flash_fwd_kernel(const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 float* __restrict__ out, int Sq, int Sk,
                                 int H, int KV, int D, int causal, int window,
                                 float scale) {
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int rows = min(BQ, Sq - q0);
  const int off = Sk - Sq;  // query i sits at i + off
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int KD = D + 1;

  extern __shared__ float smem[];
  float* qs = smem;              // BQ*D
  float* ks = qs + BQ * D;       // BK*KD
  float* vs = ks + BK * KD;      // BK*D
  float* ps = vs + BK * D;       // BQ*BK
  float* acc = ps + BQ * BK;     // BQ*D
  float* m_run = acc + BQ * D;   // BQ
  float* l_run = m_run + BQ;     // BQ
  float* alpha = l_run + BQ;     // BQ

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    qs[i] = r < rows ? q[(((size_t)b * Sq + q0 + r) * H + h) * D + d] * scale
                     : 0.f;
    acc[i] = 0.f;
  }
  for (int r = tid; r < BQ; r += THREADS) {
    m_run[r] = NEG_INF;
    l_run[r] = 0.f;
  }

  // keys some row of this tile may see
  const int qlo = q0 + off, qhi = q0 + rows - 1 + off;
  const int k_end = causal ? min(Sk, qhi + 1) : Sk;
  const int k_begin = window > 0 ? max(0, qlo - window + 1) : 0;

  for (int kt = (k_begin / BK) * BK; kt < k_end; kt += BK) {
    __syncthreads();  // previous tile's ks/vs/ps fully consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int t = i / D, d = i - t * D;
      const bool in = kt + t < Sk;
      const size_t src = (((size_t)b * Sk + kt + t) * KV + kvh) * D + d;
      ks[t * KD + d] = in ? k[src] : 0.f;
      vs[i] = in ? v[src] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < BQ * BK; i += THREADS) {
      const int r = i / BK, t = i - r * BK;
      float s = NEG_INF;
      if (r < rows && pair_valid(q0 + r + off, kt + t, Sk, causal, window)) {
        const float* qr = qs + r * D;
        const float* kr = ks + t * KD;
        float a = 0.f;
        for (int d = 0; d < D; ++d) a = fmaf(qr[d], kr[d], a);
        s = a;
      }
      ps[i] = s;
    }
    __syncthreads();
    for (int r = warp; r < BQ; r += THREADS / 32) {
      // BK == 32: one key per lane
      const bool ok = r < rows &&
                      pair_valid(q0 + r + off, kt + lane, Sk, causal, window);
      const float s = ps[r * BK + lane];
      const float mx = warp_max(s);
      const float m_prev = m_run[r];
      const float m_new = fmaxf(m_prev, mx);
      const float ev = ok ? expf(s - m_new) : 0.f;
      ps[r * BK + lane] = ev;
      const float sum = warp_sum(ev);
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        alpha[r] = a;
        l_run[r] = a * l_run[r] + sum;
        m_run[r] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < BQ * D; i += THREADS) {
      const int r = i / D, d = i - r * D;
      const float* pr = ps + r * BK;
      float pv = 0.f;
      for (int t = 0; t < BK; ++t) pv = fmaf(pr[t], vs[t * D + d], pv);
      acc[i] = acc[i] * alpha[r] + pv;
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    const float l = l_run[r];
    out[(((size_t)b * Sq + q0 + r) * H + h) * D + d] =
        acc[i] / (l == 0.f ? 1.f : l);
  }
}

}  // namespace

extern "C" int flash_attention_fwd(const float* q, const float* k,
                                   const float* v, float* out, int B, int Sq,
                                   int Sk, int H, int KV, int D, int causal,
                                   int window, float scale, void* stream) {
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  const size_t smem =
      sizeof(float) * ((size_t)BQ * D + (size_t)BK * (D + 1) + (size_t)BK * D +
                       (size_t)BQ * BK + (size_t)BQ * D + 3 * (size_t)BQ);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<<<grid, THREADS, smem, s>>>(q, k, v, out, Sq, Sk, H, KV, D,
                                               causal, window, scale);
  return (int)cudaGetLastError();
}
