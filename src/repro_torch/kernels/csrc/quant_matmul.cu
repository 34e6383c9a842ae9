// Dequantizing matmul for Hopper (sm_90a): out (M, N) = x (M, K) @ dequant(W),
// with W int8 (K, N) or int4 nibble-packed along K (K/2, N; low nibble =
// even row), per-channel scales (N) or per-group scales (K/group, N).
//
// Replaces the TPU kernel src/repro/kernels/quant_matmul.py:_qmm_kernel
// (with its helper _dequant_block).
//
// What bounds it on this card: at decode M is the number of slots (<= 8),
// so each weight byte feeds at most 2*M flops -- far under the ~20
// flop/byte the card needs before fp32 arithmetic (67 TFLOP/s) and not
// memory (3.35 TB/s) is the limit.  The kernel is bound by the weight
// bytes: 1 B per weight for int8, 0.5 B plus a 4 B scale per 32 weights
// for int4.
//
// Design: each thread owns 4 adjacent output columns (one 32-bit load
// brings 4 int8 weights, or 8 int4 weights of two K rows) and up to 8
// rows of x, staged per 64-row K tile in shared memory.  Weights are
// dequantized in registers (float(q) * scale, the same products as the
// plain version) and accumulated in f32 with fma.  Decode's small M and
// N leave too few column tiles to fill 132 SMs, so K is split across
// blockIdx.z into 64-row-aligned ranges; partial sums land in an f32
// workspace and a second pass adds them in split order, so the result is
// deterministic.  Any M, K, N is accepted: there is no padding to the
// TPU's 128 tile.  Simple first: no tensor cores, TMA or pipelining.
#include <cuda_runtime.h>
#include <stdint.h>

#define MT 8      // rows of x per block
#define KT 64     // K rows per shared-memory tile
#define CPT 4     // output columns per thread
#define NTHR 64   // threads per block -> 256 columns per block

template <bool VEC>
__device__ __forceinline__ void load4(const int8_t* __restrict__ row, int n,
                                      int N, int out[CPT]) {
  if (VEC) {
    uint32_t w = *reinterpret_cast<const uint32_t*>(row + n);
#pragma unroll
    for (int c = 0; c < CPT; ++c) out[c] = (int)(int8_t)((w >> (8 * c)) & 0xFF);
  } else {
#pragma unroll
    for (int c = 0; c < CPT; ++c) out[c] = (n + c < N) ? (int)row[n + c] : 0;
  }
}

template <int BITS, bool VEC>
__global__ void qmm_kernel(const float* __restrict__ x,
                           const int8_t* __restrict__ wq,
                           const float* __restrict__ scale,
                           float* __restrict__ out, int M, int K, int N,
                           int group, int k_per_split) {
  __shared__ float xs[MT * KT];
  const int tid = threadIdx.x;
  const int n = (blockIdx.x * NTHR + tid) * CPT;
  const int m0 = blockIdx.y * MT;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);

  float acc[MT][CPT];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[mi][c] = 0.f;

  float sc[CPT];
  int cur_g = -1;
  if (group == 0) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) sc[c] = (n + c < N) ? scale[n + c] : 0.f;
  }

  for (int k0 = kbeg; k0 < kend; k0 += KT) {
    __syncthreads();
    for (int i = tid; i < MT * KT; i += NTHR) {
      int mi = i / KT, kk = i - mi * KT;
      int m = m0 + mi, k = k0 + kk;
      xs[i] = (m < M && k < kend) ? x[(size_t)m * K + k] : 0.f;
    }
    __syncthreads();
    if (n >= N) continue;
    const int kk_end = min(KT, kend - k0);
    const int step = BITS == 4 ? 2 : 1;
    for (int kk = 0; kk < kk_end; kk += step) {
      const int k = k0 + kk;
      if (group > 0) {
        const int g = k / group;
        if (g != cur_g) {
          cur_g = g;
#pragma unroll
          for (int c = 0; c < CPT; ++c)
            sc[c] = (n + c < N) ? scale[(size_t)g * N + n + c] : 0.f;
        }
      }
      int w[CPT];
      if (BITS == 8) {
        load4<VEC>(wq + (size_t)k * N, n, N, w);
        float wf[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c) wf[c] = (float)w[c] * sc[c];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const float xv = xs[mi * KT + kk];
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[mi][c] = fmaf(xv, wf[c], acc[mi][c]);
        }
      } else {
        load4<VEC>(wq + (size_t)(k / 2) * N, n, N, w);
        float w0[CPT], w1[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int lo = ((w[c] & 0x0F) ^ 0x08) - 0x08;  // even row
          const int hi = w[c] >> 4;                       // odd row
          w0[c] = (float)lo * sc[c];
          w1[c] = (float)hi * sc[c];
        }
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const float x0 = xs[mi * KT + kk];
          const float x1 = xs[mi * KT + kk + 1];
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            acc[mi][c] = fmaf(x0, w0[c], acc[mi][c]);
            acc[mi][c] = fmaf(x1, w1[c], acc[mi][c]);
          }
        }
      }
    }
  }
  if (n >= N) return;
  float* o = out + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    const int m = m0 + mi;
    if (m >= M) break;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      if (n + c < N) o[(size_t)m * N + n + c] = acc[mi][c];
  }
}

__global__ void split_sum_kernel(const float* __restrict__ ws,
                                 float* __restrict__ out, int splits,
                                 size_t mn) {
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += ws[(size_t)z * mn + i];
  out[i] = s;
}

template <int BITS, bool VEC>
static void launch_qmm(dim3 grid, cudaStream_t s, const float* x,
                       const int8_t* wq, const float* scale, float* dst,
                       int M, int K, int N, int group, int kps) {
  qmm_kernel<BITS, VEC><<<grid, NTHR, 0, s>>>(x, wq, scale, dst, M, K, N,
                                              group, kps);
}

// splits > 1 needs ws of splits*M*N floats; k_per_split must be a multiple
// of 2*group (int4) and of KT so splits never cut a packed pair or group.
extern "C" int quant_matmul(const float* x, const int8_t* wq,
                            const float* scale, float* out, float* ws, int M,
                            int K, int N, int bits, int group, int splits,
                            int k_per_split, void* stream) {
  if (M == 0 || N == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((N + NTHR * CPT - 1) / (NTHR * CPT), (M + MT - 1) / MT, splits);
  float* dst = splits > 1 ? ws : out;
  const bool vec = (N % 4) == 0;
  if (bits == 8) {
    if (vec) launch_qmm<8, true>(grid, s, x, wq, scale, dst, M, K, N, group, k_per_split);
    else launch_qmm<8, false>(grid, s, x, wq, scale, dst, M, K, N, group, k_per_split);
  } else if (bits == 4) {
    if (vec) launch_qmm<4, true>(grid, s, x, wq, scale, dst, M, K, N, group, k_per_split);
    else launch_qmm<4, false>(grid, s, x, wq, scale, dst, M, K, N, group, k_per_split);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits <= 1) return (int)err;
  const size_t mn = (size_t)M * N;
  split_sum_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, s>>>(ws, out, splits, mn);
  return (int)cudaGetLastError();
}
