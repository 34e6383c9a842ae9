// Per-row symmetric quantization for Hopper (sm_90a): x (M, K) f32 ->
// q (M, K) int8 and scale (M, 1) f32, with
//   amax = max |x[m, :]|,  scale = max(amax, 1e-8) / qmax,
//   q = clip(rint(x / scale), -qmax - 1, qmax)
// (qmax 127 for 8 bits, 7 for 4 bits; 4-bit codes stay one per int8).
//
// Replaces the TPU kernel src/repro/kernels/quantize_kernel.py:_quantize_kernel.
//
// The arithmetic is the reference's, operation for operation, so the bytes
// are equal: the scale is a true IEEE division (nvcc's default
// -prec-div=true; no --use_fast_math), x / scale is a division and not a
// multiply by a reciprocal, and rintf rounds half to even as jnp.round
// does.  The max is exact in any order.
//
// What bounds it on this card: bytes.  Each value is read once as 4 bytes
// and written once as 1; the row maximum and the division cost a few
// operations per value, far below the card's arithmetic rate.
//
// Design: one block per row (the TPU's 128-row blocks were a tiling of
// that machine, so any M and K are taken).  The block reads its row once
// into shared memory while reducing |x| (warp shuffles, then one value
// per warp in shared memory), so the second pass divides, rounds and
// stores from shared memory without touching device memory again.  Rows
// whose K does not fit in shared memory re-read x from device memory
// (L2) in the second pass.  Loads and stores are 16-byte / 4-byte vectors
// when K is a multiple of 4.  Simple first: at the decode shapes (M = 8)
// only M blocks run.
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define SMEM_ROW_MAX (48 * 1024 / 4 - 64)  // floats of a row kept on chip

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int8_t quantize_one(float x, float scale,
                                               float qmax) {
  float r = rintf(x / scale);
  r = fminf(fmaxf(r, -qmax - 1.f), qmax);
  return (int8_t)(int)r;
}

template <bool VEC, bool ON_CHIP>
__global__ void quantize_rowwise_kernel(const float* __restrict__ x,
                                        int8_t* __restrict__ q,
                                        float* __restrict__ scale, int K,
                                        float qmax) {
  extern __shared__ float row[];  // K floats when ON_CHIP
  __shared__ float warp_amax[THREADS / 32];
  __shared__ float row_scale;
  const int m = blockIdx.x;
  const int tid = threadIdx.x;
  const float* xr = x + (size_t)m * K;
  int8_t* qr = q + (size_t)m * K;

  float amax = 0.f;
  if (VEC) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    for (int i = tid; i < K / 4; i += THREADS) {
      const float4 v = x4[i];
      if (ON_CHIP) reinterpret_cast<float4*>(row)[i] = v;
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                               fmaxf(fabsf(v.z), fabsf(v.w))));
    }
  } else {
    for (int i = tid; i < K; i += THREADS) {
      const float v = xr[i];
      if (ON_CHIP) row[i] = v;
      amax = fmaxf(amax, fabsf(v));
    }
  }
  amax = warp_max(amax);
  if ((tid & 31) == 0) warp_amax[tid >> 5] = amax;
  __syncthreads();
  if (tid < 32) {
    float a = tid < THREADS / 32 ? warp_amax[tid] : 0.f;
    a = warp_max(a);
    if (tid == 0) {
      const float s = fmaxf(a, 1e-8f) / qmax;
      row_scale = s;
      scale[m] = s;
    }
  }
  __syncthreads();
  const float s = row_scale;
  const float* src = ON_CHIP ? row : xr;
  if (VEC) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    char4* q4 = reinterpret_cast<char4*>(qr);
    for (int i = tid; i < K / 4; i += THREADS) {
      const float4 v = s4[i];
      char4 o;
      o.x = quantize_one(v.x, s, qmax);
      o.y = quantize_one(v.y, s, qmax);
      o.z = quantize_one(v.z, s, qmax);
      o.w = quantize_one(v.w, s, qmax);
      q4[i] = o;
    }
  } else {
    for (int i = tid; i < K; i += THREADS) qr[i] = quantize_one(src[i], s, qmax);
  }
}

template <bool VEC>
static cudaError_t launch(const float* x, int8_t* q, float* scale, int M,
                          int K, float qmax, cudaStream_t stream) {
  if (K <= SMEM_ROW_MAX) {
    quantize_rowwise_kernel<VEC, true>
        <<<M, THREADS, sizeof(float) * (size_t)K, stream>>>(x, q, scale, K,
                                                            qmax);
  } else {
    quantize_rowwise_kernel<VEC, false>
        <<<M, THREADS, 0, stream>>>(x, q, scale, K, qmax);
  }
  return cudaGetLastError();
}

extern "C" int quantize_rowwise(const float* x, int8_t* q, float* scale,
                                int M, int K, int bits, void* stream) {
  if (bits != 8 && bits != 4) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  const float qmax = (float)((1 << (bits - 1)) - 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // float4 loads need 16-byte rows: K % 4 == 0 with a 16-byte-aligned base
  const bool vec = K % 4 == 0 && ((uintptr_t)x & 15) == 0 &&
                   ((uintptr_t)q & 3) == 0;
  return (int)(vec ? launch<true>(x, q, scale, M, K, qmax, s)
                   : launch<false>(x, q, scale, M, K, qmax, s));
}
