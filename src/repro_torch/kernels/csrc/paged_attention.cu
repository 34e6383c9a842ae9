// Paged decode attention for Hopper (sm_90a): one query token per slot
// against a block-table page pool, online softmax in f32.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py:_paged_kernel
// (with its helpers _dequant_page, _unpack_nibbles and _page_tokens).
//
// What bounds it on this card: the bytes of the KV pages it must read.
// Each (slot, KV head) reads only the pages holding a key its mask can
// accept (ceil(len/page) pages for full attention, the pages that
// overlap the window otherwise), at 4, 1 or 1/2 byte per value plus the
// f32 scales of quantized pools; q and the output are tiny beside them.
// The arithmetic (2*G*D flops per key per query head) is far below what
// would make it compute-bound.
//
// Design: one block per (KV head, slot) computes all G = H/KV query
// heads of its group, so every page row crosses device memory once for
// the whole group (the GQA fold of the TPU kernel).  The block walks its
// block-table entries in a loop -- the TPU's sequential page grid axis --
// dequantizing each page's K/V rows for its head into shared memory
// (int8 times the per-token scale, int4 as sign-extended nibbles with
// the low nibble the even token), then scores, online-softmax update and
// the P.V accumulation all stay on chip.  Pages that hold no valid key
// are not visited at all: on the TPU they were streamed and masked,
// which adds exactly nothing to m, l and acc, so skipping them changes
// no result.  A slot of length 0 writes zeros.  Simple first: no
// cp.async/TMA pipelining and no split over pages yet, so a batch of B
// slots runs B*KV blocks.
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF (-1e30f)

enum { QUANT_NONE = 0, QUANT_INT8 = 1, QUANT_INT4 = 2 };

__device__ __forceinline__ bool tok_valid(int tok, int len, int window,
                                          int ring) {
  bool v = tok < len;
  if (ring) v = v && tok >= 0;
  if (window > 0) v = v && tok > len - 1 - window;
  return v;
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

// Dequantized value of token t, dim d, of KV head h in physical page pg.
template <int QUANT>
__device__ __forceinline__ float load_kv(const void* __restrict__ pages,
                                         const float* __restrict__ scales,
                                         int pg, int t, int h, int d, int KV,
                                         int D, int page) {
  if (QUANT == QUANT_NONE) {
    size_t off = (((size_t)pg * page + t) * KV + h) * D + d;
    return static_cast<const float*>(pages)[off];
  }
  float s = scales[((size_t)pg * KV + h) * page + t];
  if (QUANT == QUANT_INT8) {
    size_t off = (((size_t)pg * page + t) * KV + h) * D + d;
    return (float)static_cast<const int8_t*>(pages)[off] * s;
  }
  // int4: two tokens per byte along the token dim, low nibble = even
  size_t off = (((size_t)pg * (page / 2) + t / 2) * KV + h) * D + d;
  int byte = static_cast<const int8_t*>(pages)[off];  // sign-extended
  int nib = (t & 1) ? (byte >> 4) : (((byte & 0x0F) ^ 0x08) - 0x08);
  return (float)nib * s;
}

template <int QUANT>
__global__ void paged_decode_kernel(
    const float* __restrict__ q, const void* __restrict__ k_pages,
    const void* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ block_tables,
    const int* __restrict__ lengths, float* __restrict__ out, int H, int KV,
    int D, int page, int n_entries, int window, int ring, float scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthr >> 5;
  const int KD = D + 1;  // padded K row: conflict-free score reads

  extern __shared__ float smem[];
  float* qs = smem;               // G*D    scaled queries
  float* ks = qs + G * D;         // page*KD
  float* vs = ks + page * KD;     // page*D
  float* ps = vs + page * D;      // G*page scores, then probabilities
  float* acc = ps + G * page;     // G*D
  float* m_run = acc + G * D;     // G
  float* l_run = m_run + G;       // G
  float* alpha = l_run + G;       // G

  const int len = lengths[b];
  for (int i = tid; i < G * D; i += nthr) {
    qs[i] = q[((size_t)b * H + h * G) * D + i] * scale;
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += nthr) {
    m_run[g] = NEG_INF;
    l_run[g] = 0.f;
  }

  // Entries to visit.  Flat tables: entry e holds absolute page e; only
  // pages [first, last] can hold a valid key.  Ring tables: entry j holds
  // absolute page last - ((last - j) mod R); every entry is a candidate.
  const int last = len > 0 ? (len - 1) / page : 0;
  const int lo_valid = window > 0 ? len - window : 0;  // first valid key
  int e_begin = 0, e_end = 0;
  if (len > 0) {
    if (ring) {
      e_end = n_entries;
    } else {
      int first_tok = window > 0 ? max(len - window, 0) : 0;
      e_begin = first_tok / page;
      e_end = min(last, n_entries - 1) + 1;
    }
  }
  const int* bt = block_tables + (size_t)b * n_entries;

  for (int e = e_begin; e < e_end; ++e) {
    int ap = e;
    if (ring) {
      int r = (last - e) % n_entries;
      if (r < 0) r += n_entries;
      ap = last - r;
    }
    // skip entries with no valid key (never written, or out of window)
    const int t0 = ap * page;
    if (ap < 0 || t0 > len - 1 || t0 + page - 1 < lo_valid) continue;
    const int pg = bt[e];
    __syncthreads();  // previous page's ks/vs/ps fully consumed
    for (int i = tid; i < page * D; i += nthr) {
      int t = i / D, d = i - t * D;
      ks[t * KD + d] = load_kv<QUANT>(k_pages, k_scale, pg, t, h, d, KV, D,
                                      page);
      vs[i] = load_kv<QUANT>(v_pages, v_scale, pg, t, h, d, KV, D, page);
    }
    __syncthreads();
    for (int i = tid; i < G * page; i += nthr) {
      int g = i / page, t = i - g * page;
      float s = NEG_INF;
      if (tok_valid(t0 + t, len, window, ring)) {
        const float* qg = qs + g * D;
        const float* kt = ks + t * KD;
        float a = 0.f;
        for (int d = 0; d < D; ++d) a = fmaf(qg[d], kt[d], a);
        s = a;
      }
      ps[i] = s;
    }
    __syncthreads();
    for (int g = warp; g < G; g += nwarps) {
      float mx = NEG_INF;
      for (int t = lane; t < page; t += 32) mx = fmaxf(mx, ps[g * page + t]);
      mx = warp_max(mx);
      const float m_prev = m_run[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < page; t += 32) {
        float ev = tok_valid(t0 + t, len, window, ring)
                       ? expf(ps[g * page + t] - m_new)
                       : 0.f;
        ps[g * page + t] = ev;
        sum += ev;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        alpha[g] = a;
        l_run[g] = a * l_run[g] + sum;
        m_run[g] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += nthr) {
      int g = i / D, d = i - g * D;
      const float* pg_ = ps + g * page;
      float pv = 0.f;
      for (int t = 0; t < page; ++t) pv = fmaf(pg_[t], vs[t * D + d], pv);
      acc[i] = acc[i] * alpha[g] + pv;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += nthr) {
    const float l = l_run[i / D];
    out[((size_t)b * H + h * G) * D + i] = acc[i] / (l == 0.f ? 1.f : l);
  }
}

template <int QUANT>
static cudaError_t launch(const float* q, const void* k_pages,
                          const void* v_pages, const float* k_scale,
                          const float* v_scale, const int* block_tables,
                          const int* lengths, float* out, int B, int H, int KV,
                          int D, int page, int n_entries, int window, int ring,
                          float scale, cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem =
      sizeof(float) *
      ((size_t)G * D + (size_t)page * (D + 1) + (size_t)page * D +
       (size_t)G * page + (size_t)G * D + 3 * (size_t)G);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<QUANT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(KV, B);
  paged_decode_kernel<QUANT><<<grid, 128, smem, stream>>>(
      q, k_pages, v_pages, k_scale, v_scale, block_tables, lengths, out, H, KV,
      D, page, n_entries, window, ring, scale);
  return cudaGetLastError();
}

extern "C" int paged_attention_decode(
    const float* q, const void* k_pages, const void* v_pages,
    const float* k_scale, const float* v_scale, const int* block_tables,
    const int* lengths, float* out, int B, int H, int KV, int D, int page,
    int n_entries, int quant, int window, int ring, float scale,
    void* stream) {
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (quant) {
    case QUANT_NONE:
      err = launch<QUANT_NONE>(q, k_pages, v_pages, k_scale, v_scale,
                               block_tables, lengths, out, B, H, KV, D, page,
                               n_entries, window, ring, scale, s);
      break;
    case QUANT_INT8:
      err = launch<QUANT_INT8>(q, k_pages, v_pages, k_scale, v_scale,
                               block_tables, lengths, out, B, H, KV, D, page,
                               n_entries, window, ring, scale, s);
      break;
    case QUANT_INT4:
      err = launch<QUANT_INT4>(q, k_pages, v_pages, k_scale, v_scale,
                               block_tables, lengths, out, B, H, KV, D, page,
                               n_entries, window, ring, scale, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
