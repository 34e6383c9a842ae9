// Paged decode attention for Hopper (sm_90a): a K-token decode window per
// slot (K = 1 for an ordinary decode step, K > 1 for the speculative
// verify window) against a block-table page pool, online softmax in f32.
//
// Replaces the TPU kernels src/repro/kernels/paged_attention.py:_paged_kernel
// and _paged_window_kernel (with their helpers _dequant_page,
// _unpack_nibbles and _page_tokens): the single-query kernel is this one
// at K = 1.
//
// q (B, K, H, D): query j of slot b sits at absolute position
// len - K + j (len counts the context including the whole window, whose
// K/V rows are already in the pool) and attends the keys at positions
// <= len - K + j, within `window` of it when window > 0.
//
// What bounds it on this card: the bytes of the KV pages it must read.
// Each (slot, KV head) reads only the pages holding a key its mask can
// accept, at 4, 1 or 1/2 byte per value plus the f32 scales of quantized
// pools, ONCE for all K queries -- the K-way amortization the TPU window
// kernel exists for; q and the output are tiny beside them.  The
// arithmetic (2*G*D flops per key per query row) is far below what would
// make it compute-bound.
//
// Design: one block per (KV head, slot) holds all R = K*G query rows of
// its group (row r = j*G + g, G = H/KV), so every page row crosses device
// memory once for the whole group and window (the GQA fold of the TPU
// kernel).  Per-row online-softmax state (m, l, acc) stays in shared
// memory.  The block walks its block-table entries in a loop -- the
// TPU's sequential page grid axis -- dequantizing each page's K/V rows
// for its head into shared memory (int8 times the per-token scale, int4
// as sign-extended nibbles with the low nibble the even token), then
// scores, online-softmax update and the P.V accumulation all stay on
// chip.  It visits only entries holding a key valid for ANY of the K
// queries: from the first key in query 0's window to the last written
// token, a span of window + K - 1 tokens, as in the TPU kernel's skip
// mode.  On the TPU the other pages were streamed and masked, which adds
// exactly nothing to m, l and acc, so skipping them changes no result.
// The flat walk is clamped to the table's n entries: tokens past n*page
// are never read (nor is block_tables[b, n]).  Rows with no valid key (a
// slot of length 0, or a query before position 0) write zeros.  Simple
// first: no cp.async/TMA pipelining and no split over pages yet, so a
// batch of B slots runs B*KV blocks.
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF (-1e30f)

enum { QUANT_NONE = 0, QUANT_INT8 = 1, QUANT_INT4 = 2 };

__device__ __forceinline__ bool key_valid(int tok, int qpos, int window,
                                          int ring) {
  bool v = tok <= qpos;
  if (ring) v = v && tok >= 0;
  if (window > 0) v = v && qpos - tok < window;
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

// WIN = false is the single-query case, K = 1 known at compile time: it
// drops the row-to-query division r / G from the score loop, which cost
// 5-17 % of the K = 1 kernel's time on the H100.
template <int QUANT, bool WIN>
__global__ void paged_attention_kernel(
    const float* __restrict__ q, const void* __restrict__ k_pages,
    const void* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ block_tables,
    const int* __restrict__ lengths, float* __restrict__ out, int H, int KV,
    int D, int page, int n_entries, int wq, int window, int ring,
    float scale) {
  const int WQ = WIN ? wq : 1;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KV;
  const int R = WQ * G;  // query rows of this block
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthr >> 5;
  const int KD = D + 1;  // padded K row: conflict-free score reads

  extern __shared__ float smem[];
  float* qs = smem;               // R*D    scaled queries
  float* ks = qs + R * D;         // page*KD
  float* vs = ks + page * KD;     // page*D
  float* ps = vs + page * D;      // R*page scores, then probabilities
  float* acc = ps + R * page;     // R*D
  float* m_run = acc + R * D;     // R
  float* l_run = m_run + R;       // R
  float* alpha = l_run + R;       // R

  const int len = lengths[b];
  const int base = len - WQ;  // absolute position of query 0
  // row r = j*G + g  <->  q[b, j, h*G + g, :]
  for (int i = tid; i < R * D; i += nthr) {
    const int r = i / D, d = i - r * D;
    const int j = WIN ? r / G : 0, g = r - j * G;
    qs[i] = q[(((size_t)b * WQ + j) * H + h * G + g) * D + d] * scale;
    acc[i] = 0.f;
  }
  for (int r = tid; r < R; r += nthr) {
    m_run[r] = NEG_INF;
    l_run[r] = 0.f;
  }

  const int last = len > 0 ? (len - 1) / page : 0;
  const int lo_valid = window > 0 ? base - window + 1 : 0;  // query 0's first key
  int e_begin = 0, e_end = 0;
  if (len > 0) {
    if (ring) {
      e_end = n_entries;
    } else {
      e_begin = max(lo_valid, 0) / page;
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
    for (int i = tid; i < R * page; i += nthr) {
      const int r = i / page, t = i - r * page;
      float s = NEG_INF;
      if (key_valid(t0 + t, base + (WIN ? r / G : 0), window, ring)) {
        const float* qr = qs + r * D;
        const float* kt = ks + t * KD;
        float a = 0.f;
        for (int d = 0; d < D; ++d) a = fmaf(qr[d], kt[d], a);
        s = a;
      }
      ps[i] = s;
    }
    __syncthreads();
    for (int r = warp; r < R; r += nwarps) {
      const int qpos = base + (WIN ? r / G : 0);
      float mx = NEG_INF;
      for (int t = lane; t < page; t += 32) mx = fmaxf(mx, ps[r * page + t]);
      mx = warp_max(mx);
      const float m_prev = m_run[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < page; t += 32) {
        float ev = key_valid(t0 + t, qpos, window, ring)
                       ? expf(ps[r * page + t] - m_new)
                       : 0.f;
        ps[r * page + t] = ev;
        sum += ev;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        alpha[r] = a;
        l_run[r] = a * l_run[r] + sum;
        m_run[r] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < R * D; i += nthr) {
      const int r = i / D, d = i - r * D;
      const float* pr = ps + r * page;
      float pv = 0.f;
      for (int t = 0; t < page; ++t) pv = fmaf(pr[t], vs[t * D + d], pv);
      acc[i] = acc[i] * alpha[r] + pv;
    }
  }
  __syncthreads();
  for (int i = tid; i < R * D; i += nthr) {
    const int r = i / D, d = i - r * D;
    const int j = WIN ? r / G : 0, g = r - j * G;
    const float l = l_run[r];
    out[(((size_t)b * WQ + j) * H + h * G + g) * D + d] =
        acc[i] / (l == 0.f ? 1.f : l);
  }
}

template <int QUANT>
static cudaError_t launch(const float* q, const void* k_pages,
                          const void* v_pages, const float* k_scale,
                          const float* v_scale, const int* block_tables,
                          const int* lengths, float* out, int B, int H, int KV,
                          int D, int page, int n_entries, int WQ, int window,
                          int ring, float scale, cudaStream_t stream) {
  const size_t R = (size_t)WQ * (H / KV);
  const size_t smem =
      sizeof(float) * (R * D + (size_t)page * (D + 1) + (size_t)page * D +
                       R * page + R * D + 3 * R);
  auto kernel = WQ > 1 ? paged_attention_kernel<QUANT, true>
                        : paged_attention_kernel<QUANT, false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  // About one thread per score of a page (R*page), between 4 and 8 warps:
  // 128 threads for a single query at G = 8, page 16; 256 for a window.
  const int threads = R * page > 128 ? 256 : 128;
  dim3 grid(KV, B);
  kernel<<<grid, threads, smem, stream>>>(
      q, k_pages, v_pages, k_scale, v_scale, block_tables, lengths, out, H, KV,
      D, page, n_entries, WQ, window, ring, scale);
  return cudaGetLastError();
}

extern "C" int paged_attention(
    const float* q, const void* k_pages, const void* v_pages,
    const float* k_scale, const float* v_scale, const int* block_tables,
    const int* lengths, float* out, int B, int H, int KV, int D, int page,
    int n_entries, int quant, int WQ, int window, int ring, float scale,
    void* stream) {
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (quant) {
    case QUANT_NONE:
      err = launch<QUANT_NONE>(q, k_pages, v_pages, k_scale, v_scale,
                               block_tables, lengths, out, B, H, KV, D, page,
                               n_entries, WQ, window, ring, scale, s);
      break;
    case QUANT_INT8:
      err = launch<QUANT_INT8>(q, k_pages, v_pages, k_scale, v_scale,
                               block_tables, lengths, out, B, H, KV, D, page,
                               n_entries, WQ, window, ring, scale, s);
      break;
    case QUANT_INT4:
      err = launch<QUANT_INT4>(q, k_pages, v_pages, k_scale, v_scale,
                               block_tables, lengths, out, B, H, KV, D, page,
                               n_entries, WQ, window, ring, scale, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
