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
// pools, ONCE for all K*G query rows of its group; q and the output are
// tiny beside them, and the arithmetic (4*D flops per key per row) is far
// below what would make it compute-bound.  At decode batch sizes the
// bytes are few (0.1-2 MB), so what the kernel must do is keep many loads
// in flight across the card, not stream one slot's pages one at a time.
//
// Design (flash-decoding):
// * The grid is (KV head, slot, split).  A split covers a FIXED run of
//   `pps` block-table entries -- entries [s*pps, (s+1)*pps) -- where pps
//   is a function of the page size and head dim alone (the wrapper's
//   split_pages: 16 tokens at D <= 64, 32 above).  So a slot's partition
//   of its pages, and with it the order of every float sum, depends only
//   on that slot's own length and table: the output of a slot is bitwise
//   the same alone and in any batch.  Splits outside the slot's live
//   entries return at once.
// * Within a split, the pages it visits are staged in shared memory with
//   16-byte cp.async copies into two buffers: page i+1 is in flight while
//   page i is scored.  Quantized pages are copied raw and dequantized as
//   they are read from shared memory (int8 times the per-token scale, int4
//   as sign-extended nibbles with the low nibble the even token).
// * A warp owns RPW query rows (row r = j*G + g, G = H/KV; RPW grows with
//   the K*G rows of a verify window), LPR = 32/RPW lanes each: every K/V
//   value staged is read and dequantized once for all RPW rows, a score is
//   the lanes' partial dot products summed by log2(LPR) shuffles, and a
//   row's online-softmax state (m, l, acc) is touched by its warp alone.
//   Query positions are computed once per row group and page, never per
//   score.
// * Each split writes its unnormalised (m, l, acc) to scratch the wrapper
//   allocates; a second kernel, one block per (head, slot, query row),
//   merges a slot's splits in ascending split order.  A grid of one split
//   writes the output directly (bitwise what the merge of one split
//   gives).
// * It visits only entries holding a key valid for ANY of the K queries:
//   from the first key in query 0's window to the last written token, as
//   in the TPU kernel's skip mode; the other pages add exactly nothing to
//   m, l and acc.  The flat walk is clamped to the table's n entries.
//   Rows with no valid key (a slot of length 0) write zeros.
// * No tensor cores: fp32 dot products at a few rows, f32 throughout.
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF (-1e30f)

enum { QUANT_NONE = 0, QUANT_INT8 = 1, QUANT_INT4 = 2 };

namespace {

constexpr int STAGES = 2;   // page buffers: one being scored, one in flight

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

template <int LPR>
__device__ __forceinline__ float group_sum(float v) {
  for (int o = LPR / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int LPR>
__device__ __forceinline__ float group_max(float v) {
  for (int o = LPR / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ bool key_valid(int tok, int qpos, int window,
                                          int ring) {
  bool v = tok <= qpos;
  if (ring) v = v && tok >= 0;
  if (window > 0) v = v && qpos - tok < window;
  return v;
}

// Whether some query at a position in [qlo, qhi] (every position between
// present) may see token tok.
__device__ __forceinline__ bool any_valid(int tok, int qlo, int qhi,
                                          int window, int ring) {
  bool v = tok <= qhi;
  if (ring) v = v && tok >= 0;
  if (window > 0) v = v && qlo - tok < window;
  return v;
}

// The live block-table entries [e_begin, e_end) of a slot, from its own
// length alone, and its split range [s_lo, s_hi).
struct Walk {
  int last, lo_valid, e_begin, e_end, s_lo, s_hi;
};

__device__ __forceinline__ Walk slot_walk(int len, int WQ, int window,
                                          int ring, int page, int n_entries,
                                          int pps) {
  Walk w;
  w.last = len > 0 ? (len - 1) / page : 0;
  w.lo_valid = window > 0 ? len - WQ - window + 1 : 0;  // query 0's first key
  w.e_begin = 0;
  w.e_end = 0;
  if (len > 0) {
    if (ring) {
      w.e_end = n_entries;
    } else {
      w.e_begin = max(w.lo_valid, 0) / page;
      w.e_end = min(w.last, n_entries - 1) + 1;
    }
  }
  w.s_lo = w.e_begin / pps;
  w.s_hi = (w.e_end + pps - 1) / pps;
  return w;
}

// First entry >= e below e_hi that holds a key some query may see (its
// absolute page written and reaching into query 0's window), or e_hi.
__device__ __forceinline__ int next_entry(int e, int e_hi, const Walk& w,
                                          int len, int ring, int page,
                                          int n_entries, int* t0) {
  for (; e < e_hi; ++e) {
    int ap = e;
    if (ring) {
      int r = (w.last - e) % n_entries;
      if (r < 0) r += n_entries;
      ap = w.last - r;
    }
    const int t = ap * page;
    if (ap >= 0 && t <= len - 1 && t + page - 1 >= w.lo_valid) {
      *t0 = t;
      return e;
    }
  }
  return e_hi;
}

// Bytes of one staged page for one KV head: K rows, V rows, then the K
// and V scales of a quantized pool.
template <int QUANT>
__host__ __device__ __forceinline__ int page_rows(int page) {
  return QUANT == QUANT_INT4 ? page / 2 : page;
}

template <int QUANT>
__host__ __device__ __forceinline__ int row_bytes(int D) {
  return QUANT == QUANT_NONE ? D * 4 : D;
}

template <int QUANT>
__host__ __device__ __forceinline__ int stage_bytes(int page, int D) {
  return 2 * page_rows<QUANT>(page) * row_bytes<QUANT>(D) +
         (QUANT == QUANT_NONE ? 0 : 2 * page * 4);
}

// Issue the 16-byte copies of physical page pg's rows of head h.
template <int QUANT>
__device__ __forceinline__ void stage_page(char* buf, const char* kp,
                                           const char* vp, const float* ks,
                                           const float* vs, int pg, int h,
                                           int KV, int D, int page, int tid,
                                           int nthr) {
  const int rows = page_rows<QUANT>(page);
  const int rb = row_bytes<QUANT>(D);
  const int row_chunks = rb / 16;
  const int kv_chunks = rows * row_chunks;
  const int sc_chunks = QUANT == QUANT_NONE ? 0 : page / 4;
  const int total = 2 * kv_chunks + 2 * sc_chunks;
  for (int i = tid; i < total; i += nthr) {
    const char* src;
    char* dst;
    if (i < 2 * kv_chunks) {
      const int which = i >= kv_chunks;
      const int c = i - which * kv_chunks;
      const int t = c / row_chunks, cc = c - t * row_chunks;
      src = (which ? vp : kp) + (((size_t)pg * rows + t) * KV + h) * rb +
            cc * 16;
      dst = buf + (which * rows + t) * rb + cc * 16;
    } else {
      const int c0 = i - 2 * kv_chunks;
      const int which = c0 >= sc_chunks;
      const int c = c0 - which * sc_chunks;
      src = reinterpret_cast<const char*>((which ? vs : ks) +
                                          ((size_t)pg * KV + h) * page) +
            c * 16;
      dst = buf + 2 * rows * rb + which * page * 4 + c * 16;
    }
    cp_async16(dst, src);
  }
}

// Dequantized value of token t, dim d of a staged K or V page.
template <int QUANT>
__device__ __forceinline__ float staged(const char* rows, const float* sc,
                                        int t, int d, int D) {
  if (QUANT == QUANT_NONE) return reinterpret_cast<const float*>(rows)[t * D + d];
  if (QUANT == QUANT_INT8)
    return (float)reinterpret_cast<const int8_t*>(rows)[t * D + d] * sc[t];
  const int byte = reinterpret_cast<const int8_t*>(rows)[(t >> 1) * D + d];
  const int nib = (t & 1) ? (byte >> 4) : (((byte & 0x0F) ^ 0x08) - 0x08);
  return (float)nib * sc[t];
}

template <int QUANT, int RPW>
__global__ void __launch_bounds__(256, 2) paged_attention_kernel(
    const float* __restrict__ q, const void* __restrict__ k_pages,
    const void* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ block_tables,
    const int* __restrict__ lengths, float* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int H, int KV,
    int D, int page, int n_entries, int WQ, int window, int ring, int pps,
    float scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int s = blockIdx.z;
  const int n_splits = gridDim.z;
  const int G = H / KV;
  const int R = WQ * G;  // query rows of this block
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthr >> 5;

  const int len = lengths[b];
  const Walk w = slot_walk(len, WQ, window, ring, page, n_entries, pps);
  // one split: this block writes the output, zeros for an empty slot
  if (n_splits > 1 && (s < w.s_lo || s >= w.s_hi)) return;
  const int e_hi = min((s + 1) * pps, w.e_end);

  extern __shared__ __align__(16) char smem[];
  const int sb = (stage_bytes<QUANT>(page, D) + 15) & ~15;
  float* qs = reinterpret_cast<float*>(smem + STAGES * sb);  // R*D
  float* acc = qs + R * D;                                   // R*D
  float* m_run = acc + R * D;                                // R
  float* l_run = m_run + R;                                  // R

  const char* kp = static_cast<const char*>(k_pages);
  const char* vp = static_cast<const char*>(v_pages);
  const int* bt = block_tables + (size_t)b * n_entries;
  const int rows = page_rows<QUANT>(page);
  const int rb = row_bytes<QUANT>(D);

  // prologue: the first page in flight before the queries are read
  int t_cur = 0, t_next = 0;
  int e_cur = next_entry(max(s * pps, w.e_begin), e_hi, w, len, ring, page,
                         n_entries, &t_cur);
  if (e_cur < e_hi)
    stage_page<QUANT>(smem, kp, vp, k_scale, v_scale, bt[e_cur], h, KV, D,
                      page, tid, nthr);
  cp_async_commit();
  int e_next = next_entry(e_cur + 1, e_hi, w, len, ring, page, n_entries,
                          &t_next);

  // the queries and the rows' softmax state; the loop's first barrier
  // publishes them
  const int base = len - WQ;  // absolute position of query 0
  for (int r = warp; r < R; r += nwarps) {
    const int j = r / G, g = r - j * G;
    const float* qr = q + (((size_t)b * WQ + j) * H + h * G + g) * D;
    for (int d = lane; d < D; d += 32) {
      qs[r * D + d] = qr[d] * scale;
      acc[r * D + d] = 0.f;
    }
    if (lane == 0) {
      m_run[r] = NEG_INF;
      l_run[r] = 0.f;
    }
  }

  // a warp takes RPW rows at a time, LPR = 32 / RPW lanes per row: each K/V
  // value staged is read and dequantized once for all of them, and a score
  // is a reduction over LPR lanes; lane `sub` of a row's group holds dims
  // sub + LPR*i and the scores of tokens j*LPR + sub
  constexpr int LPR = 32 / RPW;
  constexpr int NDV = RPW == 1 ? 8 : 16;  // D*RPW/32 <= NDV (the launcher's cap)
  const int grp = lane / LPR, sub = lane % LPR;
  for (int it = 0; e_cur < e_hi; ++it) {
    // the next page goes in flight into the other buffer
    if (e_next < e_hi)
      stage_page<QUANT>(smem + ((it + 1) % STAGES) * sb, kp, vp, k_scale,
                        v_scale, bt[e_next], h, KV, D, page, tid, nthr);
    cp_async_commit();
    cp_async_wait_one();  // every group but the newest: this page is in
    __syncthreads();

    const char* kst = smem + (it % STAGES) * sb;
    const char* vst = kst + rows * rb;
    const float* ksc = reinterpret_cast<const float*>(kst + 2 * rows * rb);
    const float* vsc = ksc + page;
    for (int r0 = warp * RPW; r0 < R; r0 += nwarps * RPW) {
      const int r = r0 + grp;
      const bool live = r < R;
      const int rr = live ? r : R - 1;
      // query positions, once per row group and page
      const int qpos = base + rr / G;
      const int qlo = base + r0 / G, qhi = base + (min(r0 + RPW, R) - 1) / G;
      float qv[NDV], a[NDV];
#pragma unroll
      for (int i = 0; i < NDV; ++i) {
        const int d = sub + LPR * i;
        qv[i] = d < D ? qs[rr * D + d] : 0.f;
        a[i] = 0.f;
      }
      const float m_prev = m_run[rr], l_prev = l_run[rr];
      float m_new = m_prev, sum = 0.f;
      // tokens in groups of up to 32
      for (int t_lo = 0; t_lo < page; t_lo += 32) {
        const int n = min(32, page - t_lo);
        // every token is scored (independent reductions, unrolled) and the
        // mask applied after; values staged past the written tokens never
        // reach m, l or acc
        float my_s[RPW];
#pragma unroll
        for (int j = 0; j < RPW; ++j) {
          my_s[j] = NEG_INF;
#pragma unroll 4
          for (int u = 0; u < LPR; ++u) {
            const int t = j * LPR + u;
            if (t >= n) break;
            float part = 0.f;
#pragma unroll
            for (int i = 0; i < NDV; ++i) {
              const int d = sub + LPR * i;
              if (d < D)
                part = fmaf(qv[i], staged<QUANT>(kst, ksc, t_lo + t, d, D), part);
            }
            part = group_sum<LPR>(part);
            if (sub == u) my_s[j] = part;
          }
        }
        bool ok[RPW];
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < RPW; ++j) {
          const int t = j * LPR + sub;
          ok[j] = live && t < n &&
                  key_valid(t_cur + t_lo + t, qpos, window, ring);
          mx = fmaxf(mx, ok[j] ? my_s[j] : NEG_INF);
        }
        const float m_grp = fmaxf(m_new, group_max<LPR>(mx));
        float p[RPW], psum = 0.f;
#pragma unroll
        for (int j = 0; j < RPW; ++j) {
          p[j] = ok[j] ? expf(my_s[j] - m_grp) : 0.f;
          psum += p[j];
        }
        const float rescale = expf(m_new - m_grp);
        sum = sum * rescale + group_sum<LPR>(psum);
#pragma unroll
        for (int i = 0; i < NDV; ++i) a[i] *= rescale;
        m_new = m_grp;
        // P.V over the tokens some row of the group may see (a token no
        // row sees may lie past the written ones)
#pragma unroll
        for (int j = 0; j < RPW; ++j) {
#pragma unroll 4
          for (int u = 0; u < LPR; ++u) {
            const int t = j * LPR + u;
            if (t >= n) break;
            if (!any_valid(t_cur + t_lo + t, qlo, qhi, window, ring)) continue;
            const float pt = __shfl_sync(0xffffffffu, p[j], lane - sub + u);
#pragma unroll
            for (int i = 0; i < NDV; ++i) {
              const int d = sub + LPR * i;
              if (d < D)
                a[i] = fmaf(pt, staged<QUANT>(vst, vsc, t_lo + t, d, D), a[i]);
            }
          }
        }
      }
      const float alpha = expf(m_prev - m_new);
      if (live) {
#pragma unroll
        for (int i = 0; i < NDV; ++i) {
          const int d = sub + LPR * i;
          if (d < D) acc[r * D + d] = acc[r * D + d] * alpha + a[i];
        }
      }
      __syncwarp();
      if (live && sub == 0) {
        m_run[r] = m_new;
        l_run[r] = alpha * l_prev + sum;
      }
      __syncwarp();
    }
    __syncthreads();  // this buffer is free before it is refilled
    e_cur = e_next;
    t_cur = t_next;
    e_next = next_entry(e_next + 1, e_hi, w, len, ring, page, n_entries,
                        &t_next);
  }
  __syncthreads();  // rows are written back by other warps than own them

  for (int r = warp; r < R; r += nwarps) {
    const float m = m_run[r], l = l_run[r];
    if (n_splits == 1) {
      const int j = r / G, g = r - j * G;
      float* o = out + (((size_t)b * WQ + j) * H + h * G + g) * D;
      for (int d = lane; d < D; d += 32)
        o[d] = acc[r * D + d] / (l == 0.f ? 1.f : l);
    } else {
      const size_t part = (((size_t)b * KV + h) * n_splits + s) * R + r;
      for (int d = lane; d < D; d += 32)
        part_acc[part * D + d] = acc[r * D + d];
      if (lane == 0) {
        part_ml[part * 2] = m;
        part_ml[part * 2 + 1] = l;
      }
    }
  }
}

// Merge a slot's splits in ascending split order: out = sum_s acc_s *
// exp(m_s - M) / sum_s l_s * exp(m_s - M), M the largest m_s.  One block
// per (KV head, slot, query row), threads over D; the splits' (m, l) are
// staged in shared memory first, so the loads of every split go out
// together.
__global__ void __launch_bounds__(256) paged_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int* __restrict__ lengths, float* __restrict__ out, int H, int KV,
    int D, int page, int n_entries, int WQ, int window, int ring, int pps,
    int n_splits) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int r = blockIdx.z;
  const int G = H / KV;
  const int R = WQ * G;
  const Walk w = slot_walk(lengths[b], WQ, window, ring, page, n_entries, pps);
  const int n = w.s_hi - w.s_lo;
  const size_t first = (((size_t)b * KV + h) * n_splits + w.s_lo) * R + r;
  extern __shared__ float ml[];  // (m, l) of each split of the slot
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    ml[2 * i] = part_ml[(first + (size_t)i * R) * 2];
    ml[2 * i + 1] = part_ml[(first + (size_t)i * R) * 2 + 1];
  }
  __syncthreads();
  float M = NEG_INF;
  for (int i = 0; i < n; ++i) M = fmaxf(M, ml[2 * i]);
  float L = 0.f;
  for (int i = 0; i < n; ++i) L += ml[2 * i + 1] * expf(ml[2 * i] - M);
  const int j = r / G, g = r - j * G;
  float* o = out + (((size_t)b * WQ + j) * H + h * G + g) * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float A = 0.f;
#pragma unroll 4
    for (int i = 0; i < n; ++i)
      A += part_acc[(first + (size_t)i * R) * D + d] * expf(ml[2 * i] - M);
    o[d] = A / (L == 0.f ? 1.f : L);
  }
}

template <int QUANT, int RPW>
cudaError_t launch_rows(const float* q, const void* k_pages,
                        const void* v_pages, const float* k_scale,
                        const float* v_scale, const int* block_tables,
                        const int* lengths, float* out, float* part_acc,
                        float* part_ml, int B, int H, int KV, int D, int page,
                        int n_entries, int WQ, int window, int ring, int pps,
                        float scale, cudaStream_t stream) {
  const int R = WQ * (H / KV);
  const size_t sb = (stage_bytes<QUANT>(page, D) + 15) & ~15;
  const size_t smem = STAGES * sb + sizeof(float) * (2 * (size_t)R * D + 2 * R);
  auto kernel = paged_attention_kernel<QUANT, RPW>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  // one warp per RPW rows, between 4 and 8 warps
  const int threads = 32 * min(8, max(4, (R + RPW - 1) / RPW));
  const int n_splits = (n_entries + pps - 1) / pps;
  dim3 grid(KV, B, n_splits);
  kernel<<<grid, threads, smem, stream>>>(
      q, k_pages, v_pages, k_scale, v_scale, block_tables, lengths, out,
      part_acc, part_ml, H, KV, D, page, n_entries, WQ, window, ring, pps,
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  const size_t ml_bytes = sizeof(float) * 2 * n_splits;
  if (ml_bytes > 48 * 1024) return cudaErrorInvalidValue;
  paged_combine_kernel<<<dim3(KV, B, R), min(256, (D + 31) / 32 * 32),
                         ml_bytes, stream>>>(
      part_acc, part_ml, lengths, out, H, KV, D, page, n_entries, WQ, window,
      ring, pps, n_splits);
  return cudaGetLastError();
}

// Rows per warp: enough that 8 warps cover the K*G rows, while a lane holds
// at most 16 dims (RPW * D <= 512).
template <int QUANT>
cudaError_t launch(const float* q, const void* k_pages, const void* v_pages,
                   const float* k_scale, const float* v_scale,
                   const int* block_tables, const int* lengths, float* out,
                   float* part_acc, float* part_ml, int B, int H, int KV,
                   int D, int page, int n_entries, int WQ, int window,
                   int ring, int pps, float scale, cudaStream_t stream) {
  const int R = WQ * (H / KV);
  int rpw = 1;
  while (rpw < 8 && rpw * 8 < R && rpw * 2 * D <= 512) rpw *= 2;
  auto go = rpw == 1   ? launch_rows<QUANT, 1>
            : rpw == 2 ? launch_rows<QUANT, 2>
            : rpw == 4 ? launch_rows<QUANT, 4>
                       : launch_rows<QUANT, 8>;
  return go(q, k_pages, v_pages, k_scale, v_scale, block_tables, lengths, out,
            part_acc, part_ml, B, H, KV, D, page, n_entries, WQ, window, ring,
            pps, scale, stream);
}

}  // namespace

// part_acc (B, KV, n_splits, K*G, D) and part_ml (B, KV, n_splits, K*G, 2)
// are f32 scratch, n_splits = ceil(n_entries / pps); unused (may be null)
// when n_splits == 1.
extern "C" int paged_attention(
    const float* q, const void* k_pages, const void* v_pages,
    const float* k_scale, const float* v_scale, const int* block_tables,
    const int* lengths, float* out, float* part_acc, float* part_ml, int B,
    int H, int KV, int D, int page, int n_entries, int quant, int WQ,
    int window, int ring, int pps, float scale, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (quant) {
    case QUANT_NONE:
      return (int)launch<QUANT_NONE>(q, k_pages, v_pages, k_scale, v_scale,
                                     block_tables, lengths, out, part_acc,
                                     part_ml, B, H, KV, D, page, n_entries, WQ,
                                     window, ring, pps, scale, st);
    case QUANT_INT8:
      return (int)launch<QUANT_INT8>(q, k_pages, v_pages, k_scale, v_scale,
                                     block_tables, lengths, out, part_acc,
                                     part_ml, B, H, KV, D, page, n_entries, WQ,
                                     window, ring, pps, scale, st);
    case QUANT_INT4:
      return (int)launch<QUANT_INT4>(q, k_pages, v_pages, k_scale, v_scale,
                                     block_tables, lengths, out, part_acc,
                                     part_ml, B, H, KV, D, page, n_entries, WQ,
                                     window, ring, pps, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
