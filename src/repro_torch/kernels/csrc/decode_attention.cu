// Paged decode attention (one query token per slot) for sm_90a, over a
// per-slot cache or a pooled block-table cache, with bf16 or int8 rows.
//
// Replaces repro/kernels/decode_attention.py:
//   * paged_decode_attention_kernel_call, Pallas bodies _decode_kernel
//     (bf16 rows) and _decode_kernel_q (int8 rows, k_scale/v_scale);
//   * paged_decode_attention_bt_kernel_call, Pallas bodies _decode_kernel_bt
//     and _decode_kernel_bt_q (the same over a block pool).
// Same functions as repro_torch/kernels/ref.py::paged_decode_attention_ref
// and paged_decode_attention_bt_ref (with k_scale/v_scale for int8):
//
//   per slot: q (B, H, D) bf16; k, v (B, S, KH, D); seq_lens (B,) int32
//   pooled:   k, v (NB, bs, KH, D) pool; tables (B, nb) int32 maps logical
//             block j of slot b to pool block tables[b, j], clamped to
//             [0, NB - 1] (decode_attention.py:250); S = nb * bs logical rows
//   bf16 rows, or int8 rows + one f32 scale per (row, KV head): k_scale,
//   v_scale (B, S, KH) or (NB, bs, KH) (models/quant.quantize_kv);
//   -> out (B, H, D) bf16
//
// Query head h reads KV head h / G (G = H / KH).  Slot b attends the
// logical rows t < seq_lens[b], and with a window only those with
// (seq_lens[b] - 1) - t < window.  A slot with seq_len 0 writes zeros.
//
// Bound on the H100: bytes.  Each valid K/V row is read once and used for
// G query heads only (2 * G flops per byte of bf16, 4 * G of int8), far
// under the ~295 flop/byte ridge, so the kernel's job is to stream seq_len
// rows per slot and touch nothing else.  Design:
//   * one block per (slot b, KV head): the G query heads of that KV head
//     share every K/V row the block loads;
//   * the block walks only the logical rows [window start, seq_len) in
//     tiles of TILE rows staged through shared memory with 16-byte loads;
//     no row past the slot's length is read, so the cache needs no padding;
//   * where a row lies is the only thing the pooled variant changes: each
//     row's address goes through the slot's table (row by row, so a tile
//     may span pool blocks of any size bs), and the tile walk, the score,
//     softmax and accumulator order are those of the per-slot variant, so a
//     pooled launch computes the same bits as a per-slot launch on the
//     gathered view;
//   * int8 rows stage as int8 (TILE * D bytes; a row of D = 16 is one
//     16-byte vector) with the tile's TILE scales beside them, and each
//     element is widened on read, (float)x * scale, before its product, as
//     the Pallas body dequantises right after the load.  Staging f32 tiles
//     would need 64 KB of static shared memory at D = 128 (the limit is
//     48 KB);
//   * online softmax in f32 (running max, sum and accumulator), as the
//     Pallas body keeps in VMEM scratch.
// Not yet done (a later PR): double-buffered cp.async/TMA staging, and
// splitting long caches over several blocks per (b, KV head) to fill the
// 132 SMs when B * KH is small.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 128;         // threads per block
constexpr int TILE = 64;        // KV rows per shared-memory tile
constexpr int MAX_GD = 1024;    // G * D a block holds (accumulators)
constexpr int NACC = MAX_GD / NT;
constexpr float NEG_INF = -1e30f;

// Where the cache rows of slot b lie.
struct Rows {
  const int* tables;  // (B, nb) pool block of each logical block; per slot:
                      // unused
  int S;              // logical rows a slot can hold (pooled: nb * bs)
  int nb, bs, NB;     // pooled only
};

// Index of slot b's logical row t among the cache's rows (per slot:
// b * S + t; pooled: the row of the pool block that the table names).
template <bool POOLED>
__device__ __forceinline__ size_t cache_row(int b, int t, const Rows& r) {
  if constexpr (POOLED) {
    const int blk =
        min(max(r.tables[(size_t)b * r.nb + t / r.bs], 0), r.NB - 1);
    return (size_t)blk * r.bs + t % r.bs;
  } else {
    return (size_t)b * r.S + t;
  }
}

// Element (j, d) of a staged tile as f32: bf16 widened, int8 times the
// scale of its row.
template <int D, typename T>
__device__ __forceinline__ float tile_at(const T* tile, const float* sc,
                                         int j, int d) {
  if constexpr (std::is_same<T, int8_t>::value)
    return (float)tile[j * D + d] * sc[j];
  else
    return __bfloat162float(tile[j * D + d]);
}

template <int D, typename T, bool POOLED>
__global__ void __launch_bounds__(NT) decode_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const T* __restrict__ k,
    const float* __restrict__ k_scale, const T* __restrict__ v,
    const float* __restrict__ v_scale, const int* __restrict__ seq_lens,
    const Rows rows, __nv_bfloat16* __restrict__ out, int H, int KH,
    int window, float softcap, float scale) {
  constexpr bool Q8 = std::is_same<T, int8_t>::value;
  static_assert(D % 16 == 0 && MAX_GD % D == 0, "head_dim");
  constexpr int MAXG = MAX_GD / D;
  constexpr int VPR = D * (int)sizeof(T) / 16;  // 16-byte vectors per row
  __shared__ float qs[MAXG * D];
  __shared__ __align__(16) T ks[TILE * D];
  __shared__ __align__(16) T vs[TILE * D];
  __shared__ float kss[Q8 ? TILE : 1], vss[Q8 ? TILE : 1];
  __shared__ float ps[MAXG * TILE];
  __shared__ float m_s[MAXG], l_s[MAXG], alpha_s[MAXG];

  const int b = blockIdx.x, kh = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int G = H / KH;
  const int GD = G * D;
  // rows past S do not exist; clamping keeps a bad length from reading
  // outside the cache (the plain version treats such a slot as full)
  const int sl = min(max(seq_lens[b], 0), rows.S);
  const int lo = window >= 0 ? max(0, sl - window) : 0;

  // the G query rows of this KV head are contiguous: heads kh*G .. kh*G+G-1
  const __nv_bfloat16* qb = q + ((size_t)b * H + (size_t)kh * G) * D;
  for (int i = tid; i < GD; i += NT) qs[i] = __bfloat162float(qb[i]) * scale;
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[NACC];
#pragma unroll
  for (int r = 0; r < NACC; ++r) acc[r] = 0.f;
  __syncthreads();

  const size_t row = (size_t)KH * D;  // elements between consecutive rows

  for (int t0 = lo; t0 < sl; t0 += TILE) {
    const int n = min(TILE, sl - t0);
    for (int i = tid; i < n * VPR; i += NT) {
      const int j = i / VPR, c = i % VPR;
      const size_t at = cache_row<POOLED>(b, t0 + j, rows) * row + kh * D;
      reinterpret_cast<uint4*>(ks)[i] =
          reinterpret_cast<const uint4*>(k + at)[c];
      reinterpret_cast<uint4*>(vs)[i] =
          reinterpret_cast<const uint4*>(v + at)[c];
    }
    if constexpr (Q8) {
      for (int j = tid; j < n; j += NT) {
        const size_t at = cache_row<POOLED>(b, t0 + j, rows) * KH + kh;
        kss[j] = k_scale[at];
        vss[j] = v_scale[at];
      }
    }
    __syncthreads();

    // scores: one warp per (query head g, row j); lanes split D
    for (int pj = warp; pj < G * n; pj += NT / 32) {
      const int g = pj / n, j = pj % n;
      float s = 0.f;
      for (int d = lane; d < D; d += 32)
        s += qs[g * D + d] * tile_at<D>(ks, kss, j, d);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) {
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        ps[g * TILE + j] = s;
      }
    }
    __syncthreads();

    // online-softmax update, one thread per query head
    if (tid < G) {
      float* pg = ps + tid * TILE;
      const float m_prev = m_s[tid];
      float m_new = m_prev;
      for (int j = 0; j < n; ++j) m_new = fmaxf(m_new, pg[j]);
      float sum = 0.f;
      for (int j = 0; j < n; ++j) {
        const float p = expf(pg[j] - m_new);
        pg[j] = p;
        sum += p;
      }
      const float alpha = expf(m_prev - m_new);
      l_s[tid] = l_s[tid] * alpha + sum;
      m_s[tid] = m_new;
      alpha_s[tid] = alpha;
    }
    __syncthreads();

    // accumulator: thread owns flat (g, d) entries tid + r * NT
#pragma unroll
    for (int r = 0; r < NACC; ++r) {
      const int i = tid + r * NT;
      if (i < GD) {
        const int g = i / D, d = i % D;
        const float* pg = ps + g * TILE;
        float a = acc[r] * alpha_s[g];
        for (int j = 0; j < n; ++j) a += pg[j] * tile_at<D>(vs, vss, j, d);
        acc[r] = a;
      }
    }
    __syncthreads();  // the next tile overwrites ks, vs, their scales and ps
  }

  __nv_bfloat16* ob = out + ((size_t)b * H + (size_t)kh * G) * D;
#pragma unroll
  for (int r = 0; r < NACC; ++r) {
    const int i = tid + r * NT;
    if (i < GD) ob[i] = __float2bfloat16(acc[r] / fmaxf(l_s[i / D], 1e-30f));
  }
}

template <int D, typename T, bool POOLED>
void launch(const void* q, const void* k, const void* k_scale, const void* v,
            const void* v_scale, const int* seq_lens, const Rows& rows,
            void* out, int B, int H, int KH, int window, float softcap,
            float scale, cudaStream_t stream) {
  decode_attention_kernel<D, T, POOLED><<<dim3(B, KH), NT, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k),
      static_cast<const float*>(k_scale), static_cast<const T*>(v),
      static_cast<const float*>(v_scale), seq_lens, rows,
      static_cast<__nv_bfloat16*>(out), H, KH, window, softcap, scale);
}

// Checks the shape, picks the head_dim instantiation, launches; returns
// the launch's cudaError_t.
template <typename T, bool POOLED>
int dispatch(const void* q, const void* k, const void* k_scale,
             const void* v, const void* v_scale, const void* seq_lens,
             const Rows& rows, void* out, int B, int H, int KH, int D,
             int window, float softcap, float scale, void* stream) {
  if (B <= 0 || KH <= 0 || H % KH != 0 || (H / KH) * D > MAX_GD ||
      rows.S < 0 || (POOLED && (rows.nb <= 0 || rows.bs <= 0 || rows.NB <= 0)))
    return (int)cudaErrorInvalidValue;
  const int* sl = static_cast<const int*>(seq_lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      launch<16, T, POOLED>(q, k, k_scale, v, v_scale, sl, rows, out, B, H,
                            KH, window, softcap, scale, st);
      break;
    case 64:
      launch<64, T, POOLED>(q, k, k_scale, v, v_scale, sl, rows, out, B, H,
                            KH, window, softcap, scale, st);
      break;
    case 128:
      launch<128, T, POOLED>(q, k, k_scale, v, v_scale, sl, rows, out, B, H,
                             KH, window, softcap, scale, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

Rows per_slot(int S) { return Rows{nullptr, S, 0, 0, 0}; }

Rows pooled(const void* tables, int NB, int bs, int nb) {
  return Rows{static_cast<const int*>(tables), nb * bs, nb, bs, NB};
}

}  // namespace

// k, v (B, S, KH, D) bf16
extern "C" int repro_decode_attention_bf16(
    const void* q, const void* k, const void* v, const void* seq_lens,
    void* out, int B, int H, int KH, int S, int D, int window, float softcap,
    float scale, void* stream) {
  return dispatch<__nv_bfloat16, false>(q, k, nullptr, v, nullptr, seq_lens,
                                        per_slot(S), out, B, H, KH, D, window,
                                        softcap, scale, stream);
}

// k, v (B, S, KH, D) int8; k_scale, v_scale (B, S, KH) f32
extern "C" int repro_decode_attention_q8(
    const void* q, const void* k, const void* k_scale, const void* v,
    const void* v_scale, const void* seq_lens, void* out, int B, int H,
    int KH, int S, int D, int window, float softcap, float scale,
    void* stream) {
  return dispatch<int8_t, false>(q, k, k_scale, v, v_scale, seq_lens,
                                 per_slot(S), out, B, H, KH, D, window,
                                 softcap, scale, stream);
}

// k, v (NB, bs, KH, D) bf16 pool; tables (B, nb) int32
extern "C" int repro_decode_attention_bt_bf16(
    const void* q, const void* k, const void* v, const void* seq_lens,
    const void* tables, void* out, int B, int H, int KH, int NB, int bs,
    int nb, int D, int window, float softcap, float scale, void* stream) {
  return dispatch<__nv_bfloat16, true>(q, k, nullptr, v, nullptr, seq_lens,
                                       pooled(tables, NB, bs, nb), out, B, H,
                                       KH, D, window, softcap, scale, stream);
}

// k, v (NB, bs, KH, D) int8 pool; k_scale, v_scale (NB, bs, KH) f32;
// tables (B, nb) int32
extern "C" int repro_decode_attention_bt_q8(
    const void* q, const void* k, const void* k_scale, const void* v,
    const void* v_scale, const void* seq_lens, const void* tables, void* out,
    int B, int H, int KH, int NB, int bs, int nb, int D, int window,
    float softcap, float scale, void* stream) {
  return dispatch<int8_t, true>(q, k, k_scale, v, v_scale, seq_lens,
                                pooled(tables, NB, bs, nb), out, B, H, KH, D,
                                window, softcap, scale, stream);
}
