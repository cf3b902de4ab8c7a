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
// under the ~295 flop/byte ridge.  At the serving shape (B = 8, H = KH =
// 16, d = 128, lengths 0-1024: 3,594 rows a head) that is 29.5 MB, 8.8 us.
// The first port ran one block per (slot, KV head): 128 blocks, the one
// holding the 1024-row slot walking 16 tiles alone, a serial one-thread
// softmax and four barriers a tile; it took 17x the bound.  Design:
//   * split-KV: each (slot, KV head) is cut into chunks of CHUNK logical
//     rows; one block per (chunk, KV head x head group, slot) computes a
//     partial (m, l, acc) over the rows of its chunk that the slot attends.
//     A chunk wholly past seq_len or before the window start exits at
//     once.  The chunk bounds and every sum's order are functions of the
//     logical row index alone (not of S, B, the grid or the card), so a
//     pooled launch computes the per-slot launch's bits on the gathered
//     view, and two launches on the same inputs agree bit for bit;
//   * no shared-memory staging: a lane holds 8 elements of a row (16 bytes
//     of bf16, 8 of int8, widened on read as (float)x * scale), D / 8
//     lanes a row, so a warp load covers 32 / (D / 8) rows; each lane
//     keeps U rows of K and V in flight, the score is a shuffle reduction
//     over the row's lanes, and every group of lanes keeps its own running
//     (m, l, acc) in registers over its rows (U + 1 exps for U rows);
//   * the groups of a warp merge by shuffles, the warps of a block once
//     through shared memory, at the end of the chunk;
//   * one launch: a chunk's partial goes to a workspace, and the last block
//     of a (slot, KV head, head group) to finish (a counter, after
//     __threadfence) combines the partials in chunk order, writes the
//     output and resets the counter for the next launch.  A slot whose
//     rows lie in one chunk skips the workspace.  The wrapper allocates
//     the workspace (repro_decode_attention_partials floats, B * H zeroed
//     counters) once and caches it;
//   * G query heads share each K/V row a block loads: up to GB = 8 heads a
//     block (their q slices and accumulators in registers), more heads in
//     more head groups.
// Left for later: TMA/cp.async staging of the rows of a pooled block, and
// a chunk size chosen per shape (it is fixed so the bits do not move).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NW = 4;             // warps per block
constexpr int NT = NW * 32;       // threads per block
constexpr int CHUNK = 128;        // logical rows a block walks
constexpr int MAX_GD = 1024;      // G * D the wrapper allows
constexpr float NEG_INF = -1e30f;

// Query heads a block holds for a head count G (GB in the kernel).
constexpr int heads_per_block(int G) { return G == 1 ? 1 : 8; }

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

// 8 elements of a row: one 16-byte load of bf16, one 8-byte load of int8.
template <typename T>
using Vec8 = typename std::conditional<std::is_same<T, int8_t>::value,
                                       uint2, uint4>::type;

// The 8 elements as f32: bf16 widened, int8 times its row's scale.
template <typename T>
__device__ __forceinline__ void widen(const Vec8<T>& raw, float sc,
                                      float (&x)[8]) {
  if constexpr (std::is_same<T, int8_t>::value) {
    const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = (float)e[i] * sc;
  } else {
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(e[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
}

// Merge a running softmax state (m, l, acc) with another (mo, lo, acco).
__device__ __forceinline__ void merge(float& m, float& l, float* acc, int n,
                                      float mo, float lo, const float* acco) {
  const float M = fmaxf(m, mo);
  const float a = expf(m - M), ao = expf(mo - M);
  l = l * a + lo * ao;
  for (int i = 0; i < n; ++i) acc[i] = acc[i] * a + acco[i] * ao;
  m = M;
}

template <int D, int GB, typename T, bool POOLED>
__global__ void __launch_bounds__(NT) decode_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const T* __restrict__ k,
    const float* __restrict__ k_scale, const T* __restrict__ v,
    const float* __restrict__ v_scale, const int* __restrict__ seq_lens,
    const Rows rows, __nv_bfloat16* __restrict__ out,
    float* __restrict__ part, int* __restrict__ count, int H, int KH,
    int window, float softcap, float scale) {
  constexpr bool Q8 = std::is_same<T, int8_t>::value;
  static_assert(D % 16 == 0 && D <= 128, "head_dim");
  constexpr int LPR = D / 8;             // lanes a row
  constexpr int RPW = 32 / LPR;          // rows a warp load covers
  constexpr int U = GB == 1 ? 8 : 2;     // warp loads a lane keeps in flight
  constexpr int STEP = NW * U * RPW;     // rows a block covers per step
  constexpr int PS = GB * (D + 2);       // floats of one partial
  __shared__ float wm[NW][GB], wl[NW][GB];
  __shared__ float wacc[NW][GB * D];
  __shared__ int last;

  const int c = blockIdx.x, y = blockIdx.y, b = blockIdx.z;
  const int G = H / KH, NHG = (G + GB - 1) / GB;
  const int kh = y / NHG, hg = y % NHG;
  const int h0 = kh * G + hg * GB;       // first query head of the block
  const int ng = min(GB, G - hg * GB);   // its query heads
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / LPR, sub = lane % LPR;
  __nv_bfloat16* ob = out + ((size_t)b * H + h0) * D;

  // rows past S do not exist; clamping keeps a bad length from reading
  // outside the cache (the plain version treats such a slot as full)
  const int sl = min(max(seq_lens[b], 0), rows.S);
  const int lo = window >= 0 ? max(0, sl - window) : 0;
  if (lo >= sl) {                        // nothing to attend: zeros, once
    if (c == 0)
      for (int i = tid; i < ng * D; i += NT) ob[i] = __float2bfloat16(0.f);
    return;
  }
  const int c_lo = lo / CHUNK, c_hi = (sl - 1) / CHUNK;
  if (c < c_lo || c > c_hi) return;
  const int rb = max(lo, c * CHUNK), re = min(sl, (c + 1) * CHUNK);

  float qv[GB][8], m[GB], l[GB], acc[GB][8];
#pragma unroll
  for (int gi = 0; gi < GB; ++gi) {
    if (gi < ng) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          q + ((size_t)b * H + h0 + gi) * D + sub * 8);
      widen<__nv_bfloat16>(raw, 1.f, qv[gi]);
#pragma unroll
      for (int e = 0; e < 8; ++e) qv[gi][e] *= scale;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qv[gi][e] = 0.f;
    }
    m[gi] = NEG_INF;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[gi][e] = 0.f;
  }

  const size_t rstride = (size_t)KH * D;   // elements between two rows
  for (int base = c * CHUNK + warp * U * RPW; base < re; base += STEP) {
    if (base + U * RPW <= rb) continue;
    Vec8<T> kr[U], vr[U];
    float ks[U], vs[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = base + u * RPW + grp;
      ok[u] = t >= rb && t < re;
      kr[u] = vr[u] = Vec8<T>{};
      ks[u] = vs[u] = 1.f;
      if (ok[u]) {
        const size_t row = cache_row<POOLED>(b, t, rows);
        const size_t at = row * rstride + (size_t)kh * D + sub * 8;
        kr[u] = *reinterpret_cast<const Vec8<T>*>(k + at);
        vr[u] = *reinterpret_cast<const Vec8<T>*>(v + at);
        if constexpr (Q8) {
          ks[u] = k_scale[row * KH + kh];
          vs[u] = v_scale[row * KH + kh];
        }
      }
    }
    // scores: the lane's 8 products, summed over the row's LPR lanes
    float s[U][GB];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[8];
      widen<T>(kr[u], ks[u], kf);
#pragma unroll
      for (int gi = 0; gi < GB; ++gi) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) d += qv[gi][e] * kf[e];
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        if (softcap > 0.f) d = softcap * tanhf(d / softcap);
        s[u][gi] = ok[u] ? d : NEG_INF;
      }
    }
    // online softmax over the U rows, head by head
#pragma unroll
    for (int gi = 0; gi < GB; ++gi) {
      float mx = m[gi];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][gi]);
      const float alpha = expf(m[gi] - mx);
      float p[U], sum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = s[u][gi] <= 0.5f * NEG_INF ? 0.f : expf(s[u][gi] - mx);
        sum += p[u];
      }
      l[gi] = l[gi] * alpha + sum;
      m[gi] = mx;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[gi][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float vf[8];
        widen<T>(vr[u], vs[u], vf);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[gi][e] += p[u] * vf[e];
      }
    }
  }

  // merge the row groups of the warp (lanes sub, sub + LPR, ...)
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int gi = 0; gi < GB; ++gi) {
      float ao[8];
      const float mo = __shfl_xor_sync(0xffffffffu, m[gi], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[gi], off);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        ao[e] = __shfl_xor_sync(0xffffffffu, acc[gi][e], off);
      merge(m[gi], l[gi], acc[gi], 8, mo, lo_, ao);
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int gi = 0; gi < GB; ++gi) {
      if (sub == 0) {
        wm[warp][gi] = m[gi];
        wl[warp][gi] = l[gi];
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) wacc[warp][gi * D + sub * 8 + e] = acc[gi][e];
    }
  }
  __syncthreads();

  // merge the warps in order; one chunk: out, else a partial
  const int nact = c_hi - c_lo + 1;
  const size_t slot = (size_t)b * gridDim.y + y;
  float* pp = part + (slot * gridDim.x + c) * PS;
  for (int i = tid; i < ng * D; i += NT) {
    const int gi = i / D;
    float M = NEG_INF;
    for (int w = 0; w < NW; ++w) M = fmaxf(M, wm[w][gi]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float a = expf(wm[w][gi] - M);
      L += wl[w][gi] * a;
      A += wacc[w][i] * a;
    }
    if (nact == 1) {
      ob[i] = __float2bfloat16(A / fmaxf(L, 1e-30f));
    } else {
      if (i % D == 0) {
        pp[gi] = M;
        pp[GB + gi] = L;
      }
      pp[2 * GB + i] = A;
    }
  }
  if (nact == 1) return;

  // the last block of this (slot, KV head, head group) combines
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(count + slot, 1) == nact - 1;
    if (last) count[slot] = 0;           // ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* p0 = part + slot * gridDim.x * PS;
  for (int i = tid; i < ng * D; i += NT) {
    const int gi = i / D;
    float M = NEG_INF;
    for (int cc = c_lo; cc <= c_hi; ++cc)
      M = fmaxf(M, __ldcg(p0 + cc * PS + gi));
    float L = 0.f, A = 0.f;
    for (int cc = c_lo; cc <= c_hi; ++cc) {
      const float a = expf(__ldcg(p0 + cc * PS + gi) - M);
      L += __ldcg(p0 + cc * PS + GB + gi) * a;
      A += __ldcg(p0 + cc * PS + 2 * GB + i) * a;
    }
    ob[i] = __float2bfloat16(A / fmaxf(L, 1e-30f));
  }
}

int chunks(int S) { return S > 0 ? (S + CHUNK - 1) / CHUNK : 1; }

int head_groups(int H, int KH) {
  const int G = H / KH, GB = heads_per_block(G);
  return (G + GB - 1) / GB;
}

template <int D, int GB, typename T, bool POOLED>
void launch(const void* q, const void* k, const void* k_scale, const void* v,
            const void* v_scale, const int* seq_lens, const Rows& rows,
            void* out, void* part, void* count, int B, int H, int KH,
            int window, float softcap, float scale, cudaStream_t stream) {
  const dim3 grid(chunks(rows.S), KH * head_groups(H, KH), B);
  decode_attention_kernel<D, GB, T, POOLED><<<grid, NT, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k),
      static_cast<const float*>(k_scale), static_cast<const T*>(v),
      static_cast<const float*>(v_scale), seq_lens, rows,
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(part),
      static_cast<int*>(count), H, KH, window, softcap, scale);
}

template <int D, typename T, bool POOLED>
void launch_g(const void* q, const void* k, const void* k_scale,
              const void* v, const void* v_scale, const int* seq_lens,
              const Rows& rows, void* out, void* part, void* count, int B,
              int H, int KH, int window, float softcap, float scale,
              cudaStream_t stream) {
  if (H == KH)
    launch<D, 1, T, POOLED>(q, k, k_scale, v, v_scale, seq_lens, rows, out,
                            part, count, B, H, KH, window, softcap, scale,
                            stream);
  else
    launch<D, 8, T, POOLED>(q, k, k_scale, v, v_scale, seq_lens, rows, out,
                            part, count, B, H, KH, window, softcap, scale,
                            stream);
}

// Checks the shape, picks the head_dim instantiation, launches; returns
// the launch's cudaError_t.
template <typename T, bool POOLED>
int dispatch(const void* q, const void* k, const void* k_scale,
             const void* v, const void* v_scale, const void* seq_lens,
             const Rows& rows, void* out, void* part, void* count, int B,
             int H, int KH, int D, int window, float softcap, float scale,
             void* stream) {
  if (B <= 0 || B > 65535 || KH <= 0 || H % KH != 0 ||
      (H / KH) * D > MAX_GD || rows.S < 0 ||
      (POOLED && (rows.nb <= 0 || rows.bs <= 0 || rows.NB <= 0)))
    return (int)cudaErrorInvalidValue;
  const int* sl = static_cast<const int*>(seq_lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      launch_g<16, T, POOLED>(q, k, k_scale, v, v_scale, sl, rows, out, part,
                              count, B, H, KH, window, softcap, scale, st);
      break;
    case 64:
      launch_g<64, T, POOLED>(q, k, k_scale, v, v_scale, sl, rows, out, part,
                              count, B, H, KH, window, softcap, scale, st);
      break;
    case 128:
      launch_g<128, T, POOLED>(q, k, k_scale, v, v_scale, sl, rows, out, part,
                               count, B, H, KH, window, softcap, scale, st);
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

// Floats of the workspace a launch over S logical rows a slot needs for
// its partials (the counters are B * H ints, zeroed once).
extern "C" long long repro_decode_attention_partials(int B, int H, int KH,
                                                     int S, int D) {
  if (B <= 0 || KH <= 0 || H % KH != 0) return -1;
  const int GB = heads_per_block(H / KH);
  return (long long)B * KH * head_groups(H, KH) * chunks(S) * GB * (D + 2);
}

// k, v (B, S, KH, D) bf16
extern "C" int repro_decode_attention_bf16(
    const void* q, const void* k, const void* v, const void* seq_lens,
    void* out, void* part, void* count, int B, int H, int KH, int S, int D,
    int window, float softcap, float scale, void* stream) {
  return dispatch<__nv_bfloat16, false>(
      q, k, nullptr, v, nullptr, seq_lens, per_slot(S), out, part, count, B,
      H, KH, D, window, softcap, scale, stream);
}

// k, v (B, S, KH, D) int8; k_scale, v_scale (B, S, KH) f32
extern "C" int repro_decode_attention_q8(
    const void* q, const void* k, const void* k_scale, const void* v,
    const void* v_scale, const void* seq_lens, void* out, void* part,
    void* count, int B, int H, int KH, int S, int D, int window,
    float softcap, float scale, void* stream) {
  return dispatch<int8_t, false>(q, k, k_scale, v, v_scale, seq_lens,
                                 per_slot(S), out, part, count, B, H, KH, D,
                                 window, softcap, scale, stream);
}

// k, v (NB, bs, KH, D) bf16 pool; tables (B, nb) int32
extern "C" int repro_decode_attention_bt_bf16(
    const void* q, const void* k, const void* v, const void* seq_lens,
    const void* tables, void* out, void* part, void* count, int B, int H,
    int KH, int NB, int bs, int nb, int D, int window, float softcap,
    float scale, void* stream) {
  return dispatch<__nv_bfloat16, true>(
      q, k, nullptr, v, nullptr, seq_lens, pooled(tables, NB, bs, nb), out,
      part, count, B, H, KH, D, window, softcap, scale, stream);
}

// k, v (NB, bs, KH, D) int8 pool; k_scale, v_scale (NB, bs, KH) f32;
// tables (B, nb) int32
extern "C" int repro_decode_attention_bt_q8(
    const void* q, const void* k, const void* k_scale, const void* v,
    const void* v_scale, const void* seq_lens, const void* tables, void* out,
    void* part, void* count, int B, int H, int KH, int NB, int bs, int nb,
    int D, int window, float softcap, float scale, void* stream) {
  return dispatch<int8_t, true>(q, k, k_scale, v, v_scale, seq_lens,
                                pooled(tables, NB, bs, nb), out, part, count,
                                B, H, KH, D, window, softcap, scale, stream);
}
