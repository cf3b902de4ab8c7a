// Paged decode attention (one query token per slot) for sm_90a.
//
// Replaces repro/kernels/decode_attention.py::paged_decode_attention_kernel_call
// (Pallas bodies _decode_kernel / _decode_body).  Same function as
// repro_torch/kernels/ref.py::paged_decode_attention_ref:
//
//   q (B, H, D) bf16; k, v (B, S, KH, D) bf16; seq_lens (B,) int32
//   -> out (B, H, D) bf16
//
// Query head h reads KV head h / G (G = H / KH).  Slot b attends the cache
// rows kv_pos < seq_lens[b], and with a window only those with
// (seq_lens[b] - 1) - kv_pos < window.  A slot with seq_len 0 writes zeros.
//
// Bound on the H100: bytes.  Each valid K/V row is read once and used for
// G query heads only (2 * G flops per byte), far under the ~295 flop/byte
// ridge, so the kernel's job is to stream seq_len rows per slot and touch
// nothing else.  Design:
//   * one block per (slot b, KV head): the G query heads of that KV head
//     share every K/V row the block loads;
//   * the block walks only [window start, seq_len) in tiles of TILE rows
//     staged through shared memory with 16-byte loads; no row past the
//     slot's length is read, so the cache needs no padding;
//   * online softmax in f32 (running max, sum and accumulator), as the
//     Pallas body keeps in VMEM scratch.
// Not yet done (a later PR): double-buffered cp.async/TMA staging, and
// splitting long caches over several blocks per (b, KV head) to fill the
// 132 SMs when B * KH is small.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;         // threads per block
constexpr int TILE = 64;        // KV rows per shared-memory tile
constexpr int MAX_GD = 1024;    // G * D a block holds (accumulators)
constexpr int NACC = MAX_GD / NT;
constexpr float NEG_INF = -1e30f;

template <int D>
__global__ void __launch_bounds__(NT) decode_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ seq_lens,
    __nv_bfloat16* __restrict__ out, int H, int KH, int S, int window,
    float softcap, float scale) {
  static_assert(D % 8 == 0 && MAX_GD % D == 0, "head_dim");
  constexpr int MAXG = MAX_GD / D;
  constexpr int VPR = D / 8;    // 16-byte vectors per K/V row
  __shared__ float qs[MAXG * D];
  __shared__ __align__(16) __nv_bfloat16 ks[TILE * D];
  __shared__ __align__(16) __nv_bfloat16 vs[TILE * D];
  __shared__ float ps[MAXG * TILE];
  __shared__ float m_s[MAXG], l_s[MAXG], alpha_s[MAXG];

  const int b = blockIdx.x, kh = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int G = H / KH;
  const int GD = G * D;
  // rows past S do not exist; clamping keeps a bad length from reading
  // outside the cache (the plain version treats such a slot as full)
  const int sl = min(max(seq_lens[b], 0), S);
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

  const size_t row = (size_t)KH * D;  // elements between consecutive kv_pos
  const __nv_bfloat16* kb = k + (size_t)b * S * row + (size_t)kh * D;
  const __nv_bfloat16* vb = v + (size_t)b * S * row + (size_t)kh * D;

  for (int t0 = lo; t0 < sl; t0 += TILE) {
    const int n = min(TILE, sl - t0);
    for (int i = tid; i < n * VPR; i += NT) {
      const int j = i / VPR, c = i % VPR;
      reinterpret_cast<uint4*>(ks)[i] =
          reinterpret_cast<const uint4*>(kb + (size_t)(t0 + j) * row)[c];
      reinterpret_cast<uint4*>(vs)[i] =
          reinterpret_cast<const uint4*>(vb + (size_t)(t0 + j) * row)[c];
    }
    __syncthreads();

    // scores: one warp per (query head g, row j); lanes split D
    for (int pj = warp; pj < G * n; pj += NT / 32) {
      const int g = pj / n, j = pj % n;
      float s = 0.f;
      for (int d = lane; d < D; d += 32)
        s += qs[g * D + d] * __bfloat162float(ks[j * D + d]);
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
        for (int j = 0; j < n; ++j)
          a += pg[j] * __bfloat162float(vs[j * D + d]);
        acc[r] = a;
      }
    }
    __syncthreads();  // the next tile overwrites ks, vs and ps
  }

  __nv_bfloat16* ob = out + ((size_t)b * H + (size_t)kh * G) * D;
#pragma unroll
  for (int r = 0; r < NACC; ++r) {
    const int i = tid + r * NT;
    if (i < GD) ob[i] = __float2bfloat16(acc[r] / fmaxf(l_s[i / D], 1e-30f));
  }
}

template <int D>
void launch(const void* q, const void* k, const void* v, const int* seq_lens,
            void* out, int B, int H, int KH, int S, int window, float softcap,
            float scale, cudaStream_t stream) {
  decode_attention_kernel<D><<<dim3(B, KH), NT, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), seq_lens,
      static_cast<__nv_bfloat16*>(out), H, KH, S, window, softcap, scale);
}

}  // namespace

extern "C" int repro_decode_attention_bf16(
    const void* q, const void* k, const void* v, const void* seq_lens,
    void* out, int B, int H, int KH, int S, int D, int window, float softcap,
    float scale, void* stream) {
  if (B <= 0 || KH <= 0 || H % KH != 0 || (H / KH) * D > MAX_GD)
    return (int)cudaErrorInvalidValue;
  const int* sl = static_cast<const int*>(seq_lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: launch<16>(q, k, v, sl, out, B, H, KH, S, window, softcap, scale, st); break;
    case 64: launch<64>(q, k, v, sl, out, B, H, KH, S, window, softcap, scale, st); break;
    case 128: launch<128>(q, k, v, sl, out, B, H, KH, S, window, softcap, scale, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
