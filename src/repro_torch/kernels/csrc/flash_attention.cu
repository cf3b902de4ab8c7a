// Causal prefill (flash) attention, forward only, for sm_90a.
//
// Replaces repro/kernels/flash_attention.py::flash_attention (Pallas body
// _flash_kernel).  Same function as
// repro_torch/kernels/ref.py::flash_attention_ref:
//
//   q (B, H, T, D) bf16; k, v (B, KH, S, D) bf16 -> out (B, H, T, D) bf16
//
// Query head h reads KV head h / G (G = H / KH).  Query row t may see key
// row s when s < S, s <= t (causal) and t - s < window (window >= 0).
// Unlike the Pallas kernel, which asserts T % bq == 0 and S % bk == 0, the
// ragged T and S edges are masked here: the serving engine's T is its
// prompt length.
//
// Bound on the H100: bytes at serving shapes.  At T = S = 128, d = 128 the
// causal work is ~65 flops per byte of q, k, v and out, under the ~295
// flop/byte ridge.  Design:
//   * one block per (q tile of BQ rows, head h, batch b); the q tile stays
//     in shared memory (f32, pre-scaled) for the whole block;
//   * the block loops over K/V tiles of BK rows only up to the causal (and
//     window) limit of its last query row, so masked tiles cost nothing;
//   * scores and the P.V product use f32 FMAs on the CUDA cores, with the
//     online softmax (running max, sum) in f32;
//   * each thread owns one output column for RPT rows, so one V element
//     read from shared memory feeds RPT FMAs.
// Not yet done (a later PR): tensor-core (mma/wgmma) tiles, and TMA or
// cp.async double buffering of the K/V stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;   // threads per block (4 warps)
constexpr int BQ = 32;    // query rows per block
constexpr int BK = 32;    // key rows per tile (one per lane in the score pass)
constexpr float NEG_INF = -1e30f;

template <int D>
__global__ void __launch_bounds__(NT) flash_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    int H, int KH, int T, int S, int causal, int window, float softcap,
    float scale) {
  static_assert(D % 8 == 0 && NT % D == 0 && D <= NT, "head_dim");
  constexpr int RG = NT / D;        // row groups
  constexpr int RPT = BQ / RG;      // output rows per thread
  constexpr int VPR = D / 8;        // 16-byte vectors per row
  constexpr int NW = NT / 32;       // warps
  constexpr int RPW = BQ / NW;      // score rows per warp
  __shared__ float qs[BQ][D];
  __shared__ float ks[BK][D + 1];   // +1: lanes read different rows
  __shared__ __align__(16) __nv_bfloat16 vs[BK][D];
  __shared__ float ps[BQ][BK + 1];
  __shared__ float m_s[BQ], l_s[BQ], alpha_s[BQ];

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kh = h / (H / KH);
  const __nv_bfloat16* qb = q + ((size_t)b * H + h) * T * D;
  const __nv_bfloat16* kb = k + ((size_t)b * KH + kh) * S * D;
  const __nv_bfloat16* vb = v + ((size_t)b * KH + kh) * S * D;
  __nv_bfloat16* ob = out + ((size_t)b * H + h) * T * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D;
    qs[r][d] = q0 + r < T ? __bfloat162float(qb[(size_t)(q0 + r) * D + d]) * scale
                          : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  const int col = tid % D, rg = tid / D;
  float acc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = 0.f;

  // key range any valid row of this tile can see
  const int q_last = min(T, q0 + BQ) - 1;
  const int k_end = causal ? min(S, q_last + 1) : S;
  const int k_beg = window >= 0 ? max(0, q0 - window + 1) : 0;
  __syncthreads();

  for (int k0 = k_beg; k0 < k_end; k0 += BK) {
    const int n = min(BK, k_end - k0);
    for (int i = tid; i < n * VPR; i += NT) {
      const int j = i / VPR, c = i % VPR;
      const uint4 kv = reinterpret_cast<const uint4*>(kb + (size_t)(k0 + j) * D)[c];
      const __nv_bfloat16* ke = reinterpret_cast<const __nv_bfloat16*>(&kv);
#pragma unroll
      for (int e = 0; e < 8; ++e) ks[j][c * 8 + e] = __bfloat162float(ke[e]);
      reinterpret_cast<uint4*>(&vs[j][0])[c] =
          reinterpret_cast<const uint4*>(vb + (size_t)(k0 + j) * D)[c];
    }
    __syncthreads();

    // scores: warp w owns rows w + NW * rr, lane owns key row k0 + lane
    {
      float s[RPW];
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) s[rr] = 0.f;
      if (lane < n) {
        for (int d = 0; d < D; ++d) {
          const float kd = ks[lane][d];
#pragma unroll
          for (int rr = 0; rr < RPW; ++rr) s[rr] += qs[warp + NW * rr][d] * kd;
        }
      }
      const int kpos = k0 + lane;
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const int i = warp + NW * rr, qpos = q0 + i;
        bool allow = lane < n && qpos < T;
        if (causal) allow = allow && kpos <= qpos;
        if (window >= 0) allow = allow && qpos - kpos < window;
        float x = s[rr];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        ps[i][lane] = allow ? x : NEG_INF;
      }
    }
    __syncthreads();

    // online-softmax update, one thread per query row; masked entries -> 0
    if (tid < BQ) {
      const float m_prev = m_s[tid];
      float m_new = m_prev;
      for (int j = 0; j < n; ++j) m_new = fmaxf(m_new, ps[tid][j]);
      float sum = 0.f;
      for (int j = 0; j < n; ++j) {
        const float x = ps[tid][j];
        const float p = x <= 0.5f * NEG_INF ? 0.f : expf(x - m_new);
        ps[tid][j] = p;
        sum += p;
      }
      const float alpha = expf(m_prev - m_new);
      l_s[tid] = l_s[tid] * alpha + sum;
      m_s[tid] = m_new;
      alpha_s[tid] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int i = rg + RG * r;
      float a = acc[r] * alpha_s[i];
      for (int j = 0; j < n; ++j) a += ps[i][j] * __bfloat162float(vs[j][col]);
      acc[r] = a;
    }
    __syncthreads();  // the next tile overwrites ks, vs and ps
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int i = rg + RG * r;
    if (q0 + i < T)
      ob[(size_t)(q0 + i) * D + col] =
          __float2bfloat16(acc[r] / fmaxf(l_s[i], 1e-30f));
  }
}

template <int D>
void launch(const void* q, const void* k, const void* v, void* out, int B,
            int H, int KH, int T, int S, int causal, int window, float softcap,
            float scale, cudaStream_t stream) {
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_attention_kernel<D><<<grid, NT, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      H, KH, T, S, causal, window, softcap, scale);
}

}  // namespace

extern "C" int repro_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* out, int B, int H,
    int KH, int T, int S, int D, int causal, int window, float softcap,
    float scale, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || KH <= 0 || H % KH != 0 || H > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: launch<16>(q, k, v, out, B, H, KH, T, S, causal, window, softcap, scale, st); break;
    case 64: launch<64>(q, k, v, out, B, H, KH, T, S, causal, window, softcap, scale, st); break;
    case 128: launch<128>(q, k, v, out, B, H, KH, T, S, causal, window, softcap, scale, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
