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
// Bound on the H100: bytes at serving shapes.  At B = 8, H = KH = 16,
// T = S = 128, d = 128 the causal work is ~0.54 GFLOP on 16.8 MB of q, k,
// v and out (~65 flops a byte, under the ~295 flop/byte ridge): 5.0 us.
// The first port ran every product as f32 FMAs on the CUDA cores, one
// thread per query row for the softmax and four barriers a 32-key tile,
// and took 25x that: instruction latency, not bandwidth.  Design:
//   * one block of 4 warps per (64-query tile, head h, batch b); each warp
//     owns 16 query rows, whose Q fragments stay in registers (ldmatrix
//     once) for the whole block;
//   * Q.K^T and P.V on the tensor cores: mma.sync m16n8k16 bf16 -> f32,
//     K fragments by ldmatrix, V fragments by ldmatrix.trans, the score
//     and output accumulators in registers.  mma.sync (not wgmma) is
//     enough at the serving shape, where the bound is bytes, and 16-row
//     warp tiles keep the ragged T of a prompt cheap;
//   * the online softmax per row in registers, in log2 units (exp2): each
//     row's 64 scores of a tile lie in the 4 lanes of a quad, so its max
//     is a 2-step shuffle; the row sums stay per lane and are reduced once
//     at the end.  P is rounded to bf16 before P.V, as the Pallas body
//     does (p.astype(v_ref.dtype));
//   * K/V tiles of 64 rows stream through a 2-stage cp.async ring in
//     dynamic shared memory (87 KB at d = 128, the carveout set to its
//     largest so two blocks share an SM), so the next tile loads while
//     this one computes; rows are padded by 16 bytes so the 8 rows an
//     ldmatrix reads fall in 8 different bank groups.  Rows past T or S
//     are zero-filled by the copy itself;
//   * the block walks K/V tiles only from its window start to the causal
//     limit of its last row; a warp whose rows see no key of a tile skips
//     it, and only a tile that crosses the diagonal, the window edge or S
//     is masked element by element.  The softcap (softcap * tanh(s /
//     softcap)) comes before the mask; a masked score is -1e30 and gives
//     p = 0, and l is floored at 1e-30, so a row with no allowed key
//     writes zeros;
//   * the output goes back through the warp's own Q rows in shared memory
//     and leaves as 16-byte stores.
//   * d = 256 (gemma2-9b) keeps the body with two changes (`Smem`): each
//     warp reads its Q fragment from shared memory at each k-step instead
//     of holding 64 registers of it, and a K/V tile holds 32 keys, not 64.
//     Its 16 x 256 f32 output accumulator is 128 registers a lane; ptxas
//     (nvcc 12.8, -Xptxas -v) reports 238 registers and 0 bytes of spill
//     stores and loads for it (215 at d = 128), with 99 KB of dynamic
//     shared memory: two blocks an SM.  The d <= 128 instantiations
//     compile the code they did before, so their bits do not move.
// Left for later: wgmma with TMA loads and a producer warp.  Long prompts
// are where it shows: at T = S = 512 the kernel does its causal products
// at about a third of SDPA's rate (PERF.md), as each warp reads the whole
// K/V tile from shared memory for its 16 rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

using namespace async_copy;

constexpr int NW = 4;             // warps per block
constexpr int NT = NW * 32;       // threads per block
constexpr int BQ = 16 * NW;       // query rows per block (16 per warp)
constexpr int STAGES = 2;         // K/V tiles in flight
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Tiling of the D instantiation.  Up to d = 128 a K/V tile holds 64 keys
// and each warp keeps its Q fragments in registers.  At d = 256 the 16 x
// 256 f32 output accumulator alone takes 128 registers a lane, so a warp
// reads its Q fragments from shared memory at each k-step (not 64 more
// registers) and a tile holds 32 keys (a 16-register score tile): no
// spill, and 99 KB of shared memory, so two blocks share an SM.
template <int D>
struct Smem {
  static constexpr int BK = D > 128 ? 32 : 64;   // key rows per K/V tile
  static constexpr bool Q_IN_REGS = D <= 128;
  static constexpr int LD = D + 8;
  static constexpr int Q = BQ * LD;
  static constexpr int KV = BK * LD;
  // dynamic shared memory, in bf16 elements: the Q tile, then STAGES K
  // tiles, then STAGES V tiles, each row padded by 8
  static constexpr int BYTES = (Q + 2 * STAGES * KV) * 2;
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c (16x8 f32) += a (16x16 bf16, row) . b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Fragment layout of mma.m16n8k16 (lane = 4 * g + tq): an accumulator
// c[0..1] is (row g, cols 2tq, 2tq+1), c[2..3] is (row g+8, the same
// cols); an A fragment a[0..3] is (row g | g+8, cols 2tq.. | 2tq+8..).
template <int D>
__global__ void __launch_bounds__(NT) flash_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    int H, int KH, int T, int S, int causal, int window, float softcap,
    float scale) {
  static_assert(D % 16 == 0 && D <= 256, "head_dim");
  using L = Smem<D>;
  constexpr int BK = L::BK;
  constexpr int LD = L::LD;
  constexpr int KS = D / 16;      // k-steps of Q.K^T
  constexpr int NO = D / 8;       // n-tiles of the output
  constexpr int NS = BK / 8;      // n-tiles of a score tile
  constexpr int VPR = D / 8;      // 16-byte vectors a row
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  __nv_bfloat16* sq = smem;
  __nv_bfloat16* sk = smem + L::Q;
  __nv_bfloat16* sv = sk + STAGES * L::KV;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int kh = h / (H / KH);
  const float scale_log2 = scale * LOG2E;
  const __nv_bfloat16* qb = q + ((size_t)b * H + h) * T * D;
  const __nv_bfloat16* kb = k + ((size_t)b * KH + kh) * S * D;
  const __nv_bfloat16* vb = v + ((size_t)b * KH + kh) * S * D;
  __nv_bfloat16* ob = out + ((size_t)b * H + h) * T * D;

  // key range any valid row of this tile can see
  const int q_last = min(T, q0 + BQ) - 1;
  const int k_end = causal ? min(S, q_last + 1) : S;
  const int k_beg = window >= 0 ? max(0, q0 - window + 1) : 0;
  const int n_tiles = k_end > k_beg ? (k_end - k_beg + BK - 1) / BK : 0;

  for (int i = tid; i < BQ * VPR; i += NT) {
    const int r = i / VPR, c = i % VPR;
    const bool ok = q0 + r < T;
    cp_async16(sq + r * LD + c * 8, qb + (size_t)(ok ? q0 + r : 0) * D + c * 8,
               ok);
  }
  // one tile's K rows, or its V rows, into its stage; rows past k_end
  // (past S, or past the causal limit of the tile's last row) are zeros
  auto load = [&](const __nv_bfloat16* src, __nv_bfloat16* dst, int tile) {
    const int k0 = k_beg + tile * BK;
    dst += (tile % STAGES) * L::KV;
    for (int i = tid; i < BK * VPR; i += NT) {
      const int j = i / VPR, c = i % VPR;
      const bool ok = k0 + j < k_end;
      cp_async16(dst + j * LD + c * 8,
                 src + (size_t)(ok ? k0 + j : 0) * D + c * 8, ok);
    }
  };
  // copy groups, in order: {Q, K0, V0}, {K1, V1}, ...
  if (n_tiles > 0) {
    load(kb, sk, 0);
    load(vb, sv, 0);
  }
  cp_async_commit();

  const int r0 = warp * 16;               // the warp's first row in the tile
  const int qpos[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  uint32_t qf[L::Q_IN_REGS ? KS : 1][4];
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  const int qw0 = q0 + r0;                // the warp's first query row
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      load(kb, sk, it + 1);
      load(vb, sv, it + 1);
      cp_async_commit();
      cp_async_wait<1>();     // this tile has landed, the next is in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (L::Q_IN_REGS) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          ldmatrix_x4(qf[kk], sq + (r0 + (lane & 15)) * LD + kk * 16 +
                                  (lane >> 4) * 8);
      }
    }
    const __nv_bfloat16* ks = sk + (it % STAGES) * L::KV;
    const __nv_bfloat16* vs = sv + (it % STAGES) * L::KV;
    const int k0 = k_beg + it * BK;
    // a warp whose 16 rows see no key of this tile skips it: the same bits
    // as p = 0 everywhere (alpha = 1, nothing added)
    const bool idle = qw0 >= T || (causal && k0 > qw0 + 15) ||
                      (window >= 0 && qw0 - (k0 + BK - 1) >= window);

    if (!idle) {
      // S = Q K^T: one ldmatrix.x4 gives the B fragments of 16 keys
      float s[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qs[4];
        if constexpr (!L::Q_IN_REGS)  // d = 256: from the warp's rows of sq
          ldmatrix_x4(qs, sq + (r0 + (lane & 15)) * LD + kk * 16 +
                              (lane >> 4) * 8);
        const uint32_t(&qa)[4] = L::Q_IN_REGS ? qf[kk] : qs;
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t kf[4];
          ldmatrix_x4(kf, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                   LD + kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], qa, kf[0], kf[1]);
          mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
        }
      }

      // scale, softcap, then the mask where this tile needs one; scores are
      // kept in log2 units (times log2 e), so p = exp2(x - max)
      const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > q0) ||
                        (window >= 0 && q0 + BQ - 1 - k0 >= window);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x;
          if (softcap > 0.f)
            x = softcap * tanhf(s[n][e] * scale / softcap) * LOG2E;
          else
            x = s[n][e] * scale_log2;
          if (edge) {
            const int qp = qpos[e >> 1], kp = k0 + n * 8 + tq * 2 + (e & 1);
            bool allow = kp < S;
            if (causal) allow = allow && kp <= qp;
            if (window >= 0) allow = allow && qp - kp < window;
            if (!allow) x = NEG_INF;
          }
          s[n][e] = x;
        }
      }

      // online softmax: rows g (e = 0, 1) and g + 8 (e = 2, 3)
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int n = 0; n < NS; ++n)
          mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        alpha[r] = exp2f(m[r] - mx);
        m[r] = mx;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const float x = s[n][e];
            const float p = x <= 0.5f * NEG_INF ? 0.f : exp2f(x - mx);
            s[n][e] = p;
            sum += p;
          }
        }
        l[r] = l[r] * alpha[r] + sum;
      }
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }

      // O += P V: the score accumulators of 16 keys are the A fragment
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, vs + (kk * 16 + (lane & 7) +
                                      ((lane >> 3) & 1) * 8) * LD +
                                    np * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * np], pa, vf[0], vf[1]);
          mma_bf16(o[2 * np + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // the next iteration's copy overwrites this stage
  }

  // epilogue: the quad's row sums, then the rows through the warp's own Q
  // rows in shared memory, out as 16-byte stores
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  __nv_bfloat16* so = sq + r0 * LD;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<uint32_t*>(so + g * LD + n * 8 + tq * 2) =
        pack_bf16(o[n][0] * l[0], o[n][1] * l[0]);
    *reinterpret_cast<uint32_t*>(so + (g + 8) * LD + n * 8 + tq * 2) =
        pack_bf16(o[n][2] * l[1], o[n][3] * l[1]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * VPR; i += 32) {
    const int r = i / VPR, c = i % VPR;
    if (q0 + r0 + r < T)
      *reinterpret_cast<uint4*>(ob + (size_t)(q0 + r0 + r) * D + c * 8) =
          *reinterpret_cast<const uint4*>(so + r * LD + c * 8);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int KH, int T, int S, int causal, int window, float softcap,
           float scale, cudaStream_t stream) {
  constexpr int bytes = Smem<D>::BYTES;
  // over 48 KB of dynamic shared memory, and the carveout at its largest so
  // that two blocks fit an SM
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_attention_kernel<D>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_attention_kernel<D><<<grid, NT, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      H, KH, T, S, causal, window, softcap, scale);
  return (int)cudaGetLastError();
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
    case 16: return launch<16>(q, k, v, out, B, H, KH, T, S, causal, window, softcap, scale, st);
    case 64: return launch<64>(q, k, v, out, B, H, KH, T, S, causal, window, softcap, scale, st);
    case 128: return launch<128>(q, k, v, out, B, H, KH, T, S, causal, window, softcap, scale, st);
    case 256: return launch<256>(q, k, v, out, B, H, KH, T, S, causal, window, softcap, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
