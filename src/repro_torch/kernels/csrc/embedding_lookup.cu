// Single-table embedding lookup (gather + sum / mean over the valency) for
// sm_90a.
//
// Replaces repro/kernels/embedding_lookup.py::lookup_kernel_call (Pallas
// body _lookup_kernel), the one-table SparseCore Fetch-unit model that the
// paper's Figure 9 benchmark drives through repro.kernels.ops.
// embedding_lookup.  Same function as repro_torch/kernels/ref.py::
// embedding_lookup_ref:
//
//   table (V, D) f32, row-major (a row slice of a row space is fine)
//   ids   (B, Vl) int32, -1 = no value
//   -> out (B, D) f32: the sum of the valid rows of sample b, or for a
//          mean their sum divided by their count floored at 1
//
// An id at or past V reads row V - 1 (JAX's mode="clip").  It gathers and
// combines in one pass: (B, Vl, D) is never built.
//
// Bound on the H100: bytes.  Each valid id reads one row of D floats once
// and adds it (one flop per 4 bytes).  The same design as fused_lookup.cu
// with one slot a sample:
//   * one warp per sample b; it loads 32 ids at once (coalesced),
//     broadcasts them with shuffles, and issues the loads of UNROLL rows
//     before it adds them; lane l owns float4 chunks l, l + 32, ... of the
//     row (16-byte loads, one row read by consecutive lanes);
//   * the sum and the count stay in f32 registers and are added in column
//     order, with no atomics: the result is the same run to run;
//   * row offsets are 64-bit (a dlrm0 row space holds ~1e9 elements).
// Not yet done (a later PR): packing several samples into one warp for
// narrow rows (D = 32 keeps 8 of 32 lanes busy) and TMA staging.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;        // samples per block
constexpr int NT = WARPS * 32;
constexpr int UNROLL = 4;       // rows whose loads are in flight per warp

__device__ __forceinline__ void add4(float4& acc, const float4& v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

template <int CPL>              // float4 chunks per lane: D <= 128 * CPL
__global__ void __launch_bounds__(NT) lookup_kernel(
    const float4* __restrict__ table, const int* __restrict__ ids,
    float4* __restrict__ out, int B, int Vl, int nch, int last, int mean) {
  const int b = blockIdx.x * WARPS + threadIdx.x / 32;
  if (b >= B) return;
  const int lane = threadIdx.x % 32;
  const int* __restrict__ rid = ids + (size_t)b * Vl;

  float4 acc[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  int cnt = 0;
  for (int c0 = 0; c0 < Vl; c0 += 32) {
    const int n = min(32, Vl - c0);
    const int mine = lane < n ? __ldg(rid + c0 + lane) : -1;
    for (int j = 0; j < n; j += UNROLL) {  // j <= 28, so j + u <= 31
      int r[UNROLL];
      float4 v[UNROLL][CPL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        r[u] = min(__shfl_sync(0xffffffffu, mine, j + u), last);
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int ch = lane + 32 * c;
          v[u][c] = (r[u] >= 0 && ch < nch)
                        ? __ldg(table + (size_t)r[u] * nch + ch)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (r[u] < 0) continue;             // the same for the whole warp
        ++cnt;
#pragma unroll
        for (int c = 0; c < CPL; ++c) add4(acc[c], v[u][c]);
      }
    }
  }

  const float denom = (mean != 0 && cnt > 0) ? (float)cnt : 1.f;
  float4* o = out + (size_t)b * nch;
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int ch = lane + 32 * c;
    if (ch < nch)
      o[ch] = make_float4(acc[c].x / denom, acc[c].y / denom,
                          acc[c].z / denom, acc[c].w / denom);
  }
}

}  // namespace

extern "C" int repro_embedding_lookup_f32(const void* table, const void* ids,
                                          void* out, int B, int Vl, int V,
                                          int D, int mean, void* stream) {
  if (B < 0 || Vl < 0 || V <= 0 || D <= 0 || D % 4 != 0 || D > 128 * 4)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((B + WARPS - 1) / WARPS);
  const float4* t = static_cast<const float4*>(table);
  const int* i = static_cast<const int*>(ids);
  float4* o = static_cast<float4*>(out);
  const int nch = D / 4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 128)
    lookup_kernel<1><<<blocks, NT, 0, st>>>(t, i, o, B, Vl, nch, V - 1, mean);
  else if (D <= 256)
    lookup_kernel<2><<<blocks, NT, 0, st>>>(t, i, o, B, Vl, nch, V - 1, mean);
  else
    lookup_kernel<4><<<blocks, NT, 0, st>>>(t, i, o, B, Vl, nch, V - 1, mean);
  return (int)cudaGetLastError();
}
